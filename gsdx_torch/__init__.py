"""gsdx_torch: the PyTorch/CUDA port of gsdx for NVIDIA Hopper GPUs.

The layout mirrors `gsdx/` (core, render, kernels, track, dynamics, graph,
rollout, plan, realworld, dist, io, utils, apps; CUDA sources in csrc). The
JAX package is the reference each module is tested against on the CPU; this
package imports neither JAX nor anything of `gsdx`. Entry points run on the
GPU (`device="cuda"`) unless the caller passes `device="cpu"`.
"""
