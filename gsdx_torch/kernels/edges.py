"""The radius graph of a batch of particle sets in one CUDA launch
(`gsdx_torch/csrc/edges.cu`), the kernel behind
`graph/edges.py` `construct_edge_indices_batch`.

  * `edge_indices` launches the kernel on CUDA states: it allocates the
    outputs, reads nothing back and never synchronises. It takes
    (B, N, 3) float32 states of 1 to `MAX_N` particles a graph and a top-k
    of at most `MAX_TOPK`, and raises ValueError for any other input. The
    CPU runs the plain version, `graph/edges.py`
    `construct_edge_indices_batch_plain`, whose integers the kernel
    computes exactly.
  * `LAUNCHES["edges"]` counts the kernel launches, in the counters of
    `kernels/gnn_forward.py` that the push step's kernels share.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from gsdx_torch.kernels._build import F32, I32, PTR, CudaLibrary, Launcher, ptr
from gsdx_torch.kernels.gnn_forward import LAUNCHES  # the push step's counters

MAX_N = 256  # particles a graph: a block holds a graph's rows in shared memory
MAX_TOPK = 32  # nearest object columns kept a row: rounds of a warp argmin

LIBRARY = CudaLibrary(
    "gsdx_edges", "edges.cu",
    {"gsdx_edges": [PTR, ctypes.c_longlong, PTR, PTR, PTR, I32, F32, PTR, PTR]
     + [I32] * 7 + [PTR]},
    error_string="gsdx_edges_error_string")
_EDGES = Launcher(LIBRARY, "gsdx_edges", "edges", LAUNCHES, "edges")


def check(states: torch.Tensor, n_obj: int, topk: int) -> None:
    """Raise ValueError unless the kernel builds this graph: (B, N, 3)
    float32 CUDA states, 1 <= N <= `MAX_N`, 0 <= topk <= `MAX_TOPK` and
    n_obj >= 0."""
    if not (states.is_cuda and states.dtype == torch.float32 and states.dim() == 3
            and states.shape[2] == 3 and 1 <= states.shape[1] <= MAX_N):
        raise ValueError(f"the edges kernel takes (B, N <= {MAX_N}, 3) float32 CUDA "
                         f"states, not {tuple(states.shape)} {states.dtype} on "
                         f"{states.device}")
    if not (0 <= topk <= MAX_TOPK and n_obj >= 0):
        raise ValueError(f"the edges kernel takes 0 <= topk <= {MAX_TOPK} and n_obj >= 0, "
                         f"not topk {topk} and n_obj {n_obj}")


def _threshold(adj_thresh, B: int, device):
    """(pointer tensor or None, stride, value) of the radius: a number is
    passed by value; a tensor of one value or one a graph is read on the
    device, as float32."""
    if isinstance(adj_thresh, numbers.Real):
        return None, 0, float(adj_thresh)
    t = torch.as_tensor(adj_thresh, dtype=torch.float32, device=device).reshape(-1)
    if t.numel() not in (1, B):
        raise ValueError(f"adj_thresh holds {t.numel()} values for {B} graphs")
    return t.contiguous(), int(t.numel() > 1), 0.0


def edge_indices(states, adj_thresh, mask, tool_mask, n_obj: int, topk: int, max_nR: int,
                 connect_all: bool, width: int):
    """The kernel: (recv, send) int32 (B, width), the pairs' receiver and
    sender in the first max_nR slots, -1 elsewhere. ``mask`` and
    ``tool_mask`` are (B, N) masks on the states' device; inputs the
    kernel does not take raise ValueError (`check`)."""
    check(states, n_obj, topk)
    B, N, _ = states.shape
    dev = states.device
    masks = []
    for name, m in (("mask", mask), ("tool_mask", tool_mask)):
        if m.device != dev or m.shape != (B, N):
            raise ValueError(f"{name} is {tuple(m.shape)} on {m.device}: the kernel takes "
                             f"({B}, {N}) on {dev}")
        if m.dtype != torch.bool:
            m = m.bool()
        masks.append(m if m.is_contiguous() else m.contiguous())
    if states.stride(2) != 1 or states.stride(1) != 3:
        states = states.contiguous()
    thresh, t_stride, t_value = _threshold(adj_thresh, B, dev)
    recv = torch.empty((B, width), dtype=torch.int32, device=dev)
    send = torch.empty((B, width), dtype=torch.int32, device=dev)
    if B:
        n_eff = min(n_obj, N)
        _EDGES(dev.index, states.data_ptr(), states.stride(0), masks[0].data_ptr(),
               masks[1].data_ptr(), ptr(thresh), t_stride,
               t_value, recv.data_ptr(), send.data_ptr(), B, N, n_eff, min(topk, n_eff),
               max_nR, width, int(bool(connect_all)))
    return recv, send
