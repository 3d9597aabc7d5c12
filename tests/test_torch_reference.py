"""The dense reference renderer (`gsdx_torch/render/reference.py`) against
gsdx's, values and gradients; then the port's `rasterize` against the
port's reference, as `tests/test_rasterize.py` holds gsdx's rasterizer
against gsdx's reference (same scenes, same tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.core.cameras import make_camera as j_make_camera
from gsdx.render.reference import render_reference as j_reference
from gsdx_torch.core.cameras import make_camera as t_make_camera
from gsdx_torch.render.rasterize import RasterizeConfig, rasterize
from gsdx_torch.render.reference import render_reference

H, W = 40, 64
CFG = RasterizeConfig(tile_h=8, tile_w=128, max_per_tile=256, max_dup=32)


def make_scene(rng, n=120):
    """tests/test_rasterize.py's scene."""
    means = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.08, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n, 1)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    return means, quats, scales, opac, colors


def cams(bg=(0.0, 0.0, 0.0)):
    k = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    return (j_make_camera(k, w2c, width=W, height=H, bg=bg),
            t_make_camera(k, w2c, width=W, height=H, bg=bg))


def tt(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("strict", [True, False])
def test_reference_matches_gsdx_values_and_gradients(rng, strict):
    scene = make_scene(rng, n=80)
    scene[0][:2, 2] = [0.1, 0.19]  # two behind the near-cull plane
    jc, tc = cams(bg=(0.3, 0.1, 0.6))
    target = rng.uniform(0, 1, size=(3, H, W)).astype(np.float32)
    live = np.ones(80, np.float32)
    live[70:] = 0.0

    def j_loss(*a):
        im, _, depth, final_t = j_reference(*a[:5], jc, live=jnp.asarray(live),
                                            mean2d_offset=a[5], strict_t_stop=strict)
        return (jnp.mean((im - target) ** 2) + 0.1 * jnp.mean(depth ** 2)
                + 0.1 * jnp.mean(final_t)), (im, depth, final_t)

    jargs = [jnp.asarray(x) for x in scene] + [jnp.zeros((80, 2), jnp.float32)]
    (_, out_j), g_j = jax.jit(jax.value_and_grad(j_loss, argnums=tuple(range(6)),
                                                 has_aux=True))(*jargs)
    targs = tt(*scene, np.zeros((80, 2), np.float32), grad=True)
    im, radius, depth, final_t = render_reference(
        *targs[:5], tc, live=torch.as_tensor(live), mean2d_offset=targs[5],
        strict_t_stop=strict)
    loss = (torch.mean((im - torch.as_tensor(target)) ** 2)
            + 0.1 * torch.mean(depth ** 2) + 0.1 * torch.mean(final_t))
    g_t = torch.autograd.grad(loss, targs)

    # f32 chains of the projection and the cumulative sums: the values to
    # 2e-5 (depth ~3 to 1e-4), as tests/test_torch_render.py holds rasterize
    for got, want, tol in zip((im, depth, final_t), out_j, (2e-5, 1e-4, 2e-5)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol)
    _, rad_j, _, _ = j_reference(*jargs[:5], jc, live=jnp.asarray(live))
    np.testing.assert_array_equal(radius.detach().numpy(), np.asarray(rad_j))
    names = ["means3d", "quats", "scales", "opacities", "colors", "mean2d"]
    for name, a, b in zip(names, g_t, g_j):
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-12
        # the same ops in the same order on both sides: 1e-5 of the largest
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-5, err_msg=name)


# ------------------------------------------- the port's rasterize vs its oracle


def test_rasterize_forward_matches_reference(rng):
    means, quats, scales, opac, colors = make_scene(rng)
    _, cam = cams(bg=(0.3, 0.1, 0.6))
    args = tt(means, quats, scales, opac, colors)
    out = rasterize(*args, cam, CFG)
    im_ref, radius_ref, depth_ref, final_t_ref = render_reference(
        *args, cam, strict_t_stop=False)
    np.testing.assert_allclose(out.im.numpy(), im_ref.numpy(), atol=2e-5)
    np.testing.assert_allclose(out.depth.numpy(), depth_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.final_t.numpy(), final_t_ref.numpy(), atol=2e-5)
    np.testing.assert_allclose(out.radius.numpy(), radius_ref.numpy())


def test_rasterize_close_to_strict_reference(rng):
    """With the 1e-4 per-pixel stop, outputs agree to ~1e-3."""
    means, quats, scales, opac, colors = make_scene(rng, n=200)
    _, cam = cams()
    args = tt(means, quats, scales, opac, colors)
    out = rasterize(*args, cam, CFG)
    im_ref, _, _, _ = render_reference(*args, cam, strict_t_stop=True)
    np.testing.assert_allclose(out.im.numpy(), im_ref.numpy(), atol=2e-3)


def test_rasterize_gradients_match_reference(rng):
    means, quats, scales, opac, colors = make_scene(rng, n=60)
    _, cam = cams(bg=(0.2, 0.2, 0.2))
    target = torch.as_tensor(rng.uniform(0, 1, size=(3, H, W)).astype(np.float32))
    grads = []
    for fn in ("prod", "ref"):
        args = tt(means, quats, scales, opac, colors, np.zeros((60, 2), np.float32),
                  grad=True)
        if fn == "prod":
            out = rasterize(*args[:5], cam, CFG, mean2d_offset=args[5])
            im, depth = out.im, out.depth
        else:
            im, _, depth, _ = render_reference(*args[:5], cam, mean2d_offset=args[5],
                                               strict_t_stop=False)
        loss = (im - target).abs().mean() + 0.1 * depth.abs().mean()
        grads.append(torch.autograd.grad(loss, args))
    names = ["means3d", "quats", "scales", "opacities", "colors", "mean2d"]
    for name, gp, gr in zip(names, *grads):
        gp, gr = gp.numpy(), gr.numpy()
        scale = np.abs(gr).max() + 1e-8
        np.testing.assert_allclose(gp / scale, gr / scale, atol=5e-4,
                                   err_msg=f"grad mismatch: {name}")


def test_rasterize_live_mask_matches_reference(rng):
    means, quats, scales, opac, colors = make_scene(rng, n=50)
    _, cam = cams()
    live = torch.ones(50)
    live[25:] = 0.0
    args = tt(means, quats, scales, opac, colors)
    out = rasterize(*args, cam, CFG, live=live)
    im_ref, _, _, _ = render_reference(*args, cam, live=live, strict_t_stop=False)
    np.testing.assert_allclose(out.im.numpy(), im_ref.numpy(), atol=2e-5)
