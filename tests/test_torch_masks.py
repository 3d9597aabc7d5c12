"""The port's offline mask tools (`gsdx_torch/apps/masks.py`) against
gsdx's on tests/test_masks_app.py's synthetic episode: the same masks,
foregrounds, initial point cloud and metadata."""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("PIL")

from gsdx.apps import masks as jmasks  # noqa: E402
from gsdx_torch.apps import masks as tmasks  # noqa: E402
from gsdx_torch.io.video import read_png  # noqa: E402
from test_masks_app import N_CAMS, _make_episode  # noqa: E402


def _files(root, sub, prefix):
    return sorted(os.path.join(root, f"camera_{c}", sub, f) for c in range(N_CAMS)
                  for f in os.listdir(os.path.join(root, f"camera_{c}", sub))
                  if f.startswith(prefix))


def test_masks_pipeline_equals_gsdx(tmp_path):
    from PIL import Image

    root_j, root_t = str(tmp_path / "gsdx"), str(tmp_path / "port")
    calib = _make_episode(root_j)
    shutil.copytree(root_j, root_t)
    calib_t = os.path.join(root_t, "calib.pkl")

    jmasks.obtain_mask(root_j, "object", n_cameras=N_CAMS)
    tmasks.obtain_mask(root_t, "object", n_cameras=N_CAMS, device="cpu")
    jmasks.merge_mask(root_j, n_cameras=N_CAMS)
    tmasks.merge_mask(root_t, n_cameras=N_CAMS)
    for sub, prefix in (("seg", "seg_"), ("foreground", "fg_")):
        fj, ft = _files(root_j, sub, prefix), _files(root_t, sub, prefix)
        assert [os.path.relpath(f, root_j) for f in fj] == \
            [os.path.relpath(f, root_t) for f in ft] and len(fj) == 2 * N_CAMS
        for a, b in zip(fj, ft):  # gsdx's PIL files and the port's PNGs
            np.testing.assert_array_equal(read_png(b), np.asarray(Image.open(a)))

    kw = dict(n_cameras=N_CAMS, voxel_size=0.01, max_points=4096)
    data_j = jmasks.build_init_pcd(root_j, calib, **kw)
    data_t = tmasks.build_init_pcd(root_t, calib_t, device="cpu", **kw)
    assert data_t.shape == data_j.shape and len(data_t) > 0
    # the same voxel order on both sides: the voxel means (f32 sums in
    # another order) to 1e-6 m, colours and labels equal
    np.testing.assert_allclose(data_t[:, :3], data_j[:, :3], atol=1e-6)
    np.testing.assert_array_equal(data_t[:, 3:], data_j[:, 3:])
    np.testing.assert_array_equal(np.load(os.path.join(root_t, "init_pt_cld.npz"))["data"],
                                  data_t)

    meta_j = jmasks.build_metadata(root_j, calib, n_cameras=N_CAMS, width=64, height=48)
    meta_t = tmasks.build_metadata(root_t, calib_t, n_cameras=N_CAMS, width=64, height=48)
    assert meta_t == meta_j
    assert json.load(open(os.path.join(root_t, "train_meta.json"))) == json.load(
        open(os.path.join(root_j, "train_meta.json")))


def test_masks_cli_reads_16_bit_depth_written_by_the_port(tmp_path):
    """The CLI on an episode written wholly by the port's PNG writer (colour
    8-bit, depth 16-bit), as `chip_smoke.py` phase `masks` writes it."""
    import pickle

    from gsdx_torch.io.video import write_image

    root = str(tmp_path)
    k = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    for c in range(2):
        img = np.full((48, 64, 3), 178, np.uint8)
        img[18:30, 24:36] = (200, 30, 30)
        write_image(os.path.join(root, f"camera_{c}", "color_000000.png"), img)
        write_image(os.path.join(root, f"camera_{c}", "depth", "depth_000000.png"),
                    np.full((48, 64), 800 + 10 * c, np.uint16))
    with open(os.path.join(root, "calib.pkl"), "wb") as f:
        pickle.dump({"intrinsics": np.stack([k, k]), "R_cam2world": np.stack([np.eye(3)] * 2),
                     "t_cam2world": np.zeros((2, 3))}, f)
    for cmd in ("obtain", "merge", "initpcd", "metadata"):
        argv = [cmd, "--data_path", root, "--n_cameras", "2"]
        if cmd in ("obtain", "initpcd"):
            argv += ["--device", "cpu"]
        if cmd in ("initpcd", "metadata"):
            argv += ["--calib", os.path.join(root, "calib.pkl")]
        tmasks.main(argv)
    data = np.load(os.path.join(root, "init_pt_cld.npz"))["data"]
    assert {round(float(z), 3) for z in np.unique(data[:, 2])} <= {0.8, 0.81}
    assert data[:, 6].max() == 1.0 and data[:, 6].min() == 0.0
    assert json.load(open(os.path.join(root, "train_meta.json")))["w"] == 1280
    with pytest.raises(ValueError, match="PNG frames only"):
        tmasks._read(os.path.join(root, "color_000000.jpg"))
