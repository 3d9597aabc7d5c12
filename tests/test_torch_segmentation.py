"""The port's grounded-SAM mask logic and provider against gsdx's, with the
detector and segmenter mocked (their checkpoints are on neither machine;
mirrors tests/test_segmentation.py)."""

import numpy as np
import pytest

from gsdx.realworld import segmentation as jseg
from gsdx_torch.realworld import segmentation as tseg
from gsdx_torch.realworld.perception import PerceptionModule, ThresholdSegmenter


def _blobs(rng, m, h=24, w=32):
    masks = np.zeros((m, h, w), bool)
    for i in range(m):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        masks[i, y0:y0 + rng.integers(2, h - y0), x0:x0 + rng.integers(2, w - x0)] = True
    masks[m // 2] = masks[0]  # an exact duplicate
    return masks


def test_mask_helpers_equal_gsdx(rng):
    caps = [" Rope", "table.", "RED cube ", "x"]
    assert tseg.normalize_captions(caps) == jseg.normalize_captions(caps)
    boxes = rng.uniform(0, 1, size=(7, 4)).astype(np.float32)
    np.testing.assert_array_equal(tseg.boxes_cxcywh_to_xyxy(boxes, 200, 100),
                                  jseg.boxes_cxcywh_to_xyxy(boxes, 200, 100))
    for _ in range(5):
        masks = _blobs(rng, 6)
        scores = rng.uniform(size=6)
        for thr in (0.3, 0.9):
            np.testing.assert_array_equal(tseg.dedup_masks_by_iou(masks, scores, thr),
                                          jseg.dedup_masks_by_iou(masks, scores, thr))
        np.testing.assert_array_equal(tseg.aggregate_instance_mask(masks),
                                      jseg.aggregate_instance_mask(masks))
        labels = list(rng.choice(["table", "rope", "cube"], size=6))
        for a, b in zip(tseg.combine_table_object_masks(masks, labels, ["rope", "cube"]),
                        jseg.combine_table_object_masks(masks, labels, ["rope", "cube"])):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tseg.combine_table_object_masks(np.zeros((0, 4, 4), bool), [], ["rope"])


def _mocked(base):
    """gsdx's MockedSegmenter (tests/test_segmentation.py) on ``base``: 'table'
    fills the frame, any other prompt a centred box plus a low-score
    near-duplicate."""

    class Mocked(base):
        def _ensure_models(self):
            pass

        def _run_dino(self, image, captions):
            boxes, scores, labels = [], [], []
            for i, cap in enumerate(captions):
                if cap == "table.":
                    boxes.append([0.5, 0.5, 1.0, 1.0])
                    scores.append(0.8)
                    labels.append(i)
                else:
                    boxes += [[0.5, 0.5, 0.5, 0.5], [0.5, 0.5, 0.52, 0.52]]
                    scores += [0.9, 0.4]
                    labels += [i, i]
            return (np.array(boxes, np.float32), np.array(scores, np.float32),
                    np.array(labels, np.int64))

        def _run_sam(self, image, boxes_xyxy):
            h, w = image.shape[:2]
            masks = []
            for x0, y0, x1, y1 in boxes_xyxy:
                m = np.zeros((h, w), bool)
                m[int(max(y0, 0)):int(min(y1, h)), int(max(x0, 0)):int(min(x1, w))] = True
                masks.append(m)
            return np.stack(masks)

    return Mocked


def test_mocked_provider_equals_gsdx():
    t = _mocked(tseg.GroundedSAMSegmenter)(tseg.SegmenterConfig())
    j = _mocked(jseg.GroundedSAMSegmenter)(jseg.SegmenterConfig())
    img = np.zeros((40, 80, 3), np.uint8)
    mt, lt, st = t.segment_instances(img, ["Rope", "table"])
    mj, lj, sj = j.segment_instances(img, ["Rope", "table"])
    np.testing.assert_array_equal(mt, mj)
    assert lt == lj and mt.shape[0] == 2  # the near-duplicate dropped
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(t.segment(img, "rope"), j.segment(img, "rope"))
    for a, b in zip(t.table_object_masks(img, ["rope"]), j.table_object_masks(img, ["rope"])):
        np.testing.assert_array_equal(a, b)
    mt_, mo, keep = t.table_object_masks(img, ["rope"])
    assert mo[20, 40] and not mt_[20, 40] and keep[20, 40] and not keep[0, 0]


def test_perception_table_flow_with_mocked_provider():
    seg = _mocked(tseg.GroundedSAMSegmenter)(tseg.SegmenterConfig())
    pm = PerceptionModule(segmenter=seg, voxel_size=0.02, max_points=4096, device="cpu")
    H, W = 40, 80
    colors = np.full((1, H, W, 3), 128, np.uint8)
    depth = np.full((1, H, W), 0.8, np.float32)
    k = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    pm.bbox = np.array([[-2, 2], [-2, 2], [-2, 2]], np.float32)
    pts, cols = pm.get_tabletop_points(colors, depth, [k], [np.eye(3)], [np.zeros(3)],
                                       obj_names=["rope"])
    assert len(pts) > 0 and np.isfinite(pts).all() and cols.shape == pts.shape


def test_make_segmenter_falls_back_without_models(tmp_path, monkeypatch):
    assert isinstance(tseg.make_segmenter(), ThresholdSegmenter)
    with pytest.raises(Exception):
        tseg.make_segmenter(require=True)
    # with the packages importable and the checkpoints present it is the
    # grounded-SAM provider (models load at first use, not here)
    import sys
    import types

    for name in ("groundingdino", "segment_anything"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    cfg = tseg.SegmenterConfig(dino_checkpoint=str(tmp_path / "d.pth"),
                               sam_checkpoint=str(tmp_path / "s.pth"))
    assert isinstance(tseg.make_segmenter(cfg), ThresholdSegmenter)
    (tmp_path / "d.pth").write_bytes(b"")
    (tmp_path / "s.pth").write_bytes(b"")
    assert isinstance(tseg.make_segmenter(cfg), tseg.GroundedSAMSegmenter)
