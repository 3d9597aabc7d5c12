"""GroundingDINO + SAM segmentation provider (the port's own copy of
`gsdx/realworld/segmentation.py`; reference N8).

Re-creates the open-vocabulary detect-then-segment flow of the reference
(`src/real_world/utils/perception_module.py:53-136`,
`src/tracking/utils/obtain_mask.py:13-180`): text-prompted GroundingDINO
boxes -> box-prompted SAM masks -> IoU dedup -> table/object mask algebra.

The models are external torch checkpoints, not on either machine the port
runs on; they load lazily on first use from config-driven paths, and
`make_segmenter` falls back to the threshold segmenter without them. All mask
logic (dedup, table subtraction, caption/box handling) is pure numpy,
separated out so it is unit-testable with mocked detector/segmenter
outputs, and so a different backend (e.g. an ONNX export) can reuse it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gsdx_torch.realworld.perception import SegmentationProvider, ThresholdSegmenter

log = logging.getLogger(__name__)

# Default checkpoint locations, overridable via environment or config
# (the reference hardcodes ../weights/* paths, `perception_module.py:33-38`).
DEFAULT_WEIGHTS_DIR = os.environ.get("GSDX_WEIGHTS_DIR", "weights")


@dataclasses.dataclass
class SegmenterConfig:
    """Checkpoint/config paths for the grounded-SAM provider."""

    dino_config: str = os.path.join(
        DEFAULT_WEIGHTS_DIR, "GroundingDINO_SwinB_cfg.py")
    dino_checkpoint: str = os.path.join(
        DEFAULT_WEIGHTS_DIR, "groundingdino_swinb_cogcoor.pth")
    sam_checkpoint: str = os.path.join(
        DEFAULT_WEIGHTS_DIR, "sam_vit_h_4b8939.pth")
    sam_type: str = "default"
    device: str = "cuda"
    box_threshold: float = 0.3
    iou_dedup_threshold: float = 0.9

    def checkpoints_present(self) -> bool:
        return (os.path.exists(self.dino_checkpoint)
                and os.path.exists(self.sam_checkpoint))


# ---------------------------------------------------------------- pure logic


def normalize_captions(prompts: Sequence[str]) -> List[str]:
    """lower/strip and ensure a trailing period (`perception_module.py:55-60`)."""
    out = []
    for p in prompts:
        p = p.lower().strip()
        if not p.endswith("."):
            p = p + "."
        out.append(p)
    return out


def boxes_cxcywh_to_xyxy(boxes: np.ndarray, width: int, height: int) -> np.ndarray:
    """Normalized center-format DINO boxes -> pixel xyxy
    (`perception_module.py:176-178`)."""
    b = np.asarray(boxes, np.float32) * np.array(
        [[width, height, width, height]], np.float32)
    xy = b[:, :2] - b[:, 2:] / 2
    return np.concatenate([xy, xy + b[:, 2:]], axis=1)


def dedup_masks_by_iou(
    masks: np.ndarray, scores: np.ndarray, threshold: float = 0.9
) -> np.ndarray:
    """Indices to keep after removing near-duplicate masks.

    For every pair with IoU > threshold the lower-scoring mask is dropped
    (`perception_module.py:115-129`). Returns sorted kept indices.
    """
    m = np.asarray(masks, bool)
    s = np.asarray(scores, np.float64)
    n = m.shape[0]
    remove = set()
    for i in range(n):
        for j in range(i + 1, n):
            union = np.logical_or(m[i], m[j]).sum()
            if union == 0:
                continue
            iou = np.logical_and(m[i], m[j]).sum() / union
            if iou > threshold:
                remove.add(j if s[i] > s[j] else i)
    return np.array([i for i in range(n) if i not in remove], np.int64)


def combine_table_object_masks(
    masks: np.ndarray, labels: Sequence[str], obj_names: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Table/object mask algebra (`perception_module.py:183-192`).

    Returns (mask_table, mask_objs, mask_obj_and_background): the union of
    'table' masks with all object masks subtracted; the union of object
    masks; and the complement of the cleaned table mask (what the fused
    point cloud keeps).
    """
    m = np.asarray(masks, bool)
    if m.ndim != 3 or m.shape[0] == 0:
        raise ValueError("masks must be a non-empty (M, H, W) stack")
    obj_set = set(obj_names)
    mask_table = np.zeros(m.shape[1:], bool)
    mask_objs = np.zeros(m.shape[1:], bool)
    for i, lab in enumerate(labels):
        if lab == "table":
            mask_table |= m[i]
    for i, lab in enumerate(labels):
        if lab in obj_set:
            mask_table &= ~m[i]
            mask_objs |= m[i]
    return mask_table, mask_objs, ~mask_table


def aggregate_instance_mask(masks: np.ndarray) -> np.ndarray:
    """(M, H, W) bool -> (H, W) uint8 instance ids, later masks overwrite
    earlier ones (`perception_module.py:130-133`)."""
    m = np.asarray(masks, bool)
    out = np.zeros(m.shape[1:], np.uint8)
    for i in range(m.shape[0]):
        out[m[i]] = i + 1
    return out


# ---------------------------------------------------------------- provider


class GroundedSAMSegmenter(SegmentationProvider):
    """Text-prompted instance segmentation via GroundingDINO + SAM.

    Heavy models load lazily on first use. The model calls are isolated in `_run_dino` / `_run_sam` so tests can
    substitute recorded outputs.
    """

    def __init__(self, config: Optional[SegmenterConfig] = None):
        self.config = config or SegmenterConfig()
        self._dino = None
        self._sam = None

    # -- model plumbing ----------------------------------------------------
    def _ensure_models(self):
        if self._dino is not None:
            return
        from groundingdino.models import build_model
        from groundingdino.util.slconfig import SLConfig
        from groundingdino.util.utils import clean_state_dict
        from segment_anything import SamPredictor, sam_model_registry

        cfg = self.config
        model = build_model(SLConfig.fromfile(cfg.dino_config))
        ckpt = torch.load(cfg.dino_checkpoint, map_location="cpu")
        model.load_state_dict(clean_state_dict(ckpt["model"]), strict=False)
        self._dino = model.eval().to(cfg.device)
        sam = sam_model_registry[cfg.sam_type](checkpoint=cfg.sam_checkpoint)
        sam.to(cfg.device)
        self._sam = SamPredictor(sam)

    def _run_dino(self, image: np.ndarray, captions: List[str]):
        """-> (boxes_norm_cxcywh (Q, 4), scores (Q,), label_idx (Q,)) numpy,
        already filtered by box_threshold."""
        self._ensure_models()
        import groundingdino.datasets.transforms as T
        from PIL import Image

        transform = T.Compose([
            T.RandomResize([800], max_size=1333),
            T.ToTensor(),
            T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
        ])
        tensor, _ = transform(Image.fromarray(image), None)
        tensor = tensor[None].repeat(len(captions), 1, 1, 1).to(
            self.config.device)
        with torch.no_grad():
            out = self._dino(tensor, captions=captions)
        logits = out["pred_logits"].sigmoid()  # (C, nq, 256)
        boxes = out["pred_boxes"]  # (C, nq, 4)
        scores = logits.max(dim=2).values  # (C, nq)
        keep = scores > self.config.box_threshold
        label_idx = torch.arange(len(captions), device=keep.device)[
            :, None].expand_as(keep)
        return (boxes[keep].cpu().numpy(),
                scores[keep].cpu().numpy(),
                label_idx[keep].cpu().numpy())

    def _run_sam(self, image: np.ndarray, boxes_xyxy: np.ndarray) -> np.ndarray:
        """-> (M, H, W) bool masks, one per box."""
        self._ensure_models()
        self._sam.set_image(image)
        tb = torch.as_tensor(boxes_xyxy, dtype=torch.float32,
                             device=self.config.device)
        tb = self._sam.transform.apply_boxes_torch(tb, image.shape[:2])
        masks, _, _ = self._sam.predict_torch(
            point_coords=None, point_labels=None, boxes=tb,
            multimask_output=False,
        )
        return masks[:, 0].cpu().numpy().astype(bool)

    # -- public API ----------------------------------------------------------
    def segment_instances(
        self, image: np.ndarray, prompts: Sequence[str]
    ) -> Tuple[np.ndarray, List[str], np.ndarray]:
        """(masks (M, H, W) bool, text labels, scores), IoU-deduplicated."""
        captions = normalize_captions(prompts)
        boxes, scores, label_idx = self._run_dino(image, captions)
        if len(boxes) == 0:
            h, w = image.shape[:2]
            return np.zeros((0, h, w), bool), [], np.zeros((0,), np.float32)
        xyxy = boxes_cxcywh_to_xyxy(boxes, image.shape[1], image.shape[0])
        masks = self._run_sam(image, xyxy)
        keep = dedup_masks_by_iou(masks, scores,
                                  self.config.iou_dedup_threshold)
        labels = [captions[label_idx[i]].rstrip(".") for i in keep]
        return masks[keep], labels, np.asarray(scores)[keep]

    def segment(self, image: np.ndarray, prompt: str) -> np.ndarray:
        """SegmentationProvider contract: union of instance masks for one
        prompt (the per-frame object mask of `obtain_mask.py`)."""
        masks, _, _ = self.segment_instances(image, [prompt])
        if masks.shape[0] == 0:
            return np.zeros(image.shape[:2], bool)
        return masks.any(axis=0)

    def table_object_masks(
        self, image: np.ndarray, obj_names: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(mask_table, mask_objs, mask_obj_and_background) — the fused-cloud
        filter of `get_tabletop_points` (`perception_module.py:174-199`)."""
        prompts = ["table"] + list(obj_names)
        masks, labels, _ = self.segment_instances(image, prompts)
        if masks.shape[0] == 0:
            h, w = image.shape[:2]
            return (np.zeros((h, w), bool), np.zeros((h, w), bool),
                    np.ones((h, w), bool))
        return combine_table_object_masks(masks, labels, obj_names)


def make_segmenter(
    config: Optional[SegmenterConfig] = None, require: bool = False
) -> SegmentationProvider:
    """GroundedSAM when importable and checkpoints exist, else the threshold
    fallback (replaces the hardwired fallback in earlier gsdx versions)."""
    cfg = config or SegmenterConfig()
    try:
        import groundingdino  # noqa: F401
        import segment_anything  # noqa: F401
    except ImportError as e:
        if require:
            raise
        log.info("grounded-SAM unavailable (%s); using ThresholdSegmenter", e)
        return ThresholdSegmenter()
    if not cfg.checkpoints_present():
        if require:
            raise FileNotFoundError(
                f"segmenter checkpoints missing: {cfg.dino_checkpoint}, "
                f"{cfg.sam_checkpoint}")
        log.info("grounded-SAM checkpoints missing; using ThresholdSegmenter")
        return ThresholdSegmenter()
    return GroundedSAMSegmenter(cfg)
