"""Segmentation provider selection (the port's own copy of
`gsdx/realworld/segmentation.py:252-273`).

`make_segmenter` returns the threshold segmenter wherever grounded-SAM
(GroundingDINO + SAM, external checkpoints) is not installed or its
checkpoints are missing, exactly as gsdx does. The grounded-SAM provider
itself is still to port: where it would be chosen, this raises.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

from gsdx_torch.realworld.perception import SegmentationProvider, ThresholdSegmenter

log = logging.getLogger(__name__)

DEFAULT_WEIGHTS_DIR = os.environ.get("GSDX_WEIGHTS_DIR", "weights")


@dataclasses.dataclass
class SegmenterConfig:
    """Checkpoint paths of the grounded-SAM provider."""

    dino_checkpoint: str = os.path.join(DEFAULT_WEIGHTS_DIR,
                                        "groundingdino_swinb_cogcoor.pth")
    sam_checkpoint: str = os.path.join(DEFAULT_WEIGHTS_DIR, "sam_vit_h_4b8939.pth")

    def checkpoints_present(self) -> bool:
        return (os.path.exists(self.dino_checkpoint)
                and os.path.exists(self.sam_checkpoint))


def make_segmenter(config: Optional[SegmenterConfig] = None,
                   require: bool = False) -> SegmentationProvider:
    """The threshold segmenter unless grounded-SAM is importable and its
    checkpoints exist (``require`` turns each fallback into an error)."""
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
            raise FileNotFoundError(f"segmenter checkpoints missing: "
                                    f"{cfg.dino_checkpoint}, {cfg.sam_checkpoint}")
        log.info("grounded-SAM checkpoints missing; using ThresholdSegmenter")
        return ThresholdSegmenter()
    raise NotImplementedError("the grounded-SAM segmenter is not ported yet")
