"""gsdx's graph batches as the port's `GraphBatch`: gsdx holds its relations
as one-hot rows alone, the port as index lists too."""

import dataclasses

import numpy as np
import torch

from gsdx_torch.graph.dataset import GraphBatch


def relation_indices(R) -> np.ndarray:
    """One-hot relation rows (B, n_rel, N) as int32 node indices (B, n_rel),
    -1 on empty rows."""
    R = np.asarray(R)
    return np.where(R.any(-1), R.argmax(-1), -1).astype(np.int32)


def port_fields(jb) -> dict:
    """Every field of the port's `GraphBatch` as numpy, from gsdx batch
    ``jb``: its own fields, and ``recv`` / ``send`` from its ``Rr`` / ``Rs``."""
    out = {f.name: np.array(getattr(jb, f.name)) for f in dataclasses.fields(GraphBatch)
           if f.name not in ("recv", "send")}
    out["recv"], out["send"] = relation_indices(out["Rr"]), relation_indices(out["Rs"])
    return out


def port_batch(jb) -> GraphBatch:
    """gsdx batch ``jb`` as the port's `GraphBatch` on the CPU."""
    return GraphBatch(**{k: torch.from_numpy(v) for k, v in port_fields(jb).items()})
