"""Scale-out over `torch.distributed` (counterpart of `gsdx/dist/`):
process groups and a named mesh, data-parallel GNN training, tile-sharded
compositing and camera-sharded tracking. MPPI's sample sharding lives in
`plan/planner.py` (``Planner(..., mesh=...)``)."""

from gsdx_torch.dist.mesh import get_mesh, initialize_distributed
from gsdx_torch.dist.render_sharded import make_sharded_tracking_step, sharded_composite
from gsdx_torch.dist.train_dp import make_dp_train_step, shard_batch

__all__ = [
    "get_mesh",
    "initialize_distributed",
    "make_dp_train_step",
    "shard_batch",
    "sharded_composite",
    "make_sharded_tracking_step",
]
