"""The multi-device layer: ``mesh.py``, the twin of genfer_tpu's
``parallel/mesh.py`` on ``torch.distributed`` (one rank a device)."""

from .mesh import (
    Mesh,
    ShardedF64Backend,
    close_group,
    halo_conv_2d,
    halo_conv_nd,
    init_group,
    make_mesh,
    sharded_conv_1d,
    sharded_conv_2d,
    sharded_conv_nd,
    sharded_div_lanes,
    sharded_inference_step,
    spawn,
)

__all__ = [
    "Mesh",
    "ShardedF64Backend",
    "close_group",
    "halo_conv_2d",
    "halo_conv_nd",
    "init_group",
    "make_mesh",
    "sharded_conv_1d",
    "sharded_conv_2d",
    "sharded_conv_nd",
    "sharded_div_lanes",
    "sharded_inference_step",
    "spawn",
]
