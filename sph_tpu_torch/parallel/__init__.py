"""The multi-GPU engines on ``torch.distributed`` (counterpart of
``sph_tpu/parallel``): the rank chain (``Comm``, ``make_mesh``), the
all-gather sharded step (the correctness oracle) and the z-slab halo
engine with its two resorts; ``run_ranks`` starts local ranks."""
from .mesh import dcn_edges, make_mesh, make_mesh2, pad_scene_to_devices
from .sharded import make_sharded_step, shard_state
from .halo import (
    make_halo_fast_multi_step,
    make_halo_session,
    measure_halo_pad,
    measure_migration_pad,
)

__all__ = [
    "dcn_edges",
    "make_mesh",
    "make_mesh2",
    "pad_scene_to_devices",
    "make_sharded_step",
    "make_halo_fast_multi_step",
    "make_halo_session",
    "measure_halo_pad",
    "measure_migration_pad",
    "shard_state",
]
