"""Data parallelism over torch.distributed (port of soft_intro_vae_tpu/parallel):
the world and the per-rank rows (mesh.py), starting the ranks
(multihost.py), the collectives (collectives.py), the distributed probes
(verify.py) and a local launcher of N ranks (launch.py)."""

from soft_intro_vae_torch.parallel.mesh import (
    DATA_AXIS,
    World,
    current_world,
    host_local_batch_size,
    make_data_mesh,
    shard_batch,
    shard_scan_batch,
    shard_state,
)

__all__ = [
    "DATA_AXIS",
    "World",
    "current_world",
    "host_local_batch_size",
    "make_data_mesh",
    "shard_batch",
    "shard_scan_batch",
    "shard_state",
]
