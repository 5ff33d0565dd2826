"""Data parallelism on ``torch.distributed``, one process per device
(counterpart of pcseg_tpu/parallel/; sp.py, tp.py and gp.py are not
ported yet: ROADMAP A9b-A9d)."""

from pcseg_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    initialize_distributed,
    make_mesh,
    psum_mean,
    shard_batch,
)

__all__ = ["Mesh", "MeshSpec", "initialize_distributed", "make_mesh",
           "psum_mean", "shard_batch"]
