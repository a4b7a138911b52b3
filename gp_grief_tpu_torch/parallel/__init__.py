"""Multi-device scale-out on ``torch.distributed``: meshes, data- and
model-parallel models, sharded solvers.

Counterpart of ``gp_grief_tpu.parallel``.  JAX runs one process over every
device and shards with ``shard_map``; here each rank is one process on one
device (started by ``torchrun``, :func:`init_distributed`, or
:func:`~gp_grief_tpu_torch.parallel.launch.spawn`), a mesh is a
``torch.distributed`` ``DeviceMesh`` whose named axes carry process groups,
and the models run SPMD: every rank constructs them from the same data,
keeps its own rows, and calls the same methods.  The collectives and their
gradient convention are in :mod:`~gp_grief_tpu_torch.ops.collectives`;
the solvers take ``group=`` where the JAX package's take ``axis_name``.
Not ported: ``P`` and ``NamedSharding`` (no torch meaning) and
``build_sharded_windowed_interp`` (the windowed plans).
"""

from gp_grief_tpu_torch.ops import collectives
from gp_grief_tpu_torch.ops.collectives import all_gather, axis_index, axis_size, psum, psum_scatter, replicate
from gp_grief_tpu_torch.parallel import launch
from gp_grief_tpu_torch.parallel.mesh import data_mesh, init_distributed, make_mesh
from gp_grief_tpu_torch.parallel.model import ShardedGPGriefModel
from gp_grief_tpu_torch.parallel.sharded import (
    kron_matvec_sharded,
    pad_to_multiple,
    sharded_basis_stats,
    sharded_grief_nlml,
    stacked_eigh_sharded,
)
from gp_grief_tpu_torch.parallel.ski import ShardedGPSKIRegression, build_sharded_interp

__all__ = [
    "ShardedGPGriefModel",
    "ShardedGPSKIRegression",
    "build_sharded_interp",
    "make_mesh",
    "data_mesh",
    "init_distributed",
    "pad_to_multiple",
    "sharded_basis_stats",
    "sharded_grief_nlml",
    "stacked_eigh_sharded",
    "kron_matvec_sharded",
]
