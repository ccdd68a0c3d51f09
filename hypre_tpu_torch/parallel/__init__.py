"""The sharded solver (port of hypre_tpu/parallel/): one controller
driving S shards, each on a device of a `Mesh` or a process-grid
`MeshND` (mesh.py), sharded vectors as tuples of per-shard blocks;
par_struct.py is the sharded struct stack (layouts, the ghost-plane
exchange, the sharded StructMatrix and transfers)."""

from .halo import HaloPlan
from .mesh import Mesh, MeshND, default_mesh, make_mesh, make_mesh_nd
from .par_csr import ParCSR
from .par_dia import ParDIA
from .par_struct import (ShardedStructMatrix, StructLayout, shard_solver,
                         shard_struct, vector_sharding)
from .par_vector import ParVector, par_dot, par_norm
from .partition import block_partition

__all__ = ["HaloPlan", "Mesh", "MeshND", "ParCSR", "ParDIA", "ParVector",
           "ShardedStructMatrix", "StructLayout", "block_partition",
           "default_mesh", "make_mesh", "make_mesh_nd", "par_dot",
           "par_norm", "shard_solver", "shard_struct", "vector_sharding"]
