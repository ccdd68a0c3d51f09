"""The sharded solver (port of hypre_tpu/parallel/): one controller
driving S shards, each on a device of a `Mesh` (mesh.py), sharded
vectors as tuples of per-shard blocks.  par_struct.py (struct by
annotation in the JAX package) is not ported yet."""

from .halo import HaloPlan
from .mesh import Mesh, default_mesh, make_mesh
from .par_csr import ParCSR
from .par_dia import ParDIA
from .par_vector import ParVector, par_dot, par_norm
from .partition import block_partition

__all__ = ["HaloPlan", "Mesh", "ParCSR", "ParDIA", "ParVector",
           "block_partition", "default_mesh", "make_mesh", "par_dot",
           "par_norm"]
