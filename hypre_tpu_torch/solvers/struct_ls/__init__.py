from .pfmg import PFMG, PFMGOptions
from .smg import SMG, SMGOptions
from .sparse_msg import SparseMSG, SparseMSGOptions
from .jacobi import StructJacobi, StructJacobiOptions
from .hybrid import StructHybrid, StructHybridOptions
from .relax import (point_jacobi, point_relax, pointset_mask,
                    red_black_gs)
