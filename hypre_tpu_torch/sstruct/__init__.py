from .grid import SStructGrid, VarType
from .matrix import SStructMatrix, sstruct_matvec
from .vector import SStructVector, pack_vector, unpack_vector
