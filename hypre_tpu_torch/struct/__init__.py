from .grid import StructGrid
from .matrix import StructMatrix, struct_matvec
from .vector import struct_inner_prod
from .box import (
    Box,
    BoxArray,
    BoxManager,
    bounding_box,
    distribute_PB,
    subtract_boxes,
    union_size,
)
from .multibox import MultiBoxGrid, MultiBoxVector, multibox_matvec
