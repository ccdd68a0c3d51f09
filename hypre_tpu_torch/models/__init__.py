from .ij import (IJMatrix, IJMatrixDevice, IJMatrixSharded, IJVector,
                 ij_assemble_device)
from .laplacian import (difconv_7pt, laplacian_5pt_2d, laplacian_7pt,
                        laplacian_7pt_row_block, laplacian_9pt,
                        laplacian_27pt, rotate_7pt,
                        sys_laplacian_7pt, vardifconv_7pt)
from .maxwell import (curlcurl_matrix, divdiv_matrix, edge_structure,
                      face_structure)

__all__ = ["IJMatrix", "IJMatrixDevice", "IJMatrixSharded", "IJVector",
           "curlcurl_matrix",
           "difconv_7pt", "divdiv_matrix", "edge_structure", "face_structure",
           "ij_assemble_device", "laplacian_5pt_2d", "laplacian_7pt",
           "laplacian_7pt_row_block", "laplacian_9pt", "laplacian_27pt",
           "rotate_7pt",
           "sys_laplacian_7pt", "vardifconv_7pt"]
