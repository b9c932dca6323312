"""Hand-written kernels of the port with their plain versions (`sh_jv`,
`dia_spmv`), the shared build helper (`nvcc`) and the sparse containers."""
from .dia_spmv import dia_spmv
from .sparse import BSRMatrix, DIAMatrix, ELLMatrix, laplacian_1d_dia
