"""Codim-2 continuation — so far the extended-operator bordered solves of
`minaug_mf.py` that the matrix-free normal forms use."""
from .minaug_mf import (ext_precond, ext_precond2, solve_bordered_ext,
                        solve_bordered_ext_cplx)
