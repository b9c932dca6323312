"""Codim-2 continuation: minimally augmented fold and Hopf curves, dense
(`minaug.py`) and matrix-free (`minaug_mf.py`)."""
from .minaug import (continuation_fold, continuation_hopf, fold_ma_problem,
                     hopf_ma_problem, newton_fold, newton_hopf, refine_gh)
from .minaug_mf import (continuation_fold_mf, continuation_hopf_mf,
                        ext_precond, ext_precond2, fold_ma_problem_mf,
                        hopf_ma_problem_mf, solve_bordered_ext,
                        solve_bordered_ext_cplx)
