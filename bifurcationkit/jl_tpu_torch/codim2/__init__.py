"""Codim-2 continuation: minimally augmented fold and Hopf curves, dense
(`minaug.py`) and matrix-free (`minaug_mf.py`), the codim-2 normal forms
(`normal_forms.py`, `zh_hh.py`), their detailed unfoldings and
predictors (`unfolding.py`), switching between codim-2 curves, and onto
the periodic-orbit codim-2 curves (`switch_codim2_po`)."""
from .minaug import (continuation_fold, continuation_hopf, fold_ma_problem,
                     hopf_ma_problem, newton_fold, newton_hopf, refine_gh,
                     switch_codim2)
from .minaug_mf import (continuation_fold_mf, continuation_hopf_mf,
                        ext_precond, ext_precond2, fold_ma_problem_mf,
                        hopf_ma_problem_mf, solve_bordered_ext,
                        solve_bordered_ext_cplx, switch_codim2_mf)
from .normal_forms import (bt_normal_form, bt_predictors, cusp_normal_form,
                           get_normal_form_codim2, newton_bt)
from .zh_hh import hh_normal_form, zh_normal_form
from .unfolding import (bautin_unfolding, bt_unfolding, hh_unfolding,
                        predictor_fold_po, predictor_homoclinic_bt,
                        predictor_ns_hh, predictor_ns_zh, switch_codim2_po,
                        zh_unfolding)
