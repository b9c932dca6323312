from .codim1 import (get_adjoint_basis, get_normal_form, get_normal_form1d,
                     hopf_normal_form, hopf_normal_form_point, hopf_predictor,
                     predictor)
from .codim1_nd import get_normal_form_nd, nd_branch_predictors
from .branch_switch import continuation_from_bp, multicontinuation
from .diagram import BifDiagNode, bifurcationdiagram, bifurcationdiagram_rec
from .bautin import bautin_normal_form
from .maps import neimark_sacker_nf, period_doubling_nf
