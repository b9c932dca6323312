from .collocation import Collocation, legendre_matrices
from .cop import COPBLS, COPLS, COPBlocks, collocation_block_jacobian
from .floquet import (FloquetColl, FloquetEig, FloquetGEV, FloquetQaDMF,
                      floquet_multipliers, monodromy_from_maps)
from .flow import Flow
from .orbits import (continuation_from_hopf_point, continuation_hopf_po,
                     continuation_po, get_periodic_orbit, newton_po,
                     orbit_from_branch, periodic_orbit_problem)
from .shooting import PoincareShooting, Shooting
from .trapezoid import Trapeze, slice_spectral_precond
from .codim2 import (POMAJac, POMinAugLS, bp_po_branch_switch,
                     continuation_fold_po, continuation_ns, continuation_pd,
                     pd_branch_switch, po_codim2_test_values)
from .cop import cop_bc_sigma, cop_solve, cop_solve_block, cop_solve_bordered
from .normal_forms import (get_normal_form_po, make_prm_coef_kernels,
                           neimark_sacker_iooss, period_doubling_iooss,
                           poincare_return_map)
