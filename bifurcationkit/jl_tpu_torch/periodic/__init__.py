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
