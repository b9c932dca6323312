from .floquet import FloquetEig, FloquetQaDMF, floquet_multipliers
from .orbits import (continuation_from_hopf_point, continuation_hopf_po,
                     continuation_po, get_periodic_orbit, newton_po,
                     orbit_from_branch, periodic_orbit_problem)
from .trapezoid import Trapeze, slice_spectral_precond
