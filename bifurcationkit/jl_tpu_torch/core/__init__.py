from .lens import Lens, as_lens, lens_get, lens_set
from .params import ContinuationPar, NewtonPar, setfield
from .problem import BifurcationProblem, ODEBifProblem, PDEBifProblem
from .state import BorderedState, DotTheta
