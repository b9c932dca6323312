from .lens import Lens, as_lens, lens_get, lens_set
from .params import ContinuationPar, NewtonPar, setfield
from .problem import BifurcationProblem, ODEBifProblem, PDEBifProblem
from .state import (BorderedState, DotTheta, arc_length_eq, tree_add,
                    tree_axpby, tree_axpy, tree_dot, tree_norm, tree_norm_inf,
                    tree_randn_like, tree_scale, tree_size, tree_sub,
                    tree_vdot, tree_zeros_like, ravel)
