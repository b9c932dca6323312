from .eig import (ArnoldiEig, DenseEig, FlatOperator, LOBPCGEig,
                  ShiftInvertEig, SubspaceEig, dense_eig)
from .geig import DenseGEig, EigenMassMatrix, IterativeGEig, dense_gev, gev
from .linear import (BiCGStab, DenseLS, GMRES, IterativeRefinement,
                     PairedOperator, apply_J, is_operator)
from .precond import BlockJacobiPrecond, PartialSchurPrecond
