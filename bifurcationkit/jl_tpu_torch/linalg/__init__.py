from .eig import (ArnoldiEig, DenseEig, FlatOperator, LOBPCGEig,
                  ShiftInvertEig, SubspaceEig)
from .geig import DenseGEig, EigenMassMatrix, IterativeGEig, dense_gev, gev
from .linear import (BiCGStab, DenseLS, GMRES, IterativeRefinement,
                     PairedOperator)
from .precond import BlockJacobiPrecond, PartialSchurPrecond
