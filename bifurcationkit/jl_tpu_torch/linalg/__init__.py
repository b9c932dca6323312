from .eig import (ArnoldiEig, DenseEig, FlatOperator, LOBPCGEig,
                  ShiftInvertEig)
from .linear import DenseLS, GMRES, IterativeRefinement, PairedOperator
