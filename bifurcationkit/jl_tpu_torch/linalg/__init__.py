from .eig import DenseEig, FlatOperator, LOBPCGEig
from .linear import DenseLS, GMRES, IterativeRefinement, PairedOperator
