"""Generalized eigenvalue solvers A x = lambda B x — the port of
`jl_tpu/linalg/geig.py` (ref src/GeneralizedEigenSolver.jl): DAE /
mass-matrix stability and the Floquet-GEV route.

The dense path is host LAPACK QZ (`scipy.linalg.eig(A, B)`), as the JAX
package's CPU route; its on-device shifted-pencil rotation works around
the TPU's lack of host callbacks and is not ported.  The iterative path
reduces to a standard eigenproblem on B^-1 A with the Krylov machinery
(ref `gev`, :19-70), matrix-free operators included.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.state import check_partition
from .eig import ArnoldiEig, FlatOperator
from .linear import DenseLS, dense_factor, dense_factor_solve, is_operator


def dense_gev(A: torch.Tensor, B: torch.Tensor, with_vectors: bool = True):
    """Generalized eig by host QZ, sorted by decreasing real part;
    infinite eigenvalues are marked -inf and sort last."""
    import scipy.linalg as sla

    a = A.detach().cpu().numpy()
    b = B.detach().cpu().numpy()
    try:
        w, v = sla.eig(a, b)
    except (np.linalg.LinAlgError, ValueError):
        # fall back to B^-1 A
        w, v = np.linalg.eig(np.linalg.solve(b, a))
    w = np.where(np.isfinite(w), w, -np.inf - 0j)
    order = np.lexsort((-w.imag, -w.real))
    w = torch.as_tensor(w[order].astype(np.complex128), device=A.device)
    if not with_vectors:
        return w, None
    return w, torch.as_tensor(v[:, order].astype(np.complex128),
                              device=A.device)


@dataclasses.dataclass(frozen=True)
class DenseGEig:
    """ref `DefaultGEig` (src/GeneralizedEigenSolver.jl:72-117)."""

    def __call__(self, A, B, nev: int):
        check_partition(False, "DenseGEig")
        w, v = dense_gev(A, B)
        return w[:nev], v[:, :nev], True, 1


@dataclasses.dataclass(frozen=True)
class IterativeGEig:
    """Krylov generalized eig via the B^-1 A operator
    (ref GEigKrylovKit/GEigArnoldiMethod, :119-199)."""

    eigsolver: Any = dataclasses.field(
        default_factory=lambda: ArnoldiEig(which="LR"))
    linsolver: Any = dataclasses.field(default_factory=DenseLS)

    def __call__(self, A, B, nev: int):
        if is_operator(A) or is_operator(B):
            # matrix-free reduction v -> B^-1 (A v): A applied directly, B
            # inverted through the (iterative) linear solver
            probe = (getattr(A, "example_vector", None) if is_operator(A)
                     else getattr(B, "example_vector", None))
            if probe is None and not is_operator(A):
                probe = torch.zeros((A.shape[0],), dtype=A.dtype,
                                    device=A.device)
            if probe is None and not is_operator(B):
                probe = torch.zeros((B.shape[0],), dtype=B.dtype,
                                    device=B.device)
            if probe is None:
                raise ValueError(
                    "matrix-free GEV needs A or B to expose example_vector "
                    "(wrap with FlatOperator)")
            applyA = A if is_operator(A) else (lambda v: A @ v)

            def op(v):
                return self.linsolver(B, applyA(v))[0]

            return self.eigsolver(
                FlatOperator(op, probe.shape[0], probe.dtype, probe.device),
                nev)
        check_partition(False, "IterativeGEig on dense matrices")
        fac = dense_factor(B)
        op = FlatOperator(lambda v: dense_factor_solve(fac, A @ v),
                          A.shape[0], A.dtype, A.device)
        return self.eigsolver(op, nev)


def gev(solver, A, B, nev: int):
    """Generic entry (ref `gev`, src/GeneralizedEigenSolver.jl:19)."""
    return solver(A, B, nev)


@dataclasses.dataclass(frozen=True)
class EigenMassMatrix:
    """Adapter: the standard eigensolver interface for problems with a
    constant mass matrix B (ref `EigenMassMatrix`, :200-210) — usable as
    `NewtonPar.eigsolver` for DAE stability."""

    B: Any = None
    gevsolver: Any = dataclasses.field(default_factory=DenseGEig)

    def __call__(self, J, nev: int):
        return self.gevsolver(J, self.B, nev)

