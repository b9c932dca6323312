"""Preconditioners — the port of `jl_tpu/linalg/precond.py` (ref
src/Preconditioner.jl).

`PartialSchurPrecond` — the spectral-projection preconditioner P^-1 that
inverts the restriction of J to a low-dimensional invariant subspace and
acts as the identity on its complement (ref `PrecPartialSchur`, :4-66):
built from a partial Schur pair, it deflates the few troublesome
(near-singular / unstable) eigenvalues so GMRES converges fast on the rest
of the spectrum.

`BlockJacobiPrecond` — the block-diagonal inverse for BSR-structured PDE
jacobians, every block factored by one batched LU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.state import check_partition
from .eig import ArnoldiEig, FlatOperator, dense_eig
from .linear import dense_factor, dense_factor_solve, dense_solve


def _real_span_basis(V: np.ndarray, nev: int) -> np.ndarray:
    """An orthonormal basis of the real span of (possibly complex) columns,
    trimmed to 2 nev columns."""
    Q, _ = np.linalg.qr(np.concatenate([V.real, V.imag], axis=1))
    return Q[:, :min(2 * nev, Q.shape[1])]


@dataclasses.dataclass(frozen=True)
class PartialSchurPrecond:
    """P^-1 = I + Q (T^-1 - I) Q^T where (Q, T) is a partial Schur pair of J
    on the subspace of the `nev` rightmost eigenvalues."""

    Q: Any              # (n, k) orthonormal basis of the invariant subspace
    T: Any              # (k, k) restriction of J

    @classmethod
    def from_matrix(cls, J: torch.Tensor, nev: int = 5):
        _, vecs = dense_eig(J)
        Q = _real_span_basis(vecs.cpu().numpy()[:, :nev], nev)
        T = Q.T @ J.detach().cpu().numpy() @ Q
        return cls(Q=torch.as_tensor(Q, dtype=J.dtype, device=J.device),
                   T=torch.as_tensor(T, dtype=J.dtype, device=J.device))

    @classmethod
    def from_operator(cls, op, n: int, nev: int = 5, krylov_dim: int = 40,
                      dtype=torch.float64, device=None):
        eig = ArnoldiEig(krylov_dim=krylov_dim, which="LR")
        _, vecs, _, _ = eig(FlatOperator(op, n, dtype, device), nev)
        Q = torch.as_tensor(_real_span_basis(vecs.cpu().numpy(), nev),
                            dtype=dtype, device=device)
        JQ = torch.stack([op(Q[:, i]) for i in range(Q.shape[1])], dim=1)
        return cls(Q=Q, T=Q.T @ JQ)

    def __call__(self, v):
        """Apply P^-1 v (ref ldiv!, src/Preconditioner.jl:20-40)."""
        check_partition(False, "PartialSchurPrecond")
        c = self.Q.T @ v
        return v + self.Q @ (dense_solve(self.T, c) - c)


@dataclasses.dataclass(frozen=True)
class BlockJacobiPrecond:
    """Inverse of the block diagonal: the (nb, bs, bs) blocks factored by
    one batched LU."""

    fac: Any
    nb: int
    bs: int

    @classmethod
    def from_blocks(cls, blocks: torch.Tensor):
        return cls(fac=dense_factor(blocks), nb=blocks.shape[0],
                   bs=blocks.shape[1])

    def __call__(self, v):
        out = dense_factor_solve(self.fac, v.reshape(self.nb, self.bs))
        return out.reshape(v.shape)
