"""Floquet stability solvers — the port of `jl_tpu/periodic/floquet.py`
(ref src/periodicorbit/Floquet.jl).

A discretization exposes `monodromy(prob_vf, X, po_par)` (dense) and
`monodromy_operator(...)` (matrix-free); the solvers below receive one of
them through the engine's `eig_jacobian` hook and return Floquet
exponents log(mu) sorted by decreasing real part (ties: decreasing
imaginary part) — what the detection layer consumes, with
`is_floquet=True` switching the classification to pd/ns (ref
src/Bifurcations.jl:103-137).  `FloquetColl` and `FloquetGEV` come with
collocation (ROADMAP Queue A item 14, step 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..linalg.eig import COMPLEX_DTYPE, ArnoldiEig, _accepts_v0, dense_eig


def _sorted_exponents(mult: torch.Tensor):
    """log(mu) and the order that sorts it by (-Re, -Im)."""
    expo = torch.log(mult.to(COMPLEX_DTYPE))
    e = expo.cpu().numpy()
    order = np.lexsort((-e.imag, -e.real))
    return expo, torch.as_tensor(order, device=mult.device)


@dataclasses.dataclass(frozen=True)
class FloquetEig:
    """Multipliers of the dense monodromy matrix -> Floquet exponents
    (ref FloquetQaD :48; the trivial multiplier mu = 1 sits at exponent 0
    — use tol_stability ~ 1e-6 for PO runs, as the reference does, e.g.
    examples/brusselator.jl:140)."""

    is_floquet: bool = True

    def __call__(self, M, nev: int):
        mult, vecs = dense_eig(M)          # sorted by Re(mu) desc
        expo, order = _sorted_exponents(mult)
        nev = min(nev, M.shape[0])
        return expo[order][:nev], vecs[:, order][:, :nev], True, 1


def _default_mf_eig():
    return ArnoldiEig(which="LM", krylov_dim=30, restarts=3, tol=1e-9)


@dataclasses.dataclass(frozen=True)
class FloquetQaDMF:
    """Matrix-free FloquetQaD (ref Floquet.jl:89-109, MF shooting variant
    :164-254): the monodromy is applied as an operator (per-slice trapeze
    half-step solves, `Trapeze.monodromy_operator`) and the leading
    multipliers come from a Krylov or subspace :LM solve on it — the
    PDE-scale stability path: a dense monodromy costs n solves and O(n^2)
    memory, a sweep here a few block applications.  Expects
    `eig_jacobian` to hand over the operator
    (`periodic_orbit_problem(..., floquet="qad_mf")`)."""

    is_floquet: bool = True
    accepts_v0: bool = True
    eigsolver: object = dataclasses.field(default_factory=_default_mf_eig)

    def __call__(self, op, nev: int, v0=None):
        if _accepts_v0(self.eigsolver):
            mult, vecs, cv, it = self.eigsolver(op, nev, v0=v0)
        else:
            mult, vecs, cv, it = self.eigsolver(op, nev)
        expo, order = _sorted_exponents(mult)
        return expo[order], vecs[:, order], cv, it

    def seed_cols(self, nev: int):
        # warm-start contract: blocked inner solvers (SubspaceEig) take the
        # full previous block; Arnoldi takes one recombined direction
        inner = getattr(self.eigsolver, "seed_cols", None)
        return inner(nev) if callable(inner) else None

    def make_seed(self, vecs, ncols: int):
        inner = getattr(self.eigsolver, "make_seed", None)
        if callable(inner):
            return inner(vecs, ncols)
        return torch.real(vecs[:, :ncols])


def floquet_multipliers(disc, prob_vf, X, po_par) -> np.ndarray:
    """The Floquet multipliers of an orbit from the dense monodromy, sorted
    by decreasing real part (host numpy)."""
    mult, _ = dense_eig(disc.monodromy(prob_vf, X, po_par),
                        with_vectors=False)
    return mult.cpu().numpy()
