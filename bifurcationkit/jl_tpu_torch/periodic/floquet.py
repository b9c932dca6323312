"""Floquet stability solvers — the port of `jl_tpu/periodic/floquet.py`
(ref src/periodicorbit/Floquet.jl).

A discretization exposes `monodromy(prob_vf, X, po_par)` (dense) and
`monodromy_operator(...)` (matrix-free); the solvers below receive one of
them through the engine's `eig_jacobian` hook and return Floquet
exponents log(mu) sorted by decreasing real part (ties: decreasing
imaginary part) — what the detection layer consumes, with
`is_floquet=True` switching the classification to pd/ns (ref
src/Bifurcations.jl:103-137).  `FloquetColl` reduces the COP blocks to a
renormalized monodromy product on the device and eigensolves it on the
host; `FloquetGEV` eigensolves the periodic pencil of the interval maps
by host QZ.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..linalg.eig import COMPLEX_DTYPE, ArnoldiEig, _accepts_v0, dense_eig
from ..linalg.geig import dense_gev


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


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def monodromy_from_maps(maps, method: str = "assoc"):
    """Product M = M_{Ntst-1} @ ... @ M_0 of per-interval fundamental maps
    (ref Floquet.jl:653-660, a sequential chain).  method="seq": the
    chain, Ntst dependent matmuls.  method="assoc": a pairwise tree of
    batched products, log2(Ntst) rounds of one `bmm` each (the JAX
    package's associative scan)."""
    if method == "seq":
        M = torch.eye(maps.shape[-1], dtype=maps.dtype, device=maps.device)
        for Mi in maps:
            M = Mi @ M
        return M
    P = maps
    while P.shape[0] > 1:
        k = P.shape[0] // 2
        # (later @ earlier) for each pair; an odd last map stays the latest
        P = torch.cat([torch.bmm(P[1:2 * k:2], P[0:2 * k:2]), P[2 * k:]])
    return P[0]


def _log_multipliers(w: np.ndarray, logs: float = 0.0):
    """Floquet exponents log(mu) + logs of host multipliers (an infinite
    or NaN multiplier gives -inf) and the order sorting them by
    (-Re, -Im)."""
    w = np.asarray(w).astype(np.complex128)
    expo = np.full(w.shape, -np.inf + 0j)
    finite = np.isfinite(w)
    with np.errstate(divide="ignore"):
        expo[finite] = np.log(w[finite]) + logs
    return expo, np.lexsort((-expo.imag, -expo.real))


@dataclasses.dataclass(frozen=True)
class FloquetColl:
    """COP-reusing Floquet solver for collocation (ref FloquetColl,
    Floquet.jl:533-760): stage 1 of the collocation jacobian yields the
    per-interval fundamental maps S_j (the B_i^-1 A_i couples of
    :625-659); the multipliers are the spectrum of their product,
    accumulated with per-step max-norm renormalization carried in log
    space, so strongly unstable or stable orbits neither overflow nor
    denormalize (the stabilized form of the :653-660 chain).

    Expects `eig_jacobian` to hand over the `COPBlocks`
    (`periodic_orbit_problem(..., use_cop=True, floquet="coll")`).  The
    engine splits the solve: `device_reduce` on the device, `host_eig`
    (a numpy f64 eig of the (n, n) product) on the host.
    `low_dtype=torch.float32` runs stage 1 and the product in f32:
    multipliers carry about 1e-4 relative error, enough for count-based
    detection at tol_stability >= 1e-3."""

    is_floquet: bool = True
    low_dtype: object = None

    def device_reduce(self, blocks):
        """Stage 1 and the renormalized monodromy product, on the device
        in real arithmetic.  Returns (P, logs): the max-norm scaled product
        and the accumulated log of the scalings (a 0-d tensor)."""
        from .cop import _cast_blocks, cop_interval_maps

        if self.low_dtype is not None:
            blocks = _cast_blocks(blocks, self.low_dtype)
        S = cop_interval_maps(blocks)              # (Ntst, n, n)
        tiny = torch.finfo(S.dtype).tiny
        P = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
        logs = torch.zeros((), dtype=S.dtype, device=S.device)
        for Sj in S:
            P = Sj @ P
            s = torch.clamp_min(P.abs().max(), tiny)
            P = P / s
            logs = logs + torch.log(s)
        return P, logs

    def host_eig(self, P, logs, nev: int, with_vectors: bool = True):
        """Floquet exponents from the device-reduced (P, logs): a numpy
        f64 eig on the host (it cannot recover precision an f32 reduction
        lost).  Returns numpy (exponents, vectors or None, converged, 1)."""
        P = _host(P).astype(np.float64)
        nev = min(nev, P.shape[0])
        try:
            w, v = np.linalg.eig(P)
        except np.linalg.LinAlgError:
            # reported as converged_eig=False like every other eig path
            return np.full((nev,), np.nan + 0j), None, False, 1
        expo, order = _log_multipliers(w, float(logs))
        return (expo[order][:nev],
                v[:, order][:, :nev].astype(np.complex128)
                if with_vectors else None, True, 1)

    def __call__(self, blocks, nev: int):
        P, logs = self.device_reduce(blocks)
        expo, vecs, cv, it = self.host_eig(P, logs, nev)
        return (torch.as_tensor(expo, device=P.device),
                None if vecs is None else torch.as_tensor(vecs,
                                                          device=P.device),
                cv, it)


@dataclasses.dataclass(frozen=True)
class FloquetGEV:
    """Floquet multipliers from the block-bidiagonal periodic pencil
    A X = mu B X over the per-interval maps (ref FloquetGEV,
    Floquet.jl:424-531): no explicit monodromy product, so the accuracy
    does not degrade with Ntst (ref the precision caveat,
    Floquet.jl:28-31).  Expects `eig_jacobian` to return the (Ntst, n, n)
    interval maps (`periodic_orbit_problem(..., floquet="gev")`).  The
    pencil is built by one block scatter and solved by host QZ
    (`dense_gev`); its N - n infinite multipliers are dropped."""

    is_floquet: bool = True

    def __call__(self, maps, nev: int):
        Ntst, n, _ = maps.shape
        N = Ntst * n
        A = torch.zeros((N, N), dtype=maps.dtype, device=maps.device)
        B = torch.zeros_like(A)
        eye = torch.eye(n, dtype=maps.dtype, device=maps.device)
        A4 = A.view(Ntst, n, Ntst, n)
        j = torch.arange(Ntst, device=maps.device)
        A4[j, :, j, :] = maps
        A4[j[:-1], :, j[1:], :] = -eye
        B.view(Ntst, n, Ntst, n)[Ntst - 1, :, 0, :] = eye
        mult, vecs = dense_gev(A, B)
        expo, order = _log_multipliers(_host(mult))
        nev = min(nev, n)
        order = torch.as_tensor(order[:nev], device=maps.device)
        return (torch.as_tensor(expo, device=maps.device)[order],
                vecs[:, order], True, 1)
