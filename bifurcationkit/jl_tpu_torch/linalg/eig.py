"""Eigen solvers — the port of `jl_tpu/linalg/eig.py` (ref
src/EigSolver.jl:4-266).

An eigen solver is a callable

    eig(J, nev) -> (values, vectors, converged, n_iter)

returning the `nev` rightmost eigenvalues sorted by decreasing real part
and the matching eigenvectors as columns of `vectors` (the JAX package's
layout at the public interface).  Here: `DenseEig` (host LAPACK), the
preconditioned blocked `LOBPCGEig` for symmetric jacobians, and the
matrix-free non-symmetric pair `ArnoldiEig` / `ShiftInvertEig`.  Inside
LOBPCG a block is stored (k, n) row-major, so a block of states reshapes
to (k, *state_shape) without a transposing copy and the model's J.v
kernel takes the whole block in one launch.

Arnoldi keeps its Krylov basis on the device and solves the small
Hessenberg eigenproblem on the host with numpy, as the JAX package's CPU
route does; its on-device Francis QR and inverse iteration
(`qr_eigvals`, `inverse_iteration_vectors`) work around TPU limits and
are not ported.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.state import (check_partition, global_dot, global_norm,
                          global_size, local_randn, ravel, tree_axpy)
from .linear import (apply_J, dense_factor, dense_factor_solve,
                     is_operator)

COMPLEX_DTYPE = torch.complex128


def _host_eig_sorted(A: np.ndarray):
    """Host LAPACK eig, sorted by decreasing real part (ties: decreasing
    imaginary part, so complex pairs come out adjacently)."""
    w, v = np.linalg.eig(A)
    order = np.lexsort((-w.imag, -w.real))
    return w[order].astype(np.complex128), v[:, order].astype(np.complex128)


def dense_eig(A: torch.Tensor, with_vectors: bool = True):
    w, v = _host_eig_sorted(A.detach().cpu().numpy())
    w = torch.as_tensor(w, device=A.device)
    return (w, torch.as_tensor(v, device=A.device)) if with_vectors \
        else (w, None)


@dataclasses.dataclass(frozen=True)
class DenseEig:
    """Dense eigensolver (ref `DefaultEig`, src/EigSolver.jl:37-64)."""

    def __call__(self, J, nev: int):
        check_partition(False, "DenseEig")
        if is_operator(J):
            raise TypeError("DenseEig needs a dense matrix jacobian; use "
                            "LOBPCGEig for matrix-free symmetric operators")
        w, v = dense_eig(J, with_vectors=True)
        return w[:nev], v[:, :nev], True, 1


@dataclasses.dataclass(frozen=True)
class FlatOperator:
    """A flat-vector matvec with its dimension for the eig layer.
    `block_op`, when given, applies the operator to a (k, n) block of
    rows in one call; otherwise a block is applied row by row."""

    op: Callable
    n: int
    dtype: Any = None
    device: Any = None
    block_op: Optional[Callable] = None

    @property
    def example_vector(self):
        return torch.zeros((self.n,), dtype=self.dtype or torch.float64,
                           device=self.device)

    def block(self, X: torch.Tensor) -> torch.Tensor:
        if self.block_op is not None:
            return self.block_op(X)
        return torch.stack([self.op(x) for x in X])

    def __call__(self, v):
        return self.op(v)


def _as_flat_matvec(J):
    """Normalize a jacobian representation to (matvec, block matvec, n,
    dtype, device) on flat vectors / (k, n) row blocks."""
    if is_operator(J):
        probe = getattr(J, "example_vector", None)
        if probe is None:
            raise ValueError(
                "matrix-free eigensolve needs the operator to expose "
                "`example_vector` (a state with the right structure) or "
                "wrap it with FlatOperator(op, n)")
        flat0, unravel = ravel(probe)

        def matvec(v):
            return ravel(J(unravel(v)))[0]

        if hasattr(J, "block"):
            block = J.block
        else:
            def block(X):
                return torch.stack([matvec(x) for x in X])

        return matvec, block, flat0.shape[0], flat0.dtype, flat0.device

    def matvec(v):
        return J @ v

    def block(X):
        return X @ J.T

    return matvec, block, J.shape[0], J.dtype, J.device


def _rownorm(M):
    return torch.clamp_min(torch.linalg.vector_norm(M, dim=1), 1e-30)


@dataclasses.dataclass(frozen=True)
class LOBPCGEig:
    """Preconditioned blocked LOBPCG for SYMMETRIC jacobians.

    Returns the `nev` algebraically-largest (= rightmost, the spectrum is
    real) eigenpairs.  For gradient-flow PDE jacobians — e.g.
    Swift-Hohenberg's J = -(I+Delta)^2 + diag(l + 2 nu u - 3 u^2) — the
    stability sweep needs no inner solves: with the model's spectral
    preconditioner it converges in a handful of blocked J@X applications
    and small dense Rayleigh-Ritz problems.  It replaces the reference's
    `EigArpack(0.1, :LM)` shift-invert sweep on the SH2d flagship (ref
    examples/SH2d-fronts.jl:91).

    Each iteration re-applies A to the full orthonormalized [X | W | P]
    basis (one blocked call of 3k matvecs) rather than rotating cached
    products, so a rank-deficient basis near convergence wastes a few
    search directions instead of amplifying noise.

    `precond` maps a (k, n) block of rows R to T R with T ~ (alpha I - J)^-1
    in the loose preconditioning sense (the model's spectral inverse of the
    linear part works).

    CONTRACT: J must be symmetric.  `symmetry_check` probes
    `|<Jv,w> - <v,Jw>|` on two random vectors and raises on misuse.  With
    `refine_iters > 0` the result is refined on the full-precision operator
    `J_hi`: a reduced-precision sweep stalls at an eigenvalue error
    ~ 3k * eps_f32 * ||A||; a few f64 Rayleigh-Ritz passes on the f32
    subspace restore full-precision eigenvalues.
    """

    maxiter: int = 30
    tol: float = 1e-4
    precond: Optional[Callable] = None
    extra: int = 2          # guard vectors beyond nev (convergence buffer)
    compute_dtype: Any = None
    seed: int = 7
    refine_iters: int = 2
    symmetry_check: bool = True

    def seed_cols(self, nev: int) -> int:
        # warm-start block = the converged eigenvector block
        return nev

    def _check_symmetry(self, matvec, n, dtype, device):
        gen = torch.Generator(device=device).manual_seed(314)
        v = torch.randn((n,), generator=gen, dtype=dtype, device=device)
        w = torch.randn((n,), generator=gen, dtype=dtype, device=device)
        jv, jw = matvec(v), matvec(w)
        asym = abs(float(torch.dot(jv, w) - torch.dot(v, jw)))
        nrm = torch.linalg.vector_norm
        scale = float(nrm(jv) * nrm(w) + nrm(v) * nrm(jw))
        tol = 1e3 * float(torch.finfo(dtype).eps)
        if asym > tol * max(scale, 1e-30):
            raise ValueError(
                "LOBPCGEig requires a SYMMETRIC operator: symmetry probe "
                f"|<Jv,w> - <v,Jw>| = {asym:.3e} (scale {scale:.3e}). "
                "Pass symmetry_check=False if the probe misfires.")

    def __call__(self, J, nev: int, v0=None, J_hi=None):
        check_partition(False, "LOBPCGEig")
        if self.compute_dtype is not None and not is_operator(J):
            if J_hi is None and self.refine_iters > 0:
                J_hi = J
            J = J.to(self.compute_dtype)
        matvec, blockA, n, dtype, device = _as_flat_matvec(J)
        if self.symmetry_check:
            self._check_symmetry(matvec, n, dtype, device)
        k = min(nev + self.extra, n)
        eps = float(torch.finfo(dtype).eps)
        tol_eff = max(self.tol, 50.0 * eps)
        eps_c = math.sqrt(eps)

        if self.precond is None:
            def blockT(R):
                return R
        else:
            def blockT(R):
                return self.precond(R).to(R.dtype)

        gen = torch.Generator(device=device).manual_seed(self.seed)

        def randn_block():
            return torch.randn((k, n), generator=gen, dtype=dtype,
                               device=device)

        X0 = randn_block()
        if v0 is not None:
            v0 = torch.as_tensor(v0).to(dtype=dtype, device=device)
            if v0.dim() == 1:
                v0 = v0.reshape(n, -1)
            cols = min(v0.shape[1], k)
            if float(torch.linalg.vector_norm(v0)) > 0:
                X0[:cols] = v0[:, :cols].T

        def _cholqr(S):
            # CholQR with diagonal jitter on a (m, n) row block; two passes
            # give QR-grade orthogonality for the moderately conditioned
            # bases this loop produces
            m = S.shape[0]
            G = S @ S.T
            G = G + (10.0 * eps * torch.trace(G) / m) * torch.eye(
                m, dtype=dtype, device=device)
            L, _ = torch.linalg.cholesky_ex(G)
            return torch.linalg.solve_triangular(L, S, upper=False)

        def _ritz(S):
            """Orthonormalize S and Rayleigh-Ritz the top-k pairs."""
            Q = _cholqr(_cholqr(S))
            AQ = blockA(Q)
            G = Q @ AQ.T
            G = 0.5 * (G + G.T)
            w, Y = torch.linalg.eigh(G)          # ascending
            Yk = Y.flip(1)[:, :k]
            return w.flip(0)[:k], Yk.T @ Q, Yk.T @ AQ

        def _conv(theta, X, AX):
            rn = _rownorm(AX - theta[:, None] * X)
            scale = torch.clamp_min(torch.abs(theta), 1.0)
            return bool(torch.all(rn[:nev] < tol_eff * scale[:nev]))

        X0 = X0 / _rownorm(X0)[:, None]
        theta, X, AX = _ritz(X0)
        # seed P with random orthonormalized directions so the first
        # iteration's basis is full rank without a special case
        P = randn_block()
        P = P / _rownorm(P)[:, None]

        it = 0
        done = _conv(theta, X, AX)
        while it < self.maxiter and not done:
            W = blockT(AX - theta[:, None] * X)
            # pre-orthogonalize W against X (keeps the QR well conditioned)
            W = W - (W @ X.T) @ X
            # a converged pair's residual can underflow to ~zero; refill
            # such rows with fresh random directions so the CholQR jitter
            # never admits a spurious theta~0 Ritz pair
            wn = _rownorm(W)
            wfill = randn_block()
            W = torch.where((wn > eps_c)[:, None], W / wn[:, None],
                            wfill / _rownorm(wfill)[:, None])
            theta_n, Xn, AXn = _ritz(torch.cat([X, W, P], dim=0))
            # conjugate-direction block: the part of the new iterate outside
            # the old X span, refilled where it vanished
            Pn = Xn - (Xn @ X.T) @ X
            ps = _rownorm(Pn)
            refill = randn_block()
            refill = refill / _rownorm(refill)[:, None]
            P = torch.where((ps > eps_c)[:, None], Pn / ps[:, None], refill)
            theta, X, AX = theta_n, Xn, AXn
            done = _conv(theta, X, AX)
            it += 1

        if J_hi is not None and self.refine_iters > 0:
            theta, X, AX = self._refine(J_hi, X, k)

        converged = _conv(theta, X, AX)
        vals = theta[:nev].to(COMPLEX_DTYPE)
        vecs = X[:nev].T.to(COMPLEX_DTYPE)
        return vals, vecs, converged, it

    def _refine(self, J_hi, X_lo, k):
        """High-precision Rayleigh-Ritz + preconditioned-step passes on the
        reduced-precision subspace (see `refine_iters`)."""
        _, blockA, _, dtype, device = _as_flat_matvec(J_hi)
        eps = float(torch.finfo(dtype).eps)

        if self.precond is None:
            def blockT(R):
                return R.to(dtype)
        else:
            def blockT(R):
                return self.precond(R).to(dtype)

        def _cholqr2(S):
            m = S.shape[0]
            eye = torch.eye(m, dtype=dtype, device=device)
            for _ in range(2):
                G = S @ S.T
                G = G + (10.0 * eps * torch.trace(G) / m) * eye
                L, _ = torch.linalg.cholesky_ex(G)
                S = torch.linalg.solve_triangular(L, S, upper=False)
            return S

        X = X_lo.to(dtype)
        W = None
        for i in range(self.refine_iters):
            S = X if W is None else torch.cat([X, W], dim=0)
            Q = _cholqr2(S)
            AQ = blockA(Q)
            G = Q @ AQ.T
            G = 0.5 * (G + G.T)
            w, Y = torch.linalg.eigh(G)
            Yk = Y.flip(1)[:, :k]
            theta, X, AX = w.flip(0)[:k], Yk.T @ Q, Yk.T @ AQ
            if i + 1 == self.refine_iters:
                break      # last pass: W would be unused
            W = blockT(AX - theta[:, None] * X)
            W = W - (W @ X.T) @ X
            W = W / _rownorm(W)[:, None]
        return theta, X, AX


def _host_ritz(H: np.ndarray, fnorm: float, which_lm: bool):
    """Ritz pairs of the (m, m) Hessenberg matrix on the host, sorted by
    decreasing real part ("LR") or modulus ("LM"), ties by decreasing
    imaginary part, with their residual estimates |f| |e_m^T y|."""
    w, y = np.linalg.eig(H)
    key = np.abs(w) if which_lm else w.real
    order = np.lexsort((-w.imag, -key))
    w, y = w[order], y[:, order]
    resid = np.abs(fnorm) * np.abs(y[-1, :])
    return (w.astype(np.complex128), y.astype(np.complex128),
            resid.astype(np.float64))


@dataclasses.dataclass(frozen=True)
class ArnoldiEig:
    """Matrix-free Arnoldi for the rightmost (or largest-modulus) part of
    the spectrum.

    A fixed `krylov_dim`-step factorization A V_m = V_m H_m + f e_m^T is
    built on the device (one matvec and a CGS2 projection per step, no
    host sync inside it); only the (m x m) Hessenberg eigenproblem crosses
    to the host.  Ritz residuals |h_{m+1,m}| |e_m^T y| give convergence
    flags (ARPACK-style: below `tol * max(|theta|, 1)`).  With
    `restarts > 1`, an unconverged solve restarts from the sum of the
    wanted Ritz directions.  `v0` warm-starts the process (the previous
    continuation step's Ritz direction); a zero or missing `v0` takes a
    random start from a `torch.Generator` seeded with `seed`.
    """

    krylov_dim: int = 40
    tol: float = 1e-10
    restarts: int = 3
    which: str = "LR"     # LR = largest real part, LM = largest modulus
    seed: int = 7
    compute_dtype: Any = None

    def __call__(self, J, nev: int, v0=None):
        if self.compute_dtype is not None and not is_operator(J):
            J = J.to(self.compute_dtype)
        if not is_operator(J):
            check_partition(False, "ArnoldiEig on a dense jacobian")
        matvec, _, n, dtype, device = _as_flat_matvec(J)
        # on a row-partitioned state (`parallel.use_mesh`) n is this rank's
        # block: the Krylov dimension is bounded by the global size, and
        # every projection and norm is completed over the ranks
        m = min(self.krylov_dim, global_size(n))
        tiny = float(torch.finfo(dtype).tiny)
        which_lm = self.which == "LM"
        if v0 is not None:
            v0 = torch.as_tensor(v0).to(dtype=dtype, device=device).reshape(n)
        if v0 is None or not float(global_norm(v0)) > 0:
            gen = torch.Generator(device=device).manual_seed(self.seed)
            v0 = local_randn(gen, n, dtype, device)

        def factorization(v_start):
            V = torch.zeros((m + 1, n), dtype=dtype, device=device)
            H = torch.zeros((m + 1, m), dtype=dtype, device=device)
            V[0] = v_start / torch.clamp_min(global_norm(v_start), tiny)
            for j in range(m):
                w = matvec(V[j])
                # classical Gram-Schmidt with reorthogonalization (CGS2) on
                # the j+1 filled rows of the basis
                Vj = V[:j + 1]
                h1 = global_dot(Vj, w)
                w = w - h1 @ Vj
                h2 = global_dot(Vj, w)
                w = w - h2 @ Vj
                beta = global_norm(w)
                H[:j + 1, j] = h1 + h2
                H[j + 1, j] = beta
                # a happy breakdown leaves a zero row, decided on the device
                V[j + 1] = torch.where(beta > tiny,
                                       w / torch.clamp_min(beta, tiny), 0.0)
            Hh = H.cpu().numpy()
            return V, _host_ritz(Hh[:m, :m], float(Hh[m, m - 1]), which_lm)

        # floor the Ritz tolerance at the working precision (an f32 sweep
        # cannot reach the f64 default)
        tol_eff = max(self.tol, 50.0 * float(torch.finfo(dtype).eps))

        def converged(vals, resid):
            scale = np.maximum(np.abs(vals[:nev]), 1.0)
            return bool(np.all(resid[:nev] < tol_eff * scale))

        V, (vals, y, resid) = factorization(v0)
        for _ in range(self.restarts - 1):
            if converged(vals, resid):
                break      # a converged solve pays for no other factorization
            ysum = torch.as_tensor(y[:, :nev].sum(axis=1), device=device)
            wsum = torch.real(V[:m].T.to(COMPLEX_DTYPE) @ ysum).to(dtype)
            V, (vals, y, resid) = factorization(
                wsum / torch.clamp_min(global_norm(wsum), tiny))
        vecs = V[:m].T.to(COMPLEX_DTYPE) @ torch.as_tensor(y[:, :nev],
                                                           device=device)
        return (torch.as_tensor(vals[:nev], device=device), vecs,
                converged(vals, resid), m * self.restarts)


@dataclasses.dataclass(frozen=True)
class SubspaceEig:
    """Block orthogonal (subspace) iteration for the largest-modulus part
    of a NONSYMMETRIC operator spectrum, matrix-free and batched: each
    sweep applies the operator to the whole (n, b) block in one block
    call, so an operator whose single application is a long sequential
    chain — the matrix-free trapeze monodromy, M-1 inner solves per
    application (`Trapeze.monodromy_operator`, whose block call runs the
    batched GMRES) — amortizes its launches over the block.  Warm-started
    from the previous continuation step's block (`v0`) a couple of sweeps
    converge the dominant multipliers.  Rayleigh-Ritz on the projected
    (k b, k b) matrix runs on the host with numpy, as the JAX package's
    CPU route does; a zero or missing `v0` takes a random start from a
    `torch.Generator` seeded with `seed` (drawn on the CPU and moved to
    the operator's device, so the card and the CPU start alike)."""

    sweeps: int = 2         # power-iteration warmups (1 = none beyond basis)
    krylov_blocks: int = 3  # Ritz space = span[Q, AQ, ..., A^{k-1}Q]
    extra: int = 4          # guard vectors beyond nev
    tol: float = 1e-6
    seed: int = 11

    def seed_cols(self, nev: int) -> int:
        # warm-start block = the previous full block
        return nev + self.extra

    def make_seed(self, vecs, ncols: int):
        """Warm-start block from complex Ritz vectors: interleave Re/Im so
        a conjugate pair contributes its full 2-plane (plain real parts
        duplicate the pair's column and lose the rotation plane)."""
        inter = torch.stack([torch.real(vecs), torch.imag(vecs)],
                            dim=2).reshape(vecs.shape[0], -1)
        if inter.shape[1] < ncols:
            inter = torch.nn.functional.pad(
                inter, (0, ncols - inter.shape[1]))
        return inter[:, :ncols]

    def __call__(self, J, nev: int, v0=None):
        check_partition(False, "SubspaceEig")
        _, block, n, dtype, device = _as_flat_matvec(J)
        b = min(nev + self.extra, n)
        k = max(1, self.krylov_blocks)

        def opb(Q):                    # (n, c) columns -> (n, c)
            return block(Q.T.contiguous()).T

        gen = torch.Generator().manual_seed(self.seed)
        Q_rand = torch.randn((n, b), generator=gen,
                             dtype=dtype).to(device)
        Q = Q_rand
        if v0 is not None:
            v0 = torch.as_tensor(v0).to(dtype=dtype, device=device)
            if v0.ndim == 1:
                v0 = v0[:, None]
            if v0.shape[1] < b:
                v0 = torch.cat([v0, Q_rand[:, :b - v0.shape[1]]], dim=1)
            else:
                v0 = v0[:, :b]
            if float(torch.linalg.vector_norm(v0)) > 0:
                Q = v0
        Q = torch.linalg.qr(Q)[0]
        for _ in range(self.sweeps - 1):
            Q = torch.linalg.qr(opb(Q))[0]
        # block-Krylov Rayleigh-Ritz: project A onto span[Q, AQ, ...] — each
        # extra block costs one batched application and squares the
        # subspace-angle error the plain power sweep would leave
        blocks = [Q]
        for _ in range(k - 1):
            blocks.append(opb(blocks[-1]))
        B = torch.linalg.qr(torch.cat(blocks, dim=1))[0]
        Z = opb(B)
        H = (B.T @ Z).cpu().numpy()              # (k b, k b) projected op
        w_np, y_np = np.linalg.eig(H)
        w = torch.as_tensor(w_np.astype(np.complex128), device=device)
        y = torch.as_tensor(y_np.astype(np.complex128), device=device)
        # normalize Ritz vectors; residual R = (A - w I)(B y) = Z y - B y w
        y = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=0,
                                                         keepdim=True),
                                torch.finfo(dtype).tiny)
        By = B.to(COMPLEX_DTYPE) @ y
        R = Z.to(COMPLEX_DTYPE) @ y - By * w[None, :]
        resid = torch.linalg.vector_norm(R, dim=0).cpu().numpy()
        # residual-filtered :LM selection: a Krylov subspace of a nonnormal
        # operator carries spurious large-modulus Ritz values; rank the
        # unconverged candidates behind every plausibly-converged one
        tol_eff = max(self.tol, 50.0 * float(torch.finfo(dtype).eps))
        plaus = resid < np.maximum(0.05 * np.abs(w_np), 100.0 * tol_eff)
        rank_mod = np.where(plaus, np.abs(w_np), -resid)
        order = np.lexsort((-w_np.imag, -rank_mod))
        sel = torch.as_tensor(order[:nev], device=device)
        scale = np.maximum(np.abs(w_np[order[:nev]]), 1.0)
        converged = bool(np.all(resid[order[:nev]] < tol_eff * scale))
        return (w[sel], By[:, sel], converged,
                b * (self.sweeps - 1) + B.shape[1])


def _accepts_v0(solver) -> bool:
    try:
        return "v0" in inspect.signature(solver).parameters
    except (TypeError, ValueError):      # a builtin without a signature
        return False


@dataclasses.dataclass(frozen=True)
class ShiftInvertEig:
    """Shift-invert wrapper: eigensolve (J - sigma I)^{-1} and map back,
    theta -> sigma + 1/theta (ref `ShiftInvert`, src/EigSolver.jl:246-266).
    Targets the eigenvalues nearest `sigma` — the tool for
    rightmost-eigenvalue stability queries on PDE jacobians whose spectrum
    reaches far left.  An operator J needs an iterative `linsolver` (each
    application of the inverse is one inner solve); a dense J is factored
    once by LU."""

    sigma: float = 0.0
    eigsolver: Any = dataclasses.field(
        default_factory=lambda: ArnoldiEig(which="LM"))
    linsolver: Any = None   # needed for operators; dense J uses LU
    compute_dtype: Any = None

    def __call__(self, J, nev: int, v0=None):
        if self.compute_dtype is not None and not is_operator(J):
            J = J.to(self.compute_dtype)
        sigma = self.sigma
        if is_operator(J):
            ls = self.linsolver
            if ls is None:
                raise ValueError("ShiftInvertEig on an operator needs an "
                                 "iterative linsolver")
            _, _, n, dtype, device = _as_flat_matvec(J)

            def raw_op(v):
                sol, _, _ = ls(lambda w: _shift_op(J, w, sigma), v)
                return sol

            op = FlatOperator(raw_op, n, dtype, device)
        else:
            check_partition(False, "ShiftInvertEig on a dense jacobian")
            n = J.shape[0]
            fac = dense_factor(J - sigma * torch.eye(n, dtype=J.dtype,
                                                     device=J.device))
            op = FlatOperator(lambda v: dense_factor_solve(fac, v), n,
                              J.dtype, J.device)
        if _accepts_v0(self.eigsolver):
            vals, vecs, cv, it = self.eigsolver(op, nev, v0=v0)
        else:
            vals, vecs, cv, it = self.eigsolver(op, nev)
        mapped = sigma + 1.0 / vals.cpu().numpy()
        order = np.lexsort((-mapped.imag, -mapped.real))
        if vecs is not None:
            vecs = vecs[:, torch.as_tensor(order, device=vecs.device)]
        return (torch.as_tensor(mapped[order], device=vals.device), vecs, cv,
                it)


def _shift_op(J, w, sigma):
    """(J - sigma I) w."""
    return tree_axpy(-sigma, w, apply_J(J, w))
