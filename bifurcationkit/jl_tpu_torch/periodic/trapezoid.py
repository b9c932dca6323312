"""Trapezoid (finite-difference) periodic-orbit discretization — the port
of `jl_tpu/periodic/trapezoid.py` (ref
src/periodicorbit/PeriodicOrbitTrapeze.jl).

Unknown X = [u_0, ..., u_{M-1} (flattened (M, n)), T]; rows:
  * periodicity  u_0 - u_{M-1}                               (ref :70-107)
  * trapezoid    u_i - u_{i-1} - T*h/2 (F(u_i) + F(u_{i-1})) for i = 1..M-1
  * phase        (1/M) sum_i <u_i - uref_i, phi_i>           (ref :209-292)

The M slices go through F in one call: the time axis is the batch axis
(models that mark `batched_F` take it natively, others through
`torch.func.vmap`).  The reference orbit and phase gradient live in the
parameter dict and are refreshed by the update hook (ref
updatesection!).  The matrix-free monodromy applies the per-slice maps to
a whole block of vectors, each implicit half-step a batched GMRES solve
(`linalg/linear.py::_gmres_block`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.func import jvp, vmap

from .. import resolve_device
from ..linalg.eig import FlatOperator
from ..linalg.linear import GMRES


def F_batch(prob_vf, U, params):
    """F on each row of U (k, n)."""
    if getattr(prob_vf, "batched_F", False):
        return prob_vf.F(U, params)
    return vmap(lambda x: prob_vf.F(x, params))(U)


def jv_batch(prob_vf, X, params, V):
    """J(X_i) V_i for each row: X (k, n) or (n,) broadcast, V (k, n).
    A batched model's `jac_op` takes the rows in one call; otherwise J.v
    is the jvp of F, which a row-partitioned model (`n_global`) refuses:
    its dual would cross the halo exchange."""
    if prob_vf.jac_op is not None and getattr(prob_vf, "batched_F", False):
        return prob_vf.jac_op(X, params)(V)
    if getattr(prob_vf, "n_global", None) is not None:
        raise NotImplementedError(
            "a row-partitioned model needs a batched jac_op here "
            "(e.g. brusselator_1d_sharded(..., batched=True)): forward AD "
            "would cross its halo exchange")
    X = X.expand_as(V).contiguous()     # a dual needs its own storage
    return jvp(lambda Y: F_batch(prob_vf, Y, params), (X,), (V,))[1]


def slice_jacobians(prob_vf, U, params):
    """The dense jacobians (k, n, n) at the rows of U (k, n): a batched
    model's `jac_op` applied to the identity, else a vmapped jacfwd."""
    if prob_vf.jac_op is not None and getattr(prob_vf, "batched_F", False):
        eye = torch.eye(U.shape[1], dtype=U.dtype, device=U.device)
        return prob_vf.jac_op(U[:, None, :], params)(eye).transpose(-1, -2)
    return vmap(lambda x: prob_vf.jacobian(x, params))(U)


def solve_rows(ls, op_block, rhs):
    """Solve op x = r for each row of rhs (k, n): the solver's batched
    route where it has one, else row by row."""
    if hasattr(ls, "solve_block"):
        return ls.solve_block(op_block, rhs)[0]
    return torch.stack([ls(lambda w: op_block(w[None])[0], r)[0]
                        for r in rhs])


@dataclasses.dataclass(frozen=True)
class Trapeze:
    """Discretization config (ref `Trapeze`, PeriodicOrbitTrapeze.jl:70)."""

    M: int = 50
    time_mesh: Any = None   # optional (M-1,) step fractions, sum = 1
                            # (ref TimeMesh, src/TimeMesh.jl:9)

    def steps(self, dtype=torch.float64, device=None):
        if self.time_mesh is not None:
            return torch.as_tensor(np.asarray(self.time_mesh), dtype=dtype,
                                   device=device)
        return torch.full((self.M - 1,), 1.0 / (self.M - 1), dtype=dtype,
                          device=device)

    def unknown_size(self, n: int) -> int:
        return self.M * n + 1

    def split(self, X, n: int):
        return X[:-1].reshape(self.M, n), X[-1]

    def pack(self, u, T):
        return torch.cat([u.reshape(-1), torch.as_tensor(
            T, dtype=u.dtype, device=u.device).reshape(1)])

    def period(self, X):
        return X[-1]

    def residual(self, prob_vf, X, po_par):
        """po_par = {"_inner": model params, "_uref": (M,n), "_phi": (M,n)}."""
        M = self.M
        params = po_par["_inner"]
        n = po_par["_uref"].shape[1]
        u, T = self.split(X, n)
        h = self.steps(X.dtype, X.device)[:, None]
        Fu = F_batch(prob_vf, u, params)
        # trapezoid rows for i = 1..M-1 (non-uniform mesh supported)
        rows = (u[1:] - u[:-1]) - (T * h / 2.0) * (Fu[1:] + Fu[:-1])
        per = u[0] - u[M - 1]
        # phase condition <u - uref, phi> integrated over the mesh
        phase = torch.sum((u - po_par["_uref"]) * po_par["_phi"]) / M
        return torch.cat([per, rows.reshape(-1), phase.reshape(1)])

    def jacobian_operator(self, prob_vf, X, po_par):
        """dX -> J_po(X) dX in closed form from the vector field's batched
        J.v (`jv_batch`): the linearized trapezoid rows, periodicity and
        phase rows, the period's column (T h/2 (F_i + F_{i-1})) included.
        F is evaluated once here; each application is one batched J.v over
        the M slices.  It takes dX of shape (..., M n + 1)."""
        params = po_par["_inner"]
        n = po_par["_uref"].shape[1]
        M = self.M
        u, T = self.split(X, n)
        h = self.steps(X.dtype, X.device)[:, None]
        Fu = F_batch(prob_vf, u, params)
        Fsum = (h / 2.0) * (Fu[1:] + Fu[:-1])
        phi = po_par["_phi"]

        def op(dX):
            lead = dX.shape[:-1]
            du = dX[..., :-1].reshape(lead + (M, n))
            dT = dX[..., -1:].unsqueeze(-1)
            Jdu = jv_batch(prob_vf, u, params, du)
            rows = ((du[..., 1:, :] - du[..., :-1, :])
                    - (T * h / 2.0) * (Jdu[..., 1:, :] + Jdu[..., :-1, :])
                    - dT * Fsum)
            per = du[..., 0, :] - du[..., M - 1, :]
            phase = torch.sum(du * phi, dim=(-2, -1)) / M
            return torch.cat([per, rows.reshape(lead + (-1,)),
                              phase[..., None]], dim=-1)

        return op

    def monodromy(self, prob_vf, X, po_par):
        """The dense Floquet monodromy, the ordered product of the
        per-slice maps (I - T h/2 J_{i+1})^-1 (I + T h/2 J_i) (ref
        `FloquetQaD` for Trapeze, Floquet.jl:255-318).  The slice
        jacobians (`slice_jacobians`) and maps are built a chunk of slices
        at a time, with one batched solve each, so memory stays at a few
        chunks of (n, n) matrices."""
        params = po_par["_inner"]
        n = po_par["_uref"].shape[1]
        u, T = self.split(X, n)
        c = T * self.steps(X.dtype, X.device) / 2.0
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        chunk = max(1, 2 ** 22 // (n * n))
        def jac(U):
            return slice_jacobians(prob_vf, U, params)

        Mn = eye
        J_prev = jac(u[:1])
        for start in range(0, self.M - 1, chunk):
            stop = min(start + chunk, self.M - 1)
            J_next = jac(u[start + 1:stop + 1])
            J_here = torch.cat([J_prev[-1:], J_next[:-1]])
            ci = c[start:stop, None, None]
            S = torch.linalg.solve(eye - ci * J_next, eye + ci * J_here)
            for Si in S:
                Mn = Si @ Mn
            J_prev = J_next
        return Mn

    def monodromy_operator(self, prob_vf, X, po_par, linsolver=None):
        """The matrix-free monodromy v -> M v (ref the MF FloquetQaD
        operator for Trapeze, Floquet.jl:89-109,255-318): per slice, the
        explicit half by a jvp and the implicit half (I - T h/2 J_{i+1})
        by an iterative solve, for a whole (k, n) block of vectors at once
        (the operator's `block`; each slice one batched GMRES solve when
        the solver has `solve_block`).  `linsolver` defaults to plain
        GMRES; pass a preconditioned one for stiff operators.  On a
        row-partitioned model (`parallel/models.py`, batched) inside
        `parallel.use_mesh` X holds this rank's block of every slice and
        the operator applies to this rank's block of v: the J.v rows
        exchange their halos and block GMRES reduces over the ranks."""
        ls = linsolver or GMRES(restart=30, maxiter=120, rtol=1e-9)
        params = po_par["_inner"]
        n = po_par["_uref"].shape[1]
        u, T = self.split(X, n)
        h = self.steps(X.dtype, X.device)

        def Mv_block(V):
            for i in range(self.M - 1):
                c = T * h[i] / 2.0
                rhs = V + c * jv_batch(prob_vf, u[i], params, V)

                def B_op(W, x_next=u[i + 1], c=c):
                    return W - c * jv_batch(prob_vf, x_next, params, W)

                V = solve_rows(ls, B_op, rhs)
            return V

        return FlatOperator(lambda v: Mv_block(v[None])[0], n, X.dtype,
                            X.device, block_op=Mv_block)

    def phase_data(self, prob_vf, u, params):
        """Reference orbit + phase gradient phi = F(uref) for the Poincare
        phase condition."""
        return u, F_batch(prob_vf, u, params)

    def generate_solution(self, orbit_fn, T, n: int, dtype=torch.float64,
                          device=None):
        """Sample a time-periodic function guess onto the M-slice mesh
        (ref generate_solution, PeriodicOrbits.jl:74).  The samples stay on
        the device `orbit_fn` returns them on; numpy samples go to
        `device` (None means the card)."""
        ts = np.linspace(0, 2 * np.pi, self.M)
        samples = [orbit_fn(t) for t in ts]
        if isinstance(samples[0], torch.Tensor) and device is None:
            device = samples[0].device
        dev = resolve_device(device)
        u = torch.stack([torch.as_tensor(s).to(dtype=dtype, device=dev)
                         .reshape(n) for s in samples])
        return self.pack(u, T)

    def spectral_precond(self, n, sym_blocks, to_modes, from_modes, T0,
                         delta: float = 1e-2, device=None):
        """Space-time spectral preconditioner for the trapeze PO operator
        (the stand-in for the reference's ILU of the sparse trapeze
        jacobian, ref examples/cGL2d.jl:211).  The vector-field jacobian is
        frozen at its spectrally diagonalizable linear part: per spatial
        mode k with (c, c) symbol L_k the trapeze rows decouple into an
        M-slice cyclic block-bidiagonal system

            v_0 - v_{M-1} = b_per
            (I - c_i L_k) v_i - (I + c_i L_k) v_{i-1} = b_i,  c_i = T0 h_i/2

        solved exactly per mode by two sweeps over the slice maps
        S_i = B_i^-1 A_i and one closed (c, c) solve of
        ((1+delta) I - Phi) v_0 = b_per + g (Phi = S_{M-1}...S_1; delta
        keeps the critical Hopf mode, whose Phi is a full rotation,
        bounded).  Everything batches over the K modes.

        It computes in f32, with TF32 off (`check_tf32_off`): a chain of
        ~M small matmuls at reduced precision caps the preconditioned
        Krylov floor and stalls the corrector.  The two sweeps are Python
        loops of M-1 batched (K, c, c) products, one launch each
        (`torch.baddbmm`).

        `sym_blocks`: (K, c, c) frozen per-mode linearization;
        `to_modes(flat (..., n)) -> (..., K, c)` / `from_modes` its
        inverse; `T0` the frozen period.  Returns P^-1 acting on the full
        (M n + 1) residual vector (identity on the period/phase slot)."""
        M = self.M
        lo = torch.float32
        dev = resolve_device(device)
        Lk = torch.as_tensor(np.asarray(sym_blocks), dtype=lo, device=dev)
        K, c = Lk.shape[0], Lk.shape[-1]
        eye = torch.eye(c, dtype=lo, device=dev)
        ci = torch.as_tensor(float(T0) * self.steps().numpy() / 2.0,
                             dtype=lo, device=dev)
        B = eye - ci[:, None, None, None] * Lk[None]
        A = eye + ci[:, None, None, None] * Lk[None]
        Binv = torch.linalg.inv(B)                    # (M-1, K, c, c)
        S = Binv @ A
        Phi = eye.expand(K, c, c)
        for i in range(M - 1):
            Phi = torch.bmm(S[i], Phi)
        Minv = torch.linalg.inv((1.0 + delta) * eye - Phi)

        def apply(v):
            b0 = to_modes(v[:n].to(lo))[..., None]                # (K, c, 1)
            bi = to_modes(v[n:-1].reshape(M - 1, n).to(lo))[..., None]
            t = Binv @ bi                                    # (M-1, K, c, 1)
            g = torch.zeros_like(b0)
            for i in range(M - 1):
                g = torch.baddbmm(t[i], S[i], g)
            vs = [torch.bmm(Minv, b0 + g)]
            for i in range(M - 1):
                vs.append(torch.baddbmm(t[i], S[i], vs[-1]))
            out = from_modes(torch.stack(vs)[..., 0])              # (M, n)
            return torch.cat([out.reshape(-1).to(v.dtype), v[-1:]])

        return apply


def slice_spectral_precond(sym_blocks, to_modes, from_modes, c0,
                           device=None):
    """(I - c0 L_k)^-1 per spatial mode — preconditions the implicit
    half-step solves inside the matrix-free trapeze monodromy
    (`Trapeze.monodromy_operator`; ref the per-slice inversions in
    FloquetQaD, Floquet.jl:255-318).  f32 with TF32 off, as
    `Trapeze.spectral_precond`; it takes a vector or a (k, n) block."""
    lo = torch.float32
    dev = resolve_device(device)
    Lk = torch.as_tensor(np.asarray(sym_blocks), dtype=lo, device=dev)
    eye = torch.eye(Lk.shape[-1], dtype=lo, device=dev)
    Binv = torch.linalg.inv(eye[None] - float(c0) * Lk)

    def apply(v):
        w = to_modes(v.to(lo))[..., None]
        return from_modes((Binv @ w)[..., 0]).to(v.dtype)

    return apply
