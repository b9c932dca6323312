"""Shooting discretizations — the port of `jl_tpu/periodic/shooting.py`
(ref src/periodicorbit/StandardShooting.jl, PoincareShooting.jl).

Standard shooting: M parallel segments, unknowns X = [x_0..x_{M-1}, T]:

    Phi_{T/M}(x_i) - x_{i+1 mod M} = 0   (M*n rows)   + phase (1 row)

The M flows evolve as one batch of states (the reference's
EnsembleProblem parallelism, ref FlowDE.jl:86-99).

Poincare shooting: unknowns live in M hyperplane sections (dim n-1) plus
the M return times; the segment flows are again one batch, and no phase
condition is needed (the sections fix the phase; ref
PoincareShooting.jl:50).  In the event-driven mode the unknowns are the
hyperplane coordinates only and each segment flows to its next section's
crossing, located on a fixed grid by a masked argmax (no host branch, so
the map stays differentiable by `torch.func`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..linalg.eig import FlatOperator
from .flow import Flow
from .trapezoid import F_batch


def _flow_for(disc, prob_vf, steps=None):
    return Flow(prob_vf.F, steps=disc.steps_per_segment if steps is None
                else steps, method=disc.method, adaptive=disc.adaptive,
                rtol=disc.rtol, atol=disc.atol, max_steps=disc.max_steps,
                jac_op=prob_vf.jac_op, d2F=prob_vf.d2F_user,
                batched=bool(getattr(prob_vf, "batched_F", False)))


def _stack_samples(samples, dtype, device):
    if isinstance(samples[0], torch.Tensor) and device is None:
        device = samples[0].device
    dev = resolve_device(device)
    return torch.stack([torch.as_tensor(s).to(dtype=dtype, device=dev)
                        for s in samples])


@dataclasses.dataclass(frozen=True)
class Shooting:
    """Standard M-segment parallel shooting (ref Shooting,
    StandardShooting.jl:59)."""

    M: int = 5
    steps_per_segment: int = 60
    method: str = "dopri5"
    # adaptive error-controlled flows (ref the SciML abstol/reltol the
    # reference exposes, FlowDE.jl:41-99)
    adaptive: bool = False
    rtol: float = 1e-7
    atol: float = 1e-9
    max_steps: int = 256

    def unknown_size(self, n: int) -> int:
        return self.M * n + 1

    def split(self, X, n: int):
        return X[:-1].reshape(self.M, n), X[-1]

    def pack(self, u, T):
        return torch.cat([u.reshape(-1), torch.as_tensor(
            T, dtype=u.dtype, device=u.device).reshape(1)])

    def period(self, X):
        return X[-1]

    def _flow(self, prob_vf):
        return _flow_for(self, prob_vf)

    def residual(self, prob_vf, X, po_par):
        params = po_par["_inner"]
        n = po_par["_xsec"].shape[0]
        u, T = self.split(X, n)
        ends = self._flow(prob_vf)(u, params, T / self.M)
        rows = ends - torch.roll(u, -1, dims=0)
        phase = torch.dot(u[0] - po_par["_xsec"], po_par["_phisec"])
        return torch.cat([rows.reshape(-1), phase.reshape(1)])

    def jacobian_operator(self, prob_vf, X, po_par):
        """dX -> J_po(X) dX through `Flow.jvp` (the variational flow where
        the model has a J.v), the period's column included; dX is (N,) or
        a batch (K, N), each column one tangent of the segment flows."""
        params = po_par["_inner"]
        n = po_par["_xsec"].shape[0]
        M = self.M
        u, T = self.split(X, n)
        fl = self._flow(prob_vf)
        phisec = po_par["_phisec"]

        def op(dX):
            D = dX if dX.dim() == 2 else dX[None]
            du = D[:, :-1].reshape(D.shape[0], M, n).transpose(0, 1)
            dT = (D[:, -1] / M).expand(M, -1)
            _, dends = fl.jvp(u, params, T / M, du, dT)  # (M, K, n)
            rows = dends - torch.roll(du, -1, dims=0)
            out = torch.cat([rows.transpose(0, 1).reshape(D.shape[0], -1),
                             (du[0] @ phisec)[:, None]], dim=1)
            return out if dX.dim() == 2 else out[0]

        return op

    def monodromy(self, prob_vf, X, po_par):
        """The ordered product of the per-segment flow jacobians dPhi (ref
        FloquetQaD for shooting, Floquet.jl:164-254), the M segments as
        one batch."""
        params = po_par["_inner"]
        n = po_par["_xsec"].shape[0]
        u, T = self.split(X, n)
        dPhis = self._flow(prob_vf).monodromy(u, params, T / self.M)
        Mn = torch.eye(n, dtype=X.dtype, device=X.device)
        for D in dPhis:
            Mn = D @ Mn
        return Mn

    def monodromy_operator(self, prob_vf, X, po_par, linsolver=None):
        """The matrix-free monodromy V -> M V: the chain of per-segment
        flow jvps (ref the matrix-free FloquetQaD operator,
        Floquet.jl:89-109, and the MF shooting variant :164-254), never
        forming the (n, n) matrix.  A (K, n) block is one pass of the
        chain; with a model J.v each stage of each segment is one J.v call
        on the block.  Feed it to `FloquetQaDMF`."""
        params = po_par["_inner"]
        n = po_par["_xsec"].shape[0]
        u, T = self.split(X, n)
        fl = self._flow(prob_vf)

        def Mv_block(V):
            for i in range(self.M):
                V = fl.jvp(u[i], params, T / self.M, V)[1]
            return V

        return FlatOperator(lambda v: Mv_block(v[None])[0], n, X.dtype,
                            X.device, block_op=Mv_block)

    def generate_solution(self, orbit_fn, T, n: int, dtype=torch.float64,
                          device=None):
        ts = np.linspace(0, 2 * np.pi, self.M, endpoint=False)
        u = _stack_samples([orbit_fn(t) for t in ts], dtype, device)
        return self.pack(u.reshape(self.M, n), T)

    def section_data(self, prob_vf, X, params):
        n = prob_vf.u0.numel()
        u, _ = self.split(X, n)
        return {"_xsec": u[0], "_phisec": prob_vf.F(u[0], params)}


@dataclasses.dataclass(frozen=True)
class PoincareShooting:
    """Poincare shooting with hyperplane sections (ref
    PoincareShooting.jl).

    Unknowns X = [y_0..y_{M-1} (each n-1, hyperplane coordinates),
    t_0..t_{M-1} (return times)]; residual per segment
    Phi_{t_i}(E_i(y_i)) - E_{i+1}(y_{i+1}) = 0 (n rows each).  Sections
    are centers + normals in the parameter dict (ref SectionPS,
    Sections.jl:87).  `event_driven=True` is the reference's formulation
    (PoincareShooting.jl:50): the unknowns are the hyperplane coordinates
    only, and each segment integrates until it crosses the next section,
    located on a fixed grid of `steps_per_segment` steps over
    `horizon * t_hint` and refined by Newton on the crossing time."""

    M: int = 2
    steps_per_segment: int = 80
    method: str = "dopri5"
    # adaptive error control for the free-time segment flows (the
    # section-crossing grid stays fixed: the event location needs it)
    adaptive: bool = False
    rtol: float = 1e-7
    atol: float = 1e-9
    max_steps: int = 256
    event_driven: bool = False
    horizon: float = 1.8
    newton_time_steps: int = 3

    def unknown_size(self, n: int) -> int:
        if self.event_driven:
            return self.M * (n - 1)
        return self.M * (n - 1) + self.M

    def split(self, X, n: int):
        if self.event_driven:
            return X.reshape(self.M, n - 1), None
        return (X[:self.M * (n - 1)].reshape(self.M, n - 1),
                X[self.M * (n - 1):])

    def pack(self, y, ts):
        return torch.cat([y.reshape(-1), torch.as_tensor(
            ts, dtype=y.dtype, device=y.device).reshape(-1)])

    def period(self, X):
        if self.event_driven:
            # the period is an output of the event-driven integration, not
            # a function of the unknowns alone: see period_par
            return float("nan")
        return torch.sum(X[-self.M:])

    def period_par(self, prob_vf, X, po_par):
        return torch.sum(self.crossing_times(prob_vf, X, po_par))

    def _flow(self, prob_vf):
        return _flow_for(self, prob_vf)

    @staticmethod
    def _basis(normals):
        """Orthonormal bases (M, n, n-1) of the hyperplanes orthogonal to
        `normals` (M, n) (projection/expansion operators R, E, ref
        :188-215): QR of [normal, I]."""
        M, n = normals.shape
        nrm = normals / torch.linalg.vector_norm(normals, dim=1,
                                                 keepdim=True)
        eye = torch.eye(n, dtype=normals.dtype, device=normals.device)
        Q, _ = torch.linalg.qr(torch.cat([nrm[:, :, None],
                                          eye.expand(M, n, n)], dim=2))
        return Q[:, :, 1:n]

    def expand(self, y, centers, normals):
        """Points (M, n) of the hyperplane coordinates y (M, n-1)."""
        return centers + (self._basis(normals) @ y[..., None])[..., 0]

    def project(self, x, centers, normals):
        return (self._basis(normals).transpose(1, 2)
                @ (x - centers)[..., None])[..., 0]

    def _flow_to_section(self, prob_vf, x0, params, c, nrm, t_hint,
                         dx0=None):
        """Integrate each row of x0 (M, n) until its first upward crossing
        of the hyperplane {<x - c, nrm> = 0} (row-wise), refined by Newton
        on the crossing time (ref the section-crossing callbacks,
        ShootingDE.jl).  With tangents dx0 (M, K, n), also the map's jvp:
        the variational flow along the grid, the crossing's index held,
        and the jvp of each time refinement.  Returns (x_cross (M, n),
        tau (M,), dx_cross or None)."""
        K = self.steps_per_segment
        dt = t_hint * self.horizon / K                  # (M,)
        small = dataclasses.replace(_flow_for(self, prob_vf, steps=1),
                                    adaptive=False)

        def advance(x, dx, h, dh=None):
            if dx is None:
                return small(x, params, h), None
            return small.jvp(x, params, h, dx, dh)

        traj, dtraj, x, dx = [], [], x0, dx0
        for _ in range(K):
            x, dx = advance(x, dx, dt)
            traj.append(x)
            dtraj.append(dx)
        traj = torch.stack(traj)                         # (K, M, n)
        s = torch.sum((traj - c) * nrm, dim=-1)          # (K, M)
        s0 = torch.sum((x0 - c) * nrm, dim=-1)
        prev = torch.cat([s0[None], s[:-1]])
        kmin = max(1, K // 10)
        steps = torch.arange(K, device=x0.device)[:, None]
        mask = (prev < 0) & (s >= 0) & (steps >= kmin)
        # the first crossing by a masked argmax (K - 1 if none)
        idx = torch.where(mask.any(0), torch.argmax(mask.to(torch.int32), 0),
                          K - 1)
        rows = torch.arange(x0.shape[0], device=x0.device)
        x_c = traj[idx, rows]
        dx_c = None if dx0 is None else torch.stack(dtraj)[idx, rows]
        tau = (idx + 1.0) * dt
        jv = small._jv(params) if dx0 is not None else None
        for _ in range(self.newton_time_steps):
            sv = torch.sum((x_c - c) * nrm, dim=-1)
            dsv = torch.sum(F_batch(prob_vf, x_c, params) * nrm, dim=-1)
            dtau = -sv / dsv
            d_dtau = None
            if dx0 is not None:
                d_sv = torch.sum(dx_c * nrm[:, None], dim=-1)    # (M, K)
                d_dsv = torch.sum(jv(x_c, dx_c) * nrm[:, None], dim=-1)
                d_dtau = -(d_sv * dsv[:, None] - sv[:, None] * d_dsv) \
                    / (dsv * dsv)[:, None]
            x_c, dx_c = advance(x_c, dx_c, dtau, d_dtau)
            tau = tau + dtau
        return x_c, tau, dx_c

    def crossing_times(self, prob_vf, X, po_par):
        """Per-segment section-return times at the current unknowns
        (event-driven mode): the period is their sum."""
        centers, normals = po_par["_centers"], po_par["_normals"]
        y, _ = self.split(X, centers.shape[1])
        x = self.expand(y, centers, normals)
        return self._flow_to_section(
            prob_vf, x, po_par["_inner"], torch.roll(centers, -1, dims=0),
            torch.roll(normals, -1, dims=0), po_par["_thint"])[1]

    def residual(self, prob_vf, X, po_par):
        params = po_par["_inner"]
        centers, normals = po_par["_centers"], po_par["_normals"]  # (M, n)
        y, ts = self.split(X, centers.shape[1])
        x = self.expand(y, centers, normals)
        c_next = torch.roll(centers, -1, dims=0)
        n_next = torch.roll(normals, -1, dims=0)
        y_next = torch.roll(y, -1, dims=0)
        if self.event_driven:
            x_c = self._flow_to_section(prob_vf, x, params, c_next, n_next,
                                        po_par["_thint"])[0]
            # fixed point of the composed Poincare maps in hyperplane
            # coordinates: R_{i+1}(P_i(E_i y_i)) - y_{i+1} = 0
            return (self.project(x_c, c_next, n_next) - y_next).reshape(-1)
        x_end = self._flow(prob_vf)(x, params, ts)
        return (x_end - self.expand(y_next, c_next, n_next)).reshape(-1)

    def jacobian_operator(self, prob_vf, X, po_par):
        """dX -> J_po(X) dX through the variational flow (the model's J.v):
        the free-time segments' jvp in (x_i, t_i), or the event-driven
        map's (`_flow_to_section`); dX is (N,) or a batch (K, N)."""
        params = po_par["_inner"]
        centers, normals = po_par["_centers"], po_par["_normals"]
        M, n = centers.shape
        y, ts = self.split(X, n)
        B = self._basis(normals)                         # (M, n, n-1)
        B_next = torch.roll(B, -1, dims=0)
        x = self.expand(y, centers, normals)

        def op(dX):
            D = dX if dX.dim() == 2 else dX[None]
            K = D.shape[0]
            dy = D[:, :M * (n - 1)].reshape(K, M, n - 1).transpose(0, 1)
            dx = (B[:, None] @ dy[..., None])[..., 0]      # (M, K, n)
            dy_next = torch.roll(dy, -1, dims=0)
            if self.event_driven:
                dx_c = self._flow_to_section(
                    prob_vf, x, params, torch.roll(centers, -1, dims=0),
                    torch.roll(normals, -1, dims=0), po_par["_thint"],
                    dx0=dx)[2]
                rows = (B_next.transpose(1, 2)[:, None]
                        @ dx_c[..., None])[..., 0] - dy_next
            else:
                dx_end = self._flow(prob_vf).jvp(x, params, ts, dx,
                                                 D[:, M * (n - 1):].T)[1]
                rows = dx_end - (B_next[:, None] @ dy_next[..., None])[..., 0]
            out = rows.transpose(0, 1).reshape(K, -1)
            return out if dX.dim() == 2 else out[0]

        return op

    def monodromy(self, prob_vf, X, po_par):
        params = po_par["_inner"]
        centers, normals = po_par["_centers"], po_par["_normals"]
        y, ts = self.split(X, centers.shape[1])
        x0 = self.expand(y[:1], centers[:1], normals[:1])[0]
        if self.event_driven:
            T = torch.sum(self.crossing_times(prob_vf, X, po_par).detach())
        else:
            T = torch.sum(ts)
        return self._flow(prob_vf).monodromy(x0, params, T)

    def generate_solution(self, orbit_fn, T, n: int, dtype=torch.float64,
                          device=None):
        ts_angle = np.linspace(0, 2 * np.pi, self.M, endpoint=False)
        pts = _stack_samples([orbit_fn(t) for t in ts_angle], dtype,
                             device).reshape(self.M, n)
        y = torch.zeros((self.M, n - 1), dtype=dtype, device=pts.device)
        object.__setattr__(self, "_init_centers", pts)
        object.__setattr__(self, "_init_times",
                           torch.full((self.M,), T / self.M, dtype=dtype,
                                      device=pts.device))
        if self.event_driven:
            return y.reshape(-1)
        return self.pack(y, self._init_times)

    def section_data(self, prob_vf, X, params, po_par=None):
        centers = getattr(self, "_init_centers", None)
        if centers is None:
            centers = prob_vf.u0.reshape(1, -1).expand(self.M, -1)
        normals = F_batch(prob_vf, centers, params)
        normals = normals / torch.linalg.vector_norm(normals, dim=1,
                                                     keepdim=True)
        out = {"_inner": params, "_centers": centers, "_normals": normals}
        if self.event_driven:
            if po_par is not None and "_thint" in po_par:
                out["_thint"] = self.crossing_times(
                    prob_vf, X, {**po_par, "_inner": params,
                                 "_centers": centers, "_normals": normals})
            else:
                out["_thint"] = getattr(
                    self, "_init_times",
                    torch.ones((self.M,), dtype=centers.dtype,
                               device=centers.device))
        return out
