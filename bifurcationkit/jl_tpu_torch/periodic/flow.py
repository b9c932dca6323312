"""Flows — ODE integrators for the shooting methods, the port of
`jl_tpu/periodic/flow.py` (replaces the reference's SciML-backed flows,
ref src/periodicorbit/Flow.jl, FlowDE.jl).

A flow integrates a batch of states (k, n) at once: the shooting segments
are the batch axis (the reference's EnsembleProblem parallelism, ref
FlowDE.jl:86-99).  The JAX package's `lax.scan` over steps is a Python
loop over batched states; every step is differentiable by `torch.func`
(the error-controlled loop masks accepted and rejected steps per lane
and stops early only outside a transform, where it gives the same
result).

`Flow.jvp` gives the flow's derivative in (u0, T) for K tangent columns
at once.  With a model J.v (`jac_op`) it integrates the variational
equation beside the state: each stage's tangent is the model's J.v on
that stage's state (rodas3's also takes d2F on its stage vectors), so the
result is the jvp of the step map, the tangent of dt = T/steps (or of
the adaptive loop's clipped steps) included, and a block of K columns is
one J.v call per stage.  Otherwise it is `torch.func.jvp` through the
integrator, vmapped over the columns (0.3-0.8 ms per operation on a CPU
host: an operation that mixes a dual with a plain tensor runs a Python
reference; the variational route avoids it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import jacfwd, jvp, vmap

from ..ops.nvcc import autodiff_active

# Butcher tableaus (rows of a_ij, weights b_i) of the explicit methods
_RK4 = (((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
        (1 / 6, 1 / 3, 1 / 3, 1 / 6))
_DOPRI5 = (((),
            (1 / 5,),
            (3 / 40, 9 / 40),
            (44 / 45, -56 / 15, 32 / 9),
            (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
            (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
             -5103 / 18656)),
           (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84))
# b - bhat of dopri5's embedded 4th-order solution over (k1..k7), k7 =
# f(u5) (the FSAL stage, recomputed: the masked loop cannot carry it)
_DOPRI5_ERR = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200,
               22 / 525, -1 / 40)
_EXPLICIT = {"rk4": _RK4, "dopri5": _DOPRI5}


def _combo(coeffs, ks):
    """sum_j c_j k_j over the nonzero coefficients."""
    out = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            out = c * k if out is None else out + c * k
    return out


def _erk_step(f, u, dt, tableau, jv=None, du=None, ddt=None):
    """One explicit Runge-Kutta step of the rows u (k, n) with step dt
    (broadcasting to (k, 1)).  With `jv`, also the step's jvp: tangents
    du (k, K, n) and the step's own tangent ddt (broadcasting to
    (k, K, 1); None means 0), each stage's tangent from jv(Y, dY).
    Returns (u_new, du_new or None, stages)."""
    A, b = tableau
    ks, dks = [], []
    for row in A:
        s = _combo(row, ks)
        Y = u if s is None else u + dt * s
        ks.append(f(Y))
        if jv is not None:
            dY = du
            if s is not None:
                dY = dY + dt[..., None] * _combo(row, dks)
                if ddt is not None:
                    dY = dY + ddt * s[:, None, :]
            dks.append(jv(Y, dY))
    s = _combo(b, ks)
    u_new = u + dt * s
    if jv is None:
        return u_new, None, ks
    du_new = du + dt[..., None] * _combo(b, dks)
    if ddt is not None:
        du_new = du_new + ddt * s[:, None, :]
    return u_new, du_new, ks


def _rk4_step(f, jac, u, dt):
    return _erk_step(f, u, dt, _RK4)[0]


def _dopri5_step(f, jac, u, dt):
    """One Dormand-Prince 5(4) step (fixed step, 5th-order solution)."""
    return _erk_step(f, u, dt, _DOPRI5)[0]


def _dopri5_step_err(f, jac, u, dt):
    """Dormand-Prince 5(4) step returning (u5, err) with the embedded
    4th-order error estimate (ref the adaptive SciML integrators the
    reference's shooting rides, src/periodicorbit/FlowDE.jl:41-99)."""
    u5, _, ks = _erk_step(f, u, dt, _DOPRI5)
    return u5, dt * _combo(_DOPRI5_ERR, ks + [f(u5)])


def _rodas3_step_err(f, jac, u, dt):
    """One RODAS3 step: 4-stage, order-3, L-stable, stiffly accurate
    linearly-implicit Rosenbrock (coefficients per Sandu et al. 1997),
    replacing the reference's stiff SciML solvers (Rodas4P/QNDF in
    examples/brusselatorShooting.jl:165-171).  Four batched dense solves
    with (I/(dt*gamma) - J) per step: forward AD goes through them (one
    `torch.linalg.solve` each, whose batched jvp is far cheaper under
    `vmap` than an `lu_factor`/`lu_solve` pair's).  The embedded order-2
    solution is u + 2 k1 + k3, so the error is k4.  Returns (u3, k4)."""
    gamma = 0.5
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    W = eye / (dt[..., None] * gamma) - jac(u)             # (k, n, n)

    def solve(rhs):
        return torch.linalg.solve(W, rhs)

    f1 = f(u)
    k1 = solve(f1)
    k2 = solve(f1 + (4.0 / dt) * k1)
    f3 = f(u + 2.0 * k1)
    k3 = solve(f3 + (k1 - k2) / dt)
    f4 = f(u + 2.0 * k1 + k3)
    k4 = solve(f4 + (k1 - k2 - (8.0 / 3.0) * k3) / dt)
    return u + 2.0 * k1 + k3 + k4, k4


def _rodas3_step(f, jac, u, dt):
    return _rodas3_step_err(f, jac, u, dt)[0]


def _rodas3_tangent_step(f, jac, jv, d2, u, du, dt, ddt=None):
    """One RODAS3 step of the rows u (k, n) and its jvp for the tangents
    du (k, K, n) and the step's own tangent ddt ((k, K, 1); None means
    0).  Each stage k_i solves W k_i = r_i with W = I/(dt gamma) - J(u);
    its tangent solves W dk_i = dr_i - dc k_i + d2F(u)[du, k_i] with
    dc = -ddt/(dt^2 gamma) (the derivative of W applied to k_i).  One LU
    of W per step serves the stage and all K tangent columns.
    `d2(u, a, b)` is the model's second derivative d2F(u)[a, b] for a
    (k, K, n) and b (k, n).  Returns (u_new, du_new, k4), k4 the error
    estimate."""
    gamma = 0.5
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    LU, piv = torch.linalg.lu_factor(eye / (dt[..., None] * gamma) - jac(u))
    dtk = dt[..., None]                                    # (k, 1, 1)

    def stage(r, dr):
        """k = W^-1 r and dk = W^-1 (dr - dc k + d2F[du, k])."""
        k = torch.linalg.lu_solve(LU, piv, r[..., None])[..., 0]
        rhs = dr + d2(u, du, k)
        if ddt is not None:
            rhs = rhs + (ddt / (dtk * dtk * gamma)) * k[:, None, :]
        dk = torch.linalg.lu_solve(LU, piv, rhs.transpose(1, 2)
                                   ).transpose(1, 2)
        return k, dk

    def over_dt(x, dx):
        """x / dt and its tangent."""
        out = dx / dtk
        if ddt is not None:
            out = out - (ddt / (dtk * dtk)) * x[:, None, :]
        return x / dt, out

    f1, df1 = f(u), jv(u, du)
    k1, dk1 = stage(f1, df1)
    a, da = over_dt(4.0 * k1, 4.0 * dk1)
    k2, dk2 = stage(f1 + a, df1 + da)
    Y3, dY3 = u + 2.0 * k1, du + 2.0 * dk1
    a, da = over_dt(k1 - k2, dk1 - dk2)
    k3, dk3 = stage(f(Y3) + a, jv(Y3, dY3) + da)
    Y4, dY4 = Y3 + k3, dY3 + dk3
    a, da = over_dt(k1 - k2 - (8.0 / 3.0) * k3,
                    dk1 - dk2 - (8.0 / 3.0) * dk3)
    k4, dk4 = stage(f(Y4) + a, jv(Y4, dY4) + da)
    return Y4 + k4, dY4 + dk4, k4


def _get_step(method: str):
    steppers = {"dopri5": _dopri5_step, "rk4": _rk4_step,
                "rodas3": _rodas3_step}
    if method not in steppers:
        raise ValueError(f"unknown flow method '{method}' "
                         f"(available: {sorted(steppers)})")
    return steppers[method]


_ERR_STEPPERS = {"dopri5": (_dopri5_step_err, 5),
                 "rodas3": (_rodas3_step_err, 3)}


def _tangent_step(method, f, jac, jv, d2):
    """(u, du, dt, ddt) -> (u_new, du_new, err): a step of `method` with
    its jvp (the variational step) and its embedded error estimate (None
    for rk4)."""
    if method == "rodas3":
        return lambda u, du, dt, ddt: _rodas3_tangent_step(
            f, jac, jv, d2, u, du, dt, ddt)
    if method not in _EXPLICIT:
        _get_step(method)                          # raises: unknown method

    def step(u, du, dt, ddt):
        u_new, du_new, ks = _erk_step(f, u, dt, _EXPLICIT[method], jv, du,
                                      ddt)
        err = dt * _combo(_DOPRI5_ERR, ks + [f(u_new)]) \
            if method == "dopri5" else None
        return u_new, du_new, err

    return step


def _adaptive_integrate(method, f, jac, u0, T, rtol, atol, max_steps,
                        dt0=None, with_stats=False, tangent=None):
    """Error-controlled integration of the rows u0 (k, n) to times T
    (k, 1): a loop over at most `max_steps` iterations that accepts or
    rejects each lane's step (PI step control per lane) and leaves a lane
    unchanged once it reaches T (ref FlowDE.jl:41-99 for the semantics;
    rtol/atol are the reference's reltol/abstol).

    The step-size choice is detached (control flow, not solution); the
    derivative in T flows through the clipping dt_eff = min(dt, T - t)
    and the closing step onto t = T, so dphi/dT = F(phi).  Outside a
    `torch.func` transform the loop stops once every lane is done; the
    skipped iterations would change nothing.

    `tangent = (step_t, du0, dT)` carries K tangent columns du0
    (k, K, n) and dT ((k, K, 1) or None) through the same steps with the
    variational step `step_t` (`_tangent_step`): the jvp of this loop,
    the clipped steps' dependence on T included.  Returns u (and du)."""
    if method not in _ERR_STEPPERS:
        raise ValueError(f"adaptive flow needs an embedded-pair method "
                         f"(got '{method}'; available: "
                         f"{sorted(_ERR_STEPPERS)})")
    step_err, order = _ERR_STEPPERS[method]
    tiny = 1e-12
    absT = torch.abs(T)
    if dt0 is None:
        # Hairer's starting step: h0 = 0.01 ||y0||_sc / ||f0||_sc
        sc0 = atol + rtol * torch.abs(u0)
        d0 = torch.sqrt(torch.mean((u0 / sc0) ** 2, -1, keepdim=True))
        d1 = torch.sqrt(torch.mean((f(u0) / sc0) ** 2, -1, keepdim=True))
        dt = 0.01 * torch.clamp_min(d0, 1e-6) / torch.clamp_min(d1, 1e-6)
        dt = torch.minimum(torch.maximum(dt, tiny * absT), T / 2.0).detach()
    else:
        dt = torch.full_like(T, float(dt0)).detach()
    u = u0
    t = torch.zeros_like(T)
    errprev = torch.ones_like(T).detach()
    done = torch.zeros(T.shape, dtype=torch.bool, device=T.device)
    nacc = torch.zeros(T.shape, dtype=torch.long, device=T.device)
    nrej = torch.zeros_like(nacc)
    if tangent is not None:
        step_t, du, dT = tangent
        if dT is None:
            dT = torch.zeros_like(du[..., :1])
        t_tan = torch.zeros_like(dT)
        floor_tan = (tiny * torch.sign(T))[:, None] * dT

    def clipped(dt, t, t_tan=None):
        """max(min(dt, T - t), tiny |T|) and its tangent."""
        rem = T - t
        dte = torch.maximum(torch.minimum(dt, rem), tiny * absT)
        if t_tan is None:
            return dte, None
        tan = torch.where((rem < dt)[:, None], dT - t_tan,
                          torch.zeros_like(t_tan))
        return dte, torch.where((dte == tiny * absT)[:, None], floor_tan,
                                tan)

    stop_early = not autodiff_active()
    for _ in range(max_steps):
        dt_eff, ddt = clipped(dt, t, t_tan if tangent is not None else None)
        if tangent is None:
            u_new, err = step_err(f, jac, u, dt_eff)
        else:
            u_new, du_new, err = step_t(u, du, dt_eff, ddt)
        sc = atol + rtol * torch.maximum(torch.abs(u), torch.abs(u_new))
        en = torch.clamp_min(torch.sqrt(torch.mean(
            (err / sc) ** 2, -1, keepdim=True)), 1e-16).detach()
        accept = en <= 1.0
        # PI controller (Gustafsson): fac = 0.9 e^{-0.7/k} e_prev^{0.4/k}
        fac = torch.clamp(0.9 * en ** (-0.7 / order)
                          * errprev ** (0.4 / order), 0.2, 5.0)
        dt_next = dt_eff.detach() * fac
        upd = accept & ~done
        u = torch.where(upd, u_new, u)
        if tangent is not None:
            du = torch.where(upd[:, None], du_new, du)
            t_tan = torch.where(upd[:, None], t_tan + ddt, t_tan)
        t_out = torch.where(upd, t + dt_eff, t)
        errprev = torch.where(upd, en, errprev)
        nacc = nacc + upd.long()
        nrej = nrej + (~accept & ~done).long()
        dt = torch.where(done, dt, dt_next)
        done = done | (t_out.detach() >= T.detach() * (1.0 - 1e-12))
        t = t_out
        if stop_early and bool(done.all()):
            break
    # unconditional closing step over the remaining time: it lands on
    # t = T (so dphi/dT flows through `rem`); if the budget ran out, one
    # big step approximates the state at T (`reached` in the stats says so)
    rem = torch.maximum(T - t, tiny * absT)
    if tangent is not None:
        rem_tan = torch.where((rem == tiny * absT)[:, None], floor_tan,
                              dT - t_tan)
        return step_t(u, du, rem, rem_tan)[:2]
    u = _get_step(method)(f, jac, u, rem)
    if with_stats:
        return u, {"n_accepted": nacc[:, 0], "n_rejected": nrej[:, 0],
                   "t_final": t[:, 0], "reached": done[:, 0]}
    return u


@dataclasses.dataclass(frozen=True)
class Flow:
    """Flow phi(u0, T) of u' = F(u, params), differentiable in
    (u0, T, params).  u0 is a state (n,) or a batch of states (k, n), T a
    time or one per state.

    Fixed-step mode (default): `steps` integration steps whatever T.
    Adaptive mode (`adaptive=True`): embedded-pair error control to the
    user's (rtol, atol) with PI step-size selection, at most `max_steps`
    steps (ref src/periodicorbit/FlowDE.jl:41-99); it needs T > 0 and
    dopri5 or rodas3.

    `batched=True` says F (and `jac_op`) take a leading batch of states;
    otherwise a batch goes through `torch.func.vmap`.  `jac_op(u, params)
    -> (v -> J v)` is the model's J.v (v of shape (n,) or (K, n)): with
    it, `jvp` integrates the variational equation, and rodas3 builds its
    jacobians from it; rodas3's variational step also needs d2F, the
    model's `d2F(u, params, a, b)` if given, else the jvp of its J.v."""

    F: Callable
    steps: int = 100
    method: str = "dopri5"
    adaptive: bool = False
    rtol: float = 1e-7
    atol: float = 1e-9
    max_steps: int = 256
    jac_op: Optional[Callable] = None
    d2F: Optional[Callable] = None
    batched: bool = False

    # --- the vector field on rows ---------------------------------------
    def _rhs(self, params):
        F = self.F
        if self.batched:
            return lambda U: F(U, params)

        def f(U):
            if U.shape[0] == 1:
                return F(U[0], params)[None]
            return vmap(lambda x: F(x, params))(U)

        return f

    def _jv(self, params):
        """(U (k, n), V (k, K, n)) -> J(U_i) V_i through `jac_op`: one
        call for a batched model, one per state otherwise (each a block of
        K columns)."""
        op = self.jac_op
        if self.batched:
            return lambda U, V: op(U[:, None, :], params)(V)
        return lambda U, V: torch.stack([op(x, params)(v)
                                         for x, v in zip(U, V)])

    def _jac(self, params):
        """U (k, n) -> the jacobians (k, n, n): J.v on the identity, or a
        vmapped jacfwd of F."""
        if self.jac_op is not None:
            jv = self._jv(params)

            def jac(U):
                eye = torch.eye(U.shape[1], dtype=U.dtype, device=U.device)
                return jv(U, eye.expand(U.shape[0], -1, -1)).transpose(-1,
                                                                       -2)
            return jac
        F = self.F
        return vmap(jacfwd(lambda x: F(x, params)))

    def _d2(self, params):
        """(U (k, n), A (k, K, n), b (k, n)) -> d2F(U_i)[A_i, b_i]: the
        model's d2F, or the jvp of J(x) A in the direction b (d2F is
        symmetric), one for all K columns."""
        if self.d2F is not None:
            d2F = self.d2F
            if self.batched:
                return lambda U, A, b: d2F(U[:, None, :], params, A,
                                           b[:, None, :])
            return lambda U, A, b: torch.stack([
                torch.stack([d2F(x, params, a, bb) for a in Ai])
                for x, Ai, bb in zip(U, A, b)])
        jv = self._jv(params)
        return lambda U, A, b: jvp(lambda x: jv(x, A), (U,), (b,))[1]

    @property
    def variational(self) -> bool:
        """Whether `jvp` integrates the variational equation (a model
        J.v is given)."""
        return self.jac_op is not None

    # --- integration -----------------------------------------------------
    def _integrate(self, U, params, T, with_stats=False):
        """Rows U (k, n) to times T (k, 1) or (1, 1)."""
        f, jac = self._rhs(params), self._jac(params)
        if self.adaptive:
            return _adaptive_integrate(
                self.method, f, jac, U, T.expand(U.shape[0], 1), self.rtol,
                self.atol, self.max_steps, with_stats=with_stats)
        step = _get_step(self.method)
        dt = T / self.steps
        for _ in range(self.steps):
            U = step(f, jac, U, dt)
        if with_stats:
            return U, {"n_accepted": self.steps, "n_rejected": 0}
        return U

    def __call__(self, u0, params, T):
        U = u0 if u0.dim() == 2 else u0[None]
        out = self._integrate(U, params, _lanes(T, U))
        return out if u0.dim() == 2 else out[0]

    def solve_stats(self, u0, params, T):
        """(u(T), stats) with the accepted/rejected step counts, the final
        time and whether T was reached (per state for a batch)."""
        U = u0 if u0.dim() == 2 else u0[None]
        out, stats = self._integrate(U, params, _lanes(T, U),
                                     with_stats=True)
        if u0.dim() == 2 or not self.adaptive:
            return (out if u0.dim() == 2 else out[0]), stats
        return out[0], {k: v[0] for k, v in stats.items()}

    def trajectory(self, u0, params, T, n_save: int):
        """Orbit samples at n_save+1 equispaced times in [0, T]."""
        sub = self.steps // n_save
        step = _get_step(self.method)
        f, jac = self._rhs(params), self._jac(params)
        U = u0[None]
        dt = _lanes(T, U) / (sub * n_save)
        path = [U]
        for _ in range(n_save):
            for _ in range(sub):
                U = step(f, jac, U, dt)
            path.append(U)
        return torch.cat(path)

    def jvp(self, u0, params, T, du0, dT=None):
        """(phi(u0, T), dphi(u0, T)[du0, dT]) for K tangent columns: u0
        (n,) with du0 (K, n), or a batch u0 (k, n) with du0 (k, K, n); T
        a time or one per state; dT None (0) or the tangent of T per column,
        (K,) or (k, K)."""
        single = u0.dim() == 1
        U = u0[None] if single else u0
        dU = du0[None] if single else du0
        Tl = _lanes(T, U)
        dTl = None
        if dT is not None:
            dTl = torch.as_tensor(dT, dtype=U.dtype, device=U.device)
            dTl = dTl.reshape((1,) * (3 - dTl.dim() - 1) + dTl.shape + (1,))
        if self.variational:
            f, jac = self._rhs(params), self._jac(params)
            step_t = _tangent_step(self.method, f, jac, self._jv(params),
                                   self._d2(params))
            if dTl is not None:
                dTl = dTl.expand(U.shape[0], dU.shape[1], 1)
            if self.adaptive:
                out, dout = _adaptive_integrate(
                    self.method, f, jac, U, Tl.expand(U.shape[0], 1),
                    self.rtol, self.atol, self.max_steps,
                    tangent=(step_t, dU, dTl))
            else:
                dt = Tl / self.steps
                ddt = None if dTl is None else dTl / self.steps
                for _ in range(self.steps):
                    U, dU, _ = step_t(U, dU, dt, ddt)
                out, dout = U, dU
        else:
            if dTl is None:
                dTl = torch.zeros((1, 1, 1), dtype=U.dtype, device=U.device)
            dTl = dTl.expand(Tl.shape[0], dU.shape[1], 1)

            def cols(d, dt_):
                return jvp(lambda x, t: self._integrate(x, params, t),
                           (U, Tl.expand(dt_.shape)), (d, dt_))[1]

            out = self._integrate(U, params, Tl)
            dout = vmap(cols, in_dims=(1, 1), out_dims=1)(dU, dTl)
        return (out[0], dout[0]) if single else (out, dout)

    def monodromy(self, u0, params, T):
        """d phi / d u0, (n, n) for a state or (k, n, n) for a batch: the
        variational flow (or forward AD through the integrator) on the
        identity's columns (ref Floquet.jl:89-109)."""
        U = u0 if u0.dim() == 2 else u0[None]
        eye = torch.eye(U.shape[1], dtype=U.dtype, device=U.device)
        _, D = self.jvp(U, params, T, eye.expand(U.shape[0], -1, -1))
        M = D.transpose(-1, -2)
        return M if u0.dim() == 2 else M[0]


def _lanes(T, U):
    """T as a (k, 1) or (1, 1) tensor beside the rows U (k, n)."""
    if not isinstance(T, torch.Tensor):
        T = torch.tensor(T, dtype=U.dtype, device=U.device)
    return T.reshape(-1, 1)
