"""Small equilibrium models — the port of the parts of
`jl_tpu/models/equilibria.py` the port runs (ref examples/*.jl, test
fixtures): the Chan BVP (finite differences and Chebyshev collocation) and the
Carrier BVP, the scalar transcritical and pitchfork normal forms, the
planar Hopf normal form, the Stuart-Landau oscillator, the 1D
Brusselator, the Lorenz-84 model, the 2D complex Ginzburg-Landau
equation, the CO-oxidation and Tsodyks-Markram models, the Lur'e and
Freire oscillators (the periodic-orbit codim-2 fixtures), the two PDE
models with exact codim-2 geometry (`fold_hopf_interaction_2d`,
`bogdanov_takens_2d`) and the BVAM period-doubling PDE (`bvam_1d`), whose
J.v applies their Neumann Laplacian through the DIA kernel, and the
quintic 1D Swift-Hohenberg model of the snaking example
(`swift_hohenberg_1d`).

The Stuart-Landau and cGL2d residuals and their closed-form J.v take a
leading batch of states natively (`batched_F`), so a periodic orbit's M
time slices go through F in one call (forward AD through F costs a
Python decomposition per op that mixes a dual tensor with a plain one,
so these models ship J.v as `jac_op`).

Each takes `device=` (None means the card, which raises where there is
none; pass `device="cpu"` to run on the CPU) and `dtype=`; the state and
the parameters (0-d tensors) are made there.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import DEFAULT_DTYPE, resolve_device
from ..core.problem import BifurcationProblem
from ..ops.dia_spmv import dia_spmv


def _params(values: dict, dtype, dev) -> dict:
    return {k: torch.tensor(v, dtype=dtype, device=dev)
            for k, v in values.items()}


def chan(n: int = 101, alpha: float = 3.3, beta: float = 0.01, device=None,
         dtype: torch.dtype = DEFAULT_DTYPE):
    """1D Chan BVP (ref examples/chan.jl:10-23): Dirichlet BCs u(0)=u(1)=beta,
    interior (u[i-1] - 2u[i] + u[i+1])(n-1)^2 + alpha*Nl(u[i], b=beta) with
    Nl(x) = 1 + (x + a x^2)/(1 + b x^2), a = 0.5.  Fold near alpha ~ 3.32."""
    dev = resolve_device(device)

    def Nl(x, b, a=0.5):
        return 1.0 + (x + a * x ** 2) / (1.0 + b * x ** 2)

    def F(u, par):
        a, b = par["alpha"], par["beta"]
        interior = (u[:-2] - 2 * u[1:-1] + u[2:]) * (n - 1) ** 2 \
            + a * Nl(u[1:-1], b)
        return torch.cat([u[:1] - b, interior, u[-1:] - b])

    i = np.arange(1, n + 1)
    u0 = torch.as_tensor((i - 1) * (n - i) / n ** 2 + 0.1, dtype=dtype,
                         device=dev)
    return BifurcationProblem(
        F, u0=u0, params=_params({"alpha": alpha, "beta": beta}, dtype, dev),
        lens="alpha")


def chan_spectral(N: int = 31, alpha: float = 3.3, beta: float = 0.01,
                  device=None, dtype: torch.dtype = DEFAULT_DTYPE):
    """Chan BVP discretized by Chebyshev collocation (the analog of the
    reference's ApproxFun variant, ref examples/chan-af.jl): u'' + alpha *
    Nl(u, b) = 0 on [0, 1], u(0) = u(1) = beta, with the dense spectral
    differentiation matrix replacing the FD stencil.  Same continuum folds
    as `chan` at far fewer dofs."""
    dev = resolve_device(device)
    # Chebyshev points and differentiation matrix on [-1, 1] (Trefethen)
    j = np.arange(N + 1)
    xc = np.cos(np.pi * j / N)
    c = np.r_[2.0, np.ones(N - 1), 2.0] * (-1.0) ** j
    Xm = np.tile(xc[:, None], (1, N + 1))
    dX = Xm - Xm.T
    D = np.outer(c, 1.0 / c) / (dX + np.eye(N + 1))
    D -= np.diag(D.sum(axis=1))
    # map [-1,1] -> [0,1]: x = (1 - xc)/2, d/dx = -2 d/dxc
    D = -2.0 * D
    D2 = torch.as_tensor(D @ D, dtype=dtype, device=dev)
    ends = torch.tensor([0, N], device=dev)

    def Nl(x, b, a=0.5):
        return 1.0 + (x + a * x ** 2) / (1.0 + b * x ** 2)

    def F(u, par):
        a, b = par["alpha"], par["beta"]
        r = D2 @ u + a * Nl(u, b)
        # the boundary rows, copied into a new tensor (torch.func
        # differentiates an out-of-place index copy)
        return r.index_copy(0, ends, u[ends] - b)

    x01 = (1.0 - xc) / 2.0
    u0 = torch.as_tensor(x01 * (1 - x01) + 0.1, dtype=dtype, device=dev)
    return BifurcationProblem(
        F, u0=u0, params=_params({"alpha": alpha, "beta": beta}, dtype, dev),
        lens="alpha")


def carrier(N: int = 200, eps: float = 0.7, device=None,
            dtype: torch.dtype = DEFAULT_DTYPE):
    """Carrier singular-perturbation BVP (ref examples/carrier.jl:7-43):
    eps^2 u'' + 2(1 - x^2) u + u^2 = 1 on (-1, 1), u(+-1) = 0, continued
    in eps.  Ships the analytic tridiagonal jacobian (the reference's
    BandedMatrix Jac_carr) to exercise the user-J path."""
    dev = resolve_device(device)
    X = np.linspace(-1.0, 1.0, N)
    dx = X[1] - X[0]
    Xj = torch.as_tensor(X, dtype=dtype, device=dev)

    def F(u, par):
        e = par["eps"]
        upp = (torch.roll(u, 1) - 2 * u + torch.roll(u, -1)) / dx ** 2
        f = e ** 2 * upp + 2 * (1 - Xj ** 2) * u + u ** 2 - 1.0
        # Dirichlet rows overwrite the wrapped stencil contributions
        return torch.cat([u[:1], f[1:-1], u[-1:]])

    def jac(u, par):
        e = par["eps"]
        c = e ** 2 / dx ** 2
        main = -2.0 * c + 2 * (1 - Xj ** 2) + 2 * u
        eye = torch.ones(N - 1, dtype=u.dtype, device=u.device)
        J = (torch.diag(main) + c * torch.diag(eye, 1)
             + c * torch.diag(eye, -1))
        J[0, :] = 0.0
        J[0, 0] = 1.0
        J[-1, :] = 0.0
        J[-1, -1] = 1.0
        return J

    def record(u, p, **k):
        return {"param": p, "s": dx * torch.sum(u ** 2),
                "norminf": torch.max(torch.abs(u))}

    return BifurcationProblem(F, u0=torch.zeros(N, dtype=dtype, device=dev),
                              params=_params({"eps": eps}, dtype, dev),
                              lens="eps", jac=jac,
                              record_from_solution=record)


def transcritical_1d(p: float = -0.5, device=None,
                     dtype: torch.dtype = DEFAULT_DTYPE):
    """F(u, p) = p*u - u^2: transcritical branch point at (0, 0)."""
    dev = resolve_device(device)

    def F(u, par):
        return par["p"] * u - u ** 2

    return BifurcationProblem(F, u0=torch.zeros(1, dtype=dtype, device=dev),
                              params=_params({"p": p}, dtype, dev), lens="p")


def pitchfork_1d(p: float = -0.5, device=None,
                 dtype: torch.dtype = DEFAULT_DTYPE):
    """F(u, p) = p*u - u^3: supercritical pitchfork at (0, 0)."""
    dev = resolve_device(device)

    def F(u, par):
        return par["p"] * u - u ** 3

    return BifurcationProblem(F, u0=torch.zeros(1, dtype=dtype, device=dev),
                              params=_params({"p": p}, dtype, dev), lens="p")


def hopf_normal_2d(p: float = -0.5, omega: float = 1.0, l1: float = -1.0,
                   device=None, dtype: torch.dtype = DEFAULT_DTYPE):
    """Planar Hopf normal form: z' = (p + i omega) z + l1 z |z|^2.
    Hopf bifurcation at p = 0 with frequency `omega`."""
    dev = resolve_device(device)

    def F(u, par):
        x, y = u[0], u[1]
        mu = par["p"]
        r2 = x * x + y * y
        return torch.stack([mu * x - omega * y + l1 * x * r2,
                            omega * x + mu * y + l1 * y * r2])

    return BifurcationProblem(F, u0=torch.zeros(2, dtype=dtype, device=dev),
                              params=_params({"p": p}, dtype, dev), lens="p")


def _batched(prob):
    """Mark a problem whose F takes a leading batch of states."""
    object.__setattr__(prob, "batched_F", True)
    return prob


def stuart_landau(r: float = 0.5, mu: float = 0.1, nu: float = 1.0,
                  c3: float = 1.0, c5: float = 0.0, device=None,
                  dtype: torch.dtype = DEFAULT_DTYPE):
    """Stuart-Landau oscillator in real coordinates
    (ref test/periodic_orbits_function_fd/stuartLandau*.jl):
    z' = (r + i mu) z - (1 + i nu) c3 |z|^2 z - c5 |z|^4 z.  F and its
    closed-form J.v (`jac_op`) take a leading batch of states (..., 2)."""
    dev = resolve_device(device)

    def F(u, par):
        x, y = u[..., 0], u[..., 1]
        rr, m, n_ = par["r"], par["mu"], par["nu"]
        cc3, cc5 = par["c3"], par["c5"]
        ua = x * x + y * y
        fre = (rr * x - m * y) - cc3 * ua * (x - n_ * y) - cc5 * ua ** 2 * x
        fim = (rr * y + m * x) - cc3 * ua * (y + n_ * x) - cc5 * ua ** 2 * y
        return torch.stack([fre, fim], dim=-1)

    def jac_op(u, par):
        """J(u) v in closed form; u and v batches broadcast."""
        x, y = u[..., 0], u[..., 1]
        rr, m, n_ = par["r"], par["mu"], par["nu"]
        cc3, cc5 = par["c3"], par["c5"]
        ua = x * x + y * y

        def op(v):
            dx, dy = v[..., 0], v[..., 1]
            dua = 2 * (x * dx + y * dy)
            dre = (rr * dx - m * dy
                   - cc3 * (dua * (x - n_ * y) + ua * (dx - n_ * dy))
                   - cc5 * ua * (2 * dua * x + ua * dx))
            dim = (rr * dy + m * dx
                   - cc3 * (dua * (y + n_ * x) + ua * (dy + n_ * dx))
                   - cc5 * ua * (2 * dua * y + ua * dy))
            return torch.stack([dre, dim], dim=-1)

        return op

    return _batched(BifurcationProblem(
        F, u0=torch.tensor([0.01, 0.01], dtype=dtype, device=dev),
        params=_params({"r": r, "mu": mu, "nu": nu, "c3": c3, "c5": c5},
                       dtype, dev), lens="r", jac_op=jac_op))


def _brusselator_terms(B: int, h: float, halo: Callable = None):
    """F, the closed-form J.v and dF/dl of the 1D Brusselator on B sites
    whose state is the flat [u; v] (a leading batch broadcasts), and the
    closed-form hooks (d2F, and what the matrix-free codim-2 layer
    otherwise takes by AD: J^T.v, the pairing gradient, dF/dp and
    d(J.v)/dp for the lenses l and beta; `parallel/models.py`).  The
    second difference of the stacked (..., 2, B) species takes its sites
    past each end from `halo(x)` -> (previous, next), each (..., 2, 1) or
    None; None (and `halo=None`, the whole domain on one device) puts the
    Dirichlet values there (zero for J.v).  `parallel/models.py` passes
    the neighbouring ranks' sites."""

    def lap(uv, edge):
        x = torch.stack([uv[..., :B], uv[..., B:]], dim=-2)
        prev, nxt = (None, None) if halo is None else halo(x)
        e = (x.new_zeros(x.shape[:-1] + (1,)) if edge is None
             else edge.expand(x.shape[:-1] + (1,)))
        ext = torch.cat([e if prev is None else prev, x,
                         e if nxt is None else nxt], -1)
        return ext[..., :-2] - 2 * ext[..., 1:-1] + ext[..., 2:]

    def coefs(par):
        ll = par["l"]
        return (par["D1"] / (ll ** 2 * h ** 2),
                par["D2"] / (ll ** 2 * h ** 2))

    def edges(par):
        a = par["alpha"]
        return torch.stack([a, par["beta"] / a]).reshape(2, 1)

    def F(uv, par):
        a, b = par["alpha"], par["beta"]
        c1, c2 = coefs(par)
        L = lap(uv, edges(par))
        u, v = uv[..., :B], uv[..., B:]
        fu = c1 * L[..., 0, :] + a - (b + 1) * u + u * u * v
        fv = c2 * L[..., 1, :] + b * u - u * u * v
        return torch.cat([fu, fv], -1)

    def jac_op(uv, par):
        """J(uv) w: the second difference of the direction with zero past
        the domain's ends (the boundary values are constants) and the
        reaction terms' derivative."""
        b = par["beta"]
        c1, c2 = coefs(par)
        u, v = uv[..., :B], uv[..., B:]
        uv2, uu = 2 * u * v, u * u

        def op(w):
            L = lap(w, None)
            du, dv = w[..., :B], w[..., B:]
            fu = c1 * L[..., 0, :] - (b + 1) * du + uv2 * du + uu * dv
            fv = c2 * L[..., 1, :] + b * du - uv2 * du - uu * dv
            return torch.cat([fu, fv], -1)

        return op

    def dFdp(uv, par):
        """dF/dl: only the diffusion coefficients D / (l h)^2 depend on l."""
        c1, c2 = coefs(par)
        L = lap(uv, edges(par))
        k = -2.0 / par["l"]
        return torch.cat([k * c1 * L[..., 0, :], k * c2 * L[..., 1, :]], -1)

    def jac_adjoint(uv, par):
        """J(uv)^T w: the second difference is symmetric, the reaction
        block transposed per site."""
        b = par["beta"]
        c1, c2 = coefs(par)
        u, v = uv[..., :B], uv[..., B:]
        uv2, uu = 2 * u * v, u * u

        def op(w):
            L = lap(w, None)
            wu, wv = w[..., :B], w[..., B:]
            gu = c1 * L[..., 0, :] + (uv2 - (b + 1)) * wu + (b - uv2) * wv
            gv = c2 * L[..., 1, :] + uu * (wu - wv)
            return torch.cat([gu, gv], -1)

        return op

    def grad_pairing(uv, par, vs, ws):
        """grad_uv sum_k <w_k, J(uv) v_k>: only the reaction term u^2 v
        depends on the state, site by site (no halo)."""
        u, v = uv[..., :B], uv[..., B:]
        gu = torch.zeros_like(u)
        gv = torch.zeros_like(v)
        for d, w in zip(vs, ws):
            q = w[..., :B] - w[..., B:]
            du, dv = d[..., :B], d[..., B:]
            gu = gu + q * 2 * (v * du + u * dv)
            gv = gv + q * 2 * u * du
        return torch.cat([gu, gv], -1)

    def dJv_dl(uv, par, w):
        c1, c2 = coefs(par)
        L = lap(w, None)
        k = -2.0 / par["l"]
        return torch.cat([k * c1 * L[..., 0, :], k * c2 * L[..., 1, :]], -1)

    def dF_dbeta(uv, par):
        """dF/dbeta: the reaction's -u and u, and the v boundary value
        beta / alpha entering the end sites' second difference."""
        c2 = coefs(par)[1]
        u = uv[..., :B]
        e = torch.stack([torch.zeros_like(par["alpha"]),
                         1.0 / par["alpha"]]).reshape(2, 1)
        Le = lap(torch.zeros_like(uv), e)
        return torch.cat([-u, u + c2 * Le[..., 1, :]], -1)

    def dJv_dbeta(uv, par, w):
        du = w[..., :B]
        return torch.cat([-du, du], -1)

    def d2F(uv, par, a, b):
        """d2F(uv)[a, b] in closed form: only the cubic reaction term
        u^2 v is nonlinear; batches broadcast."""
        u, v = uv[..., :B], uv[..., B:]
        au, av, bu, bv = a[..., :B], a[..., B:], b[..., :B], b[..., B:]
        q = 2 * v * au * bu + 2 * u * (au * bv + av * bu)
        return torch.cat([q, -q], -1)

    hooks = {"d2F": d2F, "jac_adjoint": jac_adjoint,
             "grad_pairing": grad_pairing,
             "param_derivs": {"l": (dFdp, dJv_dl),
                              "beta": (dF_dbeta, dJv_dbeta)}}
    return F, jac_op, dFdp, hooks


def brusselator_1d(n: int = 100, alpha: float = 2.0, beta: float = 5.45,
                   D1: float = 0.008, D2: float = 0.004, l: float = 0.3,
                   device=None, dtype: torch.dtype = DEFAULT_DTYPE,
                   batched: bool = False):
    """1D Brusselator reaction-diffusion (ref examples/brusselator.jl:26-49,
    par at :93): Dirichlet BCs u=alpha, v=beta/alpha at both ends, h = 1/n,
    continued in the domain length `l`; Hopf bifurcations along the branch.
    The state is the stacked (u, v) of length 2n.  `batched=True` marks F
    as taking a leading batch of states and adds its closed-form J.v
    (`jac_op`) and d2F (`d2F_user`), state and direction batches
    broadcasting, which the periodic orbits' batched and variational
    routes use; by default the problem has none of them."""
    dev = resolve_device(device)
    F, jac_op, _, hooks = _brusselator_terms(n, 1.0 / n)
    u0 = torch.cat([torch.full((n,), alpha, dtype=dtype, device=dev),
                    torch.full((n,), beta / alpha, dtype=dtype, device=dev)])
    params = _params({"alpha": alpha, "beta": beta, "D1": D1, "D2": D2,
                      "l": l}, dtype, dev)

    if not batched:
        return BifurcationProblem(F, u0=u0, params=params, lens="l")
    return _batched(BifurcationProblem(F, u0=u0, params=params, lens="l",
                                       jac_op=jac_op,
                                       d2F_user=hooks["d2F"]))


def lorenz84(params=None, device=None, dtype: torch.dtype = DEFAULT_DTYPE):
    """Lorenz-84 atmospheric model (ref test/hopf_codim_2/lorenz84.jl):
    rich codim-2 structure (BT, ZH, HH on fold/Hopf curves), continued in
    `F`."""
    dev = resolve_device(device)
    if params is None:
        params = {"a": 0.25, "b": 4.0, "G": 0.25, "F": 1.0}

    def F(u, par):
        X, Y, Z, U = u[0], u[1], u[2], u[3]
        a, b, G, Ff = par["a"], par["b"], par["G"], par["F"]
        return torch.stack([
            -Y ** 2 - Z ** 2 - a * X + a * Ff - G * U ** 2,
            X * Y - b * X * Z - Y + G,
            b * X * Y + X * Z - Z,
            -G * U + G * X * U,
        ])

    # converges to the U = 0 equilibrium branch (X ~ 0.984 at F = 1)
    u0 = torch.tensor([1.2, 0.2, 0.1, 0.0], dtype=dtype, device=dev)
    return BifurcationProblem(F, u0=u0, params=_params(params, dtype, dev),
                              lens="F")


def _lap_dirichlet_2d(u, hx2, hy2):
    """5-point Laplacian over the last two axes with homogeneous Dirichlet
    closure (zero-padded; ref examples/cGL2d.jl:6-22: plain -2 diagonal at
    the corners)."""
    zx = torch.zeros_like(u[..., :1, :])
    zy = torch.zeros_like(u[..., :1])
    # shifted copies by concatenation (forward AD of `pad` runs a slow
    # Python decomposition)
    ux = torch.cat([zx, u[..., :-1, :]], -2) + torch.cat([u[..., 1:, :], zx],
                                                         -2)
    uy = torch.cat([zy, u[..., :-1]], -1) + torch.cat([u[..., 1:], zy], -1)
    return (ux - 2 * u) / hx2 + (uy - 2 * u) / hy2


def dst1(u: torch.Tensor, dim: int) -> torch.Tensor:
    """DST-I along `dim` through the FFT of the odd extension (length
    2n+2): the transform that diagonalizes the Dirichlet second difference.
    It computes in the input's dtype (f32 in, complex64 FFT)."""
    n = u.shape[dim]
    z = torch.zeros_like(u.narrow(dim, 0, 1))
    y = torch.cat([z, u, z, -torch.flip(u, [dim])], dim=dim)
    return -torch.imag(torch.fft.fft(y, dim=dim).narrow(dim, 1, n)) / 2.0


def cgl2d(Nx: int = 41, Ny: int = 21, lx: float = np.pi,
          ly: float = np.pi / 2, r: float = 0.5, mu: float = 0.1,
          nu: float = 1.0, c3: float = -1.0, c5: float = 1.0,
          gamma: float = 0.0, device=None,
          dtype: torch.dtype = DEFAULT_DTYPE):
    """2D complex Ginzburg-Landau in real components (ref examples/cGL2d.jl:
    25-86): state (2, Nx, Ny) fields (u1, u2), Dirichlet Laplacian, Hopf
    bifurcations in r followed by periodic orbits.  F and its closed-form
    J.v (`jac_op`) take a leading batch of states (..., 2, Nx, Ny).

    The problem carries `spectral_precond(v, shift=0.0)`, the exact
    (Delta - shift)^-1 per component in the 2D DST-I basis (f32 only for
    an f32 input), and `po_spectral_data(r0)`, the per-mode frozen
    linearization for the trapeze space-time preconditioner
    (`Trapeze.spectral_precond`)."""
    dev = resolve_device(device)
    hx = 2 * lx / Nx
    hy = 2 * ly / Ny
    hx2, hy2 = hx * hx, hy * hy
    n = 2 * Nx * Ny

    def F(u, par):
        u1, u2 = u[..., 0, :, :], u[..., 1, :, :]
        rr, m, n_ = par["r"], par["mu"], par["nu"]
        cc3, cc5, g = par["c3"], par["c5"], par["gamma"]
        ua = u1 * u1 + u2 * u2
        f1 = (_lap_dirichlet_2d(u1, hx2, hy2) + rr * u1 - n_ * u2
              - ua * (cc3 * u1 - m * u2) - cc5 * ua ** 2 * u1 + g)
        f2 = (_lap_dirichlet_2d(u2, hx2, hy2) + rr * u2 + n_ * u1
              - ua * (cc3 * u2 + m * u1) - cc5 * ua ** 2 * u2)
        return torch.stack([f1, f2], dim=-3)

    def jac_op(u, par):
        """J(u) v in closed form, for u and v of the state's shape or
        batches of it that broadcast (forward AD through F costs a Python
        decomposition per op that mixes a dual tensor with a plain one)."""
        u1, u2 = u[..., 0, :, :], u[..., 1, :, :]
        rr, m, n_ = par["r"], par["mu"], par["nu"]
        cc3, cc5 = par["c3"], par["c5"]
        ua = u1 * u1 + u2 * u2
        g1 = cc3 * u1 - m * u2
        g2 = cc3 * u2 + m * u1

        def op(v):
            v1, v2 = v[..., 0, :, :], v[..., 1, :, :]
            dua = 2 * (u1 * v1 + u2 * v2)
            d1 = (_lap_dirichlet_2d(v1, hx2, hy2) + rr * v1 - n_ * v2
                  - dua * g1 - ua * (cc3 * v1 - m * v2)
                  - cc5 * ua * (2 * dua * u1 + ua * v1))
            d2 = (_lap_dirichlet_2d(v2, hx2, hy2) + rr * v2 + n_ * v1
                  - dua * g2 - ua * (cc3 * v2 + m * v1)
                  - cc5 * ua * (2 * dua * u2 + ua * v2))
            return torch.stack([d1, d2], dim=-3)

        return op

    values = {"r": r, "mu": mu, "nu": nu, "c3": c3, "c5": c5,
              "gamma": gamma}
    prob = _batched(BifurcationProblem(
        F, u0=torch.zeros((2, Nx, Ny), dtype=dtype, device=dev),
        params=_params(values, dtype, dev), lens="r", jac_op=jac_op,
        record_from_solution=lambda x, p, **k: {
            "param": p, "norm": torch.linalg.vector_norm(x.reshape(-1)),
            "norminf": torch.max(torch.abs(x))}))

    # DST-I eigenvalues of the zero-padded Dirichlet second difference
    mu_x = 2.0 * (np.cos(np.pi * np.arange(1, Nx + 1) / (Nx + 1)) - 1) / hx2
    mu_y = 2.0 * (np.cos(np.pi * np.arange(1, Ny + 1) / (Ny + 1)) - 1) / hy2
    sym_np = mu_x[:, None] + mu_y[None, :]
    sym = {dt: torch.as_tensor(sym_np, dtype=dt, device=dev)
           for dt in (torch.float64, torch.float32)}
    scale = 4.0 / ((Nx + 1) * (Ny + 1))

    def dst2(x):
        return dst1(dst1(x, -2), -1)

    def precond(v, shift=0.0):
        """(Delta - shift)^-1 per component, on a state, a flat vector or a
        batch of either."""
        x = v.reshape(-1, 2, Nx, Ny)
        t = dst2(x) / (sym[x.dtype] - shift)
        return (dst2(t) * scale).reshape(v.shape)

    object.__setattr__(prob, "spectral_precond", precond)

    def po_spectral_data(r0: float):
        """(sym_blocks, to_modes, from_modes) for `Trapeze.spectral_precond`:
        per DST mode k the frozen cGL linearization
        [[lam_k + r0, -nu], [nu, lam_k + r0]] (the stand-in for the
        reference's ILU on the cGL2d PO jacobian, ref
        examples/cGL2d.jl:211-213).  `to_modes` maps flat slices (..., n)
        to (..., K, 2) mode pairs, `from_modes` back; both in the input's
        dtype."""
        lam = sym_np.reshape(-1)
        blocks = np.zeros((lam.shape[0], 2, 2))
        blocks[:, 0, 0] = lam + r0
        blocks[:, 1, 1] = lam + r0
        blocks[:, 0, 1] = -values["nu"]
        blocks[:, 1, 0] = values["nu"]

        def to_modes(v):
            t = dst2(v.reshape(v.shape[:-1] + (2, Nx, Ny)))
            return t.reshape(v.shape[:-1] + (2, -1)).transpose(-1, -2)

        def from_modes(w):
            t = w.transpose(-1, -2).reshape(w.shape[:-2] + (2, Nx, Ny))
            return (dst2(t) * scale).reshape(w.shape[:-2] + (n,))

        return blocks, to_modes, from_modes

    object.__setattr__(prob, "po_spectral_data", po_spectral_data)
    return prob


def co_oxidation(params=None, device=None,
                 dtype: torch.dtype = DEFAULT_DTYPE):
    """CO-oxidation model (ref test/hopf_codim_2/COModel.jl): fold and Hopf
    curves with BT, cusp and GH points.  Continued in `q2`."""
    dev = resolve_device(device)
    if params is None:
        params = {"q1": 2.5, "q2": 1.0, "q3": 10.0, "q4": 0.0675,
                  "q5": 1.0, "q6": 0.1, "k": 0.4}

    def F(u, par):
        x, y, s = u[0], u[1], u[2]
        q1, q2, q3, q4 = par["q1"], par["q2"], par["q3"], par["q4"]
        q5, q6, k = par["q5"], par["q6"], par["k"]
        z = 1 - x - y - s
        return torch.stack([
            2 * q1 * z ** 2 - 2 * q5 * x ** 2 - q3 * x * y,
            q2 * z - q6 * y - q3 * x * y,
            q4 * z - k * q4 * s,
        ])

    # ref test/hopf_codim_2/COModel.jl:21
    u0 = torch.tensor([0.001137, 0.891483, 0.062345], dtype=dtype,
                      device=dev)
    return BifurcationProblem(F, u0=u0, params=_params(params, dtype, dev),
                              lens="q2")


def tsodyks_markram(params=None, device=None,
                    dtype: torch.dtype = DEFAULT_DTYPE):
    """Tsodyks-Markram neural-mass model (ref examples/TMModel.jl:8-20):
    E-x-u synaptic dynamics with a softplus firing rate.  The equilibrium
    branch in E0 carries two folds and a Hopf; continued in `E0`."""
    dev = resolve_device(device)
    if params is None:
        params = {"alpha": 1.5, "tau": 0.013, "J": 3.07, "E0": -2.0,
                  "tauD": 0.2, "U0": 0.3, "tauF": 1.5}

    def F(z, par):
        E, x, u = z[0], z[1], z[2]
        SS0 = par["J"] * u * x * E + par["E0"]
        SS1 = par["alpha"] * torch.logaddexp(torch.zeros_like(SS0),
                                             SS0 / par["alpha"])
        return torch.stack([
            (-E + SS1) / par["tau"],
            (1 - x) / par["tauD"] - u * x * E,
            (par["U0"] - u) / par["tauF"] + par["U0"] * (1 - u) * E,
        ])

    # ref examples/TMModel.jl:20
    u0 = torch.tensor([0.238616, 0.982747, 0.367876], dtype=dtype,
                      device=dev)
    return BifurcationProblem(F, u0=u0, params=_params(params, dtype, dev),
                              lens="E0")


def neumann_laplacian_dia(Nx: int, Ny: int, hx2: float, hy2: float,
                          device=None, dtype: torch.dtype = DEFAULT_DTYPE):
    """The 2D modified-corner Neumann Laplacian of `ops.sh_jv.lap_neumann`
    (edge replication; ref examples/SH2d-fronts.jl:20-24) as one
    `DIAMatrix` on the row-major flattened Nx*Ny grid: offsets 0, +-1
    (along y) and +-Ny (along x), data zero across row ends, and the
    replicated edge folded into the diagonal (-1/h^2 in place of -2/h^2
    at each border).  The matrix is symmetric."""
    from ..ops import DIAMatrix

    ix = np.arange(Nx)[:, None] * np.ones((1, Ny))
    iy = np.ones((Nx, 1)) * np.arange(Ny)[None, :]
    diag = -(2.0 - (ix == 0) - (ix == Nx - 1)) / hx2 \
        - (2.0 - (iy == 0) - (iy == Ny - 1)) / hy2
    data = np.stack([diag,
                     (iy < Ny - 1) / hy2, (iy > 0) / hy2,
                     (ix < Nx - 1) / hx2, (ix > 0) / hx2]).reshape(5, -1)
    return DIAMatrix(torch.as_tensor(data, dtype=dtype,
                                     device=resolve_device(device)),
                     (0, 1, -1, Ny, -Ny))


def _dia_laplacian_2d(Nx, Ny, hx2, hy2, dev, spmv):
    """v -> Delta v through `spmv(A, v)` (`dia_spmv`: the kernel on the
    card), for states (..., k, Nx, Ny): every field of every state goes in
    one batched product.  One `DIAMatrix` per dtype, made at first use (a
    low-precision twin reuses it)."""
    mats = {}
    n = Nx * Ny

    def lap(v):
        A = mats.get(v.dtype)
        if A is None:
            A = mats[v.dtype] = neumann_laplacian_dia(Nx, Ny, hx2, hy2, dev,
                                                      v.dtype)
        return spmv(A, v.reshape(-1, n).contiguous()).reshape(v.shape)

    return lap


def _dct_precond(Nx, Ny, hx2, hy2, dev, dtype):
    """blockdiag (Delta - shift)^-1 per component in the 2D DCT-II basis
    (which diagonalises the modified-corner Neumann Laplacian), computed
    in `dtype` (f32 by default, as in the JAX package); on a state, a flat
    vector or a block of them."""
    from .sh import dct2, idct2

    mu_x = 2.0 * (np.cos(np.pi * np.arange(Nx) / Nx) - 1) / hx2
    mu_y = 2.0 * (np.cos(np.pi * np.arange(Ny) / Ny) - 1) / hy2
    sym = torch.as_tensor(mu_x[:, None] + mu_y[None, :], dtype=dtype,
                          device=dev)

    def precond(v, shift=1.0):
        x = v.reshape(-1, Nx, Ny).to(dtype)
        return idct2(dct2(x) / (sym - shift)).to(v.dtype).reshape(v.shape)

    return precond


def _lap2d(Nx, Ny, lx, ly):
    from ..ops.sh_jv import lap_neumann

    hx2 = float((2 * lx / Nx) ** 2)
    hy2 = float((2 * ly / Ny) ** 2)

    def lap(u):
        return lap_neumann(u, hx2, -2) + lap_neumann(u, hy2, -1)

    return hx2, hy2, lap


def fold_hopf_interaction_2d(Nx: int = 32, Ny: int = 32,
                             lx: float = np.pi, ly: float = np.pi,
                             p1: float = -0.4, a: float = -0.5,
                             alpha: float = 1.0, nu: float = 1.0,
                             device=None,
                             dtype: torch.dtype = DEFAULT_DTYPE,
                             spmv=None):
    """Constructed PDE-scale fold-Hopf (zero-Hopf) interaction with exact
    codim-2 geometry, the validation model of matrix-free codim-2
    switching:

        s_t = Lap s + p1 + s^2
        z_t = Lap z + (a + alpha s) z + i nu z      (z = x + i y)

    with Neumann Laplacians, state (3, Nx, Ny).  Constant states
    s = +-sqrt(-p1), z = 0; per DCT mode k the jacobian is block diagonal
    with s-block (lam_k + 2 s) and z-block (lam_k + a + alpha s +- i nu):
    the fold curve in (p1, a) is exactly p1 = 0, the zero-Hopf on it is at
    a = 0, and the Hopf curve through it is p1 = -(a/alpha)^2 with
    omega = nu.

    J.v (`jac_op`) applies the Laplacian as one `DIAMatrix`
    (`neumann_laplacian_dia`) through `dia_spmv`, the three fields in one
    batched launch, plus the elementwise local terms; J^T.v
    (`jac_adjoint`) the same (the Laplacian is symmetric).  d2F and d3F
    are closed forms (d3F and every higher form vanish).  The spectral
    preconditioner (`spectral_precond`) computes in f32, as in the JAX
    package, which bounds what the matrix-free normal forms resolve to
    about 3e-8 relative.  `spmv(A, v)`
    is the DIA product (default `ops.dia_spmv`; `ops.dia_spmv_plain`
    holds the kernel against its plain version on the card)."""
    dev = resolve_device(device)
    spmv = spmv or dia_spmv
    hx2, hy2, lap = _lap2d(Nx, Ny, lx, ly)
    lap_dia = _dia_laplacian_2d(Nx, Ny, hx2, hy2, dev, spmv)

    def F(u, par):
        s, x, y = u[0], u[1], u[2]
        g = par["a"] + par["alpha"] * s
        return torch.stack([lap(s) + par["p1"] + s * s,
                            lap(x) + g * x - par["nu"] * y,
                            lap(y) + par["nu"] * x + g * y])

    def _local(u, par):
        s, x, y = u[0], u[1], u[2]
        return s, x, y, par["a"] + par["alpha"] * s, par["alpha"], par["nu"]

    def jac_op(u, par):
        s, x, y, g, al, nn = _local(u, par)

        def op(v):
            L = lap_dia(v)
            vs, vx, vy = v[..., 0, :, :], v[..., 1, :, :], v[..., 2, :, :]
            return torch.stack([
                L[..., 0, :, :] + 2 * s * vs,
                L[..., 1, :, :] + al * x * vs + g * vx - nn * vy,
                L[..., 2, :, :] + al * y * vs + nn * vx + g * vy], dim=-3)

        return op

    def jac_adjoint(u, par):
        s, x, y, g, al, nn = _local(u, par)

        def op(w):
            L = lap_dia(w)
            ws, wx, wy = w[..., 0, :, :], w[..., 1, :, :], w[..., 2, :, :]
            return torch.stack([
                L[..., 0, :, :] + 2 * s * ws + al * (x * wx + y * wy),
                L[..., 1, :, :] + g * wx + nn * wy,
                L[..., 2, :, :] - nn * wx + g * wy], dim=-3)

        return op

    def d2F(u, par, d1, d2):
        s1, x1, y1 = d1[..., 0, :, :], d1[..., 1, :, :], d1[..., 2, :, :]
        s2, x2, y2 = d2[..., 0, :, :], d2[..., 1, :, :], d2[..., 2, :, :]
        al = par["alpha"]
        return torch.stack([2 * s1 * s2, al * (s1 * x2 + x1 * s2),
                            al * (s1 * y2 + y1 * s2)], dim=-3)

    def d3F(u, par, d1, d2, d3):
        return torch.zeros_like(d1 * d2 * d3)

    u0 = torch.zeros((3, Nx, Ny), dtype=dtype, device=dev)
    u0[0] = -np.sqrt(max(-p1, 0.0))
    prob = BifurcationProblem(
        F, u0=u0, params=_params({"p1": p1, "a": a, "alpha": alpha,
                                  "nu": nu}, dtype, dev),
        lens="p1", jac_op=jac_op, jac_adjoint=jac_adjoint, d2F_user=d2F,
        d3F_user=d3F, record_from_solution=lambda x, p, **k: {
            "param": p, "norm": torch.linalg.vector_norm(x.reshape(-1)),
            "smean": torch.mean(x[0])})
    object.__setattr__(prob, "spectral_precond",
                       _dct_precond(Nx, Ny, hx2, hy2, dev,
                                    torch.float32))
    return prob


def bogdanov_takens_2d(Nx: int = 40, Ny: int = 40,
                       lx: float = np.pi / 4, ly: float = np.pi / 4,
                       b1: float = 0.5, b2: float = 2.0, device=None,
                       dtype: torch.dtype = DEFAULT_DTYPE,
                       spmv=None):
    """PDE-promoted Bogdanov-Takens model (the planar bt_model with Neumann
    diffusion), state (2, Nx, Ny):

        u_t = Lap u + v
        v_t = Lap v + b1 + b2 u + u^2 - u v

    Constant states have v = 0 and b1 + b2 u + u^2 = 0; per DCT mode k the
    jacobian block is [[lam_k, 1], [b2 + 2u - v, lam_k - u]], so mode 0 is
    exactly the ODE bt_model: the fold curve b1 = b2^2/4 with an exact BT
    at (b1, b2) = (0, 0), u = 0.  The quarter-size domain keeps the mode-k
    fold curves far from the mode-0 one.

    J.v (`jac_op`) and J^T.v (`jac_adjoint`) apply the Laplacian as one
    `DIAMatrix` through `dia_spmv`, both fields in one batched launch,
    plus the elementwise local terms; d2F is a closed form, d3F and every
    higher form vanish.  The preconditioner and `spmv` as for
    `fold_hopf_interaction_2d`."""
    dev = resolve_device(device)
    spmv = spmv or dia_spmv
    hx2, hy2, lap = _lap2d(Nx, Ny, lx, ly)
    lap_dia = _dia_laplacian_2d(Nx, Ny, hx2, hy2, dev, spmv)

    def F(w, par):
        u, v = w[0], w[1]
        return torch.stack([lap(u) + v,
                            lap(v) + par["b1"] + par["b2"] * u + u * u
                            - u * v])

    def jac_op(w, par):
        u, v = w[0], w[1]
        c = par["b2"] + 2 * u - v

        def op(d):
            L = lap_dia(d)
            da, db = d[..., 0, :, :], d[..., 1, :, :]
            return torch.stack([L[..., 0, :, :] + db,
                                L[..., 1, :, :] + c * da - u * db], dim=-3)

        return op

    def jac_adjoint(w, par):
        u, v = w[0], w[1]
        c = par["b2"] + 2 * u - v

        def op(d):
            L = lap_dia(d)
            da, db = d[..., 0, :, :], d[..., 1, :, :]
            return torch.stack([L[..., 0, :, :] + c * db,
                                L[..., 1, :, :] + da - u * db], dim=-3)

        return op

    def d2F(w, par, d1, d2):
        a1, b1_ = d1[..., 0, :, :], d1[..., 1, :, :]
        a2, b2_ = d2[..., 0, :, :], d2[..., 1, :, :]
        return torch.stack([torch.zeros_like(a1 * a2),
                            2 * a1 * a2 - (a1 * b2_ + b1_ * a2)], dim=-3)

    def d3F(w, par, d1, d2, d3):
        return torch.zeros_like(d1 * d2 * d3)

    w0 = torch.zeros((2, Nx, Ny), dtype=dtype, device=dev)
    w0[0] = (-b2 + np.sqrt(max(b2 * b2 - 4 * b1, 0.0) + 1e-12)) / 2.0
    prob = BifurcationProblem(
        F, u0=w0, params=_params({"b1": b1, "b2": b2}, dtype, dev),
        lens="b1", jac_op=jac_op, jac_adjoint=jac_adjoint, d2F_user=d2F,
        d3F_user=d3F, record_from_solution=lambda x, p, **k: {
            "param": p, "norm": torch.linalg.vector_norm(x.reshape(-1)),
            "umean": torch.mean(x[0])})
    object.__setattr__(prob, "spectral_precond",
                       _dct_precond(Nx, Ny, hx2, hy2, dev,
                                    torch.float32))
    return prob


def lure(alpha: float = -1.0, beta: float = 1.0, device=None,
         dtype: torch.dtype = DEFAULT_DTYPE):
    """Lur'e system (ref test/periodic_orbits_function_sh4_and_collocation/
    testLure.jl:9-16): x' = y, y' = z, z' = -alpha z - beta y - x + x^2.
    Hopf at alpha beta = 1 (omega^2 = beta); the PO branch carries PD
    points.  F, its closed-form J.v (`jac_op`), d2F and d3F take a leading
    batch of states (..., 3); continued in `alpha`."""
    dev = resolve_device(device)

    def F(u, par):
        x, y, z = u[..., 0], u[..., 1], u[..., 2]
        return torch.stack([y, z, -par["alpha"] * z - par["beta"] * y - x
                            + x * x], dim=-1)

    def jac_op(u, par):
        x = u[..., 0]

        def op(v):
            dx, dy, dz = v[..., 0], v[..., 1], v[..., 2]
            return torch.stack(torch.broadcast_tensors(
                dy, dz, -par["alpha"] * dz - par["beta"] * dy
                + (2 * x - 1) * dx), dim=-1)

        return op

    def d2F(u, par, a, b):
        ab = a[..., 0] * b[..., 0] + 0 * u[..., 0]
        z = torch.zeros_like(ab)
        return torch.stack([z, z, 2 * ab], dim=-1)

    def d3F(u, par, a, b, c):
        return torch.zeros_like(a * b * c * u)

    return _batched(BifurcationProblem(
        F, u0=torch.zeros(3, dtype=dtype, device=dev),
        params=_params({"alpha": alpha, "beta": beta}, dtype, dev),
        lens="alpha", jac_op=jac_op, d2F_user=d2F, d3F_user=d3F))


def freire(nu: float = -0.9, beta: float = 0.5, gamma: float = -0.6,
           a3: float = 0.328578, b3: float = 0.933578, r: float = 0.6,
           device=None, dtype: torch.dtype = DEFAULT_DTYPE):
    """Freire electronic oscillator (ref test/periodic_orbits_bp_po/
    freire.jl:5-19): two branch points on the PO branch from the first
    Hopf; the switched branch carries NS and PD points.  F, J.v, d2F and
    d3F in closed form with a leading batch of states (..., 3); continued
    in `nu`."""
    dev = resolve_device(device)

    def F(u, par):
        x, y, z = u[..., 0], u[..., 1], u[..., 2]
        d3 = (y - x) ** 3
        be, b3_ = par["beta"], par["b3"]
        return torch.stack([
            (-(be + par["nu"]) * x + be * y - par["a3"] * x ** 3
             + b3_ * d3) / par["r"],
            be * x - (be + par["gamma"]) * y - z - b3_ * d3,
            y], dim=-1)

    def jac_op(u, par):
        x, y = u[..., 0], u[..., 1]
        c = 3 * par["b3"] * (y - x) ** 2
        be = par["beta"]

        def op(v):
            dx, dy, dz = v[..., 0], v[..., 1], v[..., 2]
            dd = c * (dy - dx)
            return torch.stack(torch.broadcast_tensors(
                (-(be + par["nu"]) * dx + be * dy
                 - 3 * par["a3"] * x * x * dx + dd) / par["r"],
                be * dx - (be + par["gamma"]) * dy - dz - dd,
                dy), dim=-1)

        return op

    def d2F(u, par, a, b):
        x, y = u[..., 0], u[..., 1]
        da, db = a[..., 1] - a[..., 0], b[..., 1] - b[..., 0]
        q = 6 * par["b3"] * (y - x) * da * db
        return torch.stack(torch.broadcast_tensors(
            (-6 * par["a3"] * x * a[..., 0] * b[..., 0] + q) / par["r"], -q,
            torch.zeros_like(q)), dim=-1)

    def d3F(u, par, a, b, c):
        q = 6 * par["b3"] * ((a[..., 1] - a[..., 0]) * (b[..., 1] - b[..., 0])
                             * (c[..., 1] - c[..., 0]))
        x3 = a[..., 0] * b[..., 0] * c[..., 0]
        q = q + 0 * u[..., 0]
        return torch.stack(torch.broadcast_tensors(
            (-6 * par["a3"] * x3 + q) / par["r"], -q, torch.zeros_like(q)),
            dim=-1)

    return _batched(BifurcationProblem(
        F, u0=torch.zeros(3, dtype=dtype, device=dev),
        params=_params({"nu": nu, "beta": beta, "gamma": gamma, "a3": a3,
                        "b3": b3, "r": r}, dtype, dev),
        lens="nu", jac_op=jac_op, d2F_user=d2F, d3F_user=d3F))


def neumann_laplacian_dia_1d(N: int, h2: float, device=None,
                             dtype: torch.dtype = DEFAULT_DTYPE):
    """The 1D modified-corner Neumann Laplacian (edge replication, ref
    examples/pd-1d.jl) as one `DIAMatrix` with offsets 0, +-1: the
    replicated edge folded into the diagonal (-1/h^2 at each end)."""
    from ..ops import DIAMatrix

    i = np.arange(N)
    diag = -(2.0 - (i == 0) - (i == N - 1)) / h2
    data = np.stack([diag, (i < N - 1) / h2, (i > 0) / h2])
    return DIAMatrix(torch.as_tensor(data, dtype=dtype,
                                     device=resolve_device(device)),
                     (0, 1, -1))


def bvam_1d(N: int = 100, lx: float = 3 * np.pi / 2, D: float = 0.08,
            C: float = -0.2, device=None, dtype: torch.dtype = DEFAULT_DTYPE,
            spmv=None):
    """Barrio-Varea-Aragon-Maini 1D reaction-diffusion (ref
    examples/pd-1d.jl and Aragon et al., PRE 86 026201): Turing patterns
    whose oscillations period-double, the reference's PD-of-periodic-orbits
    PDE workload.  State (2, N) = (u, v); Neumann modified-corner
    diffusion (D Lap u, Lap v); continued in C.

    F is plain torch (and differentiable); it and J.v (`jac_op`) take a
    leading batch of states (..., 2, N).  J.v applies the Laplacian as one
    `DIAMatrix` (`neumann_laplacian_dia_1d`) through `spmv` (default
    `ops.dia_spmv`, the kernel on the card), both fields of every state in
    one batched launch, and scales the u rows by D afterwards: D is a
    parameter of the codim-2 curves, never baked into the matrix.  The
    dense jacobian (`jac`) is J.v on the identity, so it takes the kernel
    too.  d2F and d3F are closed forms (the reaction terms are cubic)."""
    dev = resolve_device(device)
    spmv = spmv or dia_spmv
    h2 = float((2 * lx / N) ** 2)
    mats = {}

    def lap_dia(w):
        A = mats.get(w.dtype)
        if A is None:
            A = mats[w.dtype] = neumann_laplacian_dia_1d(N, h2, dev, w.dtype)
        return spmv(A, w.reshape(-1, N).contiguous()).reshape(w.shape)

    def lap(u):
        up = torch.cat([u[..., :1], u, u[..., -1:]], dim=-1)
        return (up[..., :-2] - 2 * u + up[..., 2:]) / h2

    def F(z, par):
        u, v = z[..., 0, :], z[..., 1, :]
        eta, Cc = par["eta"], par["C"]
        fu = eta * (u + par["a"] * v - Cc * u * v - u * v * v)
        gv = eta * (par["H"] * u + par["b"] * v + Cc * u * v + u * v * v)
        return torch.stack([par["D"] * lap(u) + fu, lap(v) + gv], dim=-2)

    def jac_op(z, par):
        u, v = z[..., 0, :], z[..., 1, :]
        eta, Cc = par["eta"], par["C"]
        fu_u = eta * (1 - Cc * v - v * v)
        fu_v = eta * (par["a"] - Cc * u - 2 * u * v)
        gv_u = eta * (par["H"] + Cc * v + v * v)
        gv_v = eta * (par["b"] + Cc * u + 2 * u * v)

        def op(w):
            L = lap_dia(w)
            du, dv = w[..., 0, :], w[..., 1, :]
            return torch.stack([par["D"] * L[..., 0, :] + fu_u * du
                                + fu_v * dv,
                                L[..., 1, :] + gv_u * du + gv_v * dv],
                               dim=-2)

        return op

    def jac(z, par):
        n = 2 * N
        eye = torch.eye(n, dtype=z.dtype, device=z.device).reshape(n, 2, N)
        return jac_op(z, par)(eye).reshape(n, n).T

    def d2F(z, par, a, b):
        u, v = z[..., 0, :], z[..., 1, :]
        eta = par["eta"]
        ua, va, ub, vb = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        mix = (par["C"] + 2 * v) * (ua * vb + va * ub) + 2 * u * va * vb
        return torch.stack([-eta * mix, eta * mix], dim=-2)

    def d3F(z, par, a, b, c):
        ua, va, ub, vb = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        uc, vc = c[..., 0, :], c[..., 1, :]
        t = 2 * par["eta"] * (ua * vb * vc + va * ub * vc + va * vb * uc)
        return torch.stack([-t, t], dim=-2)

    X = np.linspace(-lx, lx, N)
    u0 = np.cos(2 * X)
    z0 = torch.as_tensor(np.stack([u0, u0]), dtype=dtype, device=dev)

    def record(z, p, **k):
        return {"param": p, "norm": torch.max(torch.abs(z)),
                "n2": torch.linalg.vector_norm(z.reshape(-1))}

    return _batched(BifurcationProblem(
        F, u0=z0, params=_params({"eta": 1.0, "a": -1.0, "b": -1.5,
                                  "H": 3.0, "D": D, "C": C}, dtype, dev),
        lens="C", jac=jac, jac_op=jac_op, d2F_user=d2F, d3F_user=d3F,
        record_from_solution=record))


def swift_hohenberg_1d(n: int = 200, l_dom: float = 6.0, lam: float = -0.1,
                       nu: float = 2.0, seed: int = 0, device=None,
                       dtype: torch.dtype = DEFAULT_DTYPE):
    """1D quintic Swift-Hohenberg (ref examples/SHpde_snaking.jl:7-35; JAX
    `equilibria.py::swift_hohenberg_1d`):
    F = -(I+D2)^2 u + lam u + nu u^3 - u^5 with the plain (Dirichlet
    closure) second difference, localized-pattern guess 1.1 cos(x) — the
    reference's homoclinic-snaking workload.  The record's weight `w` is
    numpy's `default_rng(seed).random(n)`, as in the JAX function."""
    dev = resolve_device(device)
    X = -l_dom + 2 * l_dom / n * np.arange(n)
    h2 = float((X[1] - X[0]) ** 2)

    def lap(u):
        # Dirichlet closure: zero-pad (ref spdiagm, :16 — corners NOT
        # modified, unlike the Neumann models)
        up = torch.nn.functional.pad(u, (1, 1))
        return (up[..., :-2] - 2 * u + up[..., 2:]) / h2

    def F(u, par):
        v = u + lap(u)
        L1u = v + lap(v)
        return -L1u + par["lam"] * u + par["nu"] * u ** 3 - u ** 5

    def d2F(u, par, dx1, dx2):
        return (par["nu"] * 6 * u - 5 * 4 * u ** 3) * dx1 * dx2

    def d3F(u, par, dx1, dx2, dx3):
        return (par["nu"] * 6 - 5 * 4 * 3 * u ** 2) * dx1 * dx2 * dx3

    w = torch.as_tensor(np.random.default_rng(seed).random(n), dtype=dtype,
                        device=dev)

    def record(x, p, **k):
        return {"param": p, "norm": torch.linalg.vector_norm(x),
                "nw": torch.linalg.vector_norm(w * x), "s": torch.sum(x),
                "s2": x[n // 2], "s4": x[n // 4]}

    return BifurcationProblem(
        F, u0=torch.as_tensor(1.1 * np.cos(X), dtype=dtype, device=dev),
        params=_params({"lam": lam, "nu": nu}, dtype, dev), lens="lam",
        d2F_user=d2F, d3F_user=d3F, record_from_solution=record)
