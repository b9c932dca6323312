"""Small equilibrium models — the port of the parts of
`jl_tpu/models/equilibria.py` the port runs (ref examples/*.jl, test
fixtures): the Chan and Carrier BVPs, the scalar transcritical and
pitchfork normal forms, the planar Hopf normal form, the 1D
Brusselator and the Lorenz-84 model.

Each takes `device=` (None means the card, which raises where there is
none; pass `device="cpu"` to run on the CPU) and `dtype=`; the state and
the parameters (0-d tensors) are made there.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import DEFAULT_DTYPE, resolve_device
from ..core.problem import BifurcationProblem


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


def brusselator_1d(n: int = 100, alpha: float = 2.0, beta: float = 5.45,
                   D1: float = 0.008, D2: float = 0.004, l: float = 0.3,
                   device=None, dtype: torch.dtype = DEFAULT_DTYPE):
    """1D Brusselator reaction-diffusion (ref examples/brusselator.jl:26-49,
    par at :93): Dirichlet BCs u=alpha, v=beta/alpha at both ends, h = 1/n,
    continued in the domain length `l`; Hopf bifurcations along the branch.
    The state is the stacked (u, v) of length 2n."""
    dev = resolve_device(device)
    h = 1.0 / n

    def F(uv, par):
        a = par["alpha"]
        b = par["beta"]
        ll = par["l"]
        u = uv[:n]
        v = uv[n:]
        c1 = par["D1"] / (ll ** 2 * h ** 2)
        c2 = par["D2"] / (ll ** 2 * h ** 2)
        ae = a.reshape(1)
        ve = (b / a).reshape(1)
        u_ext = torch.cat([ae, u, ae])
        v_ext = torch.cat([ve, v, ve])
        lap_u = u_ext[:-2] - 2 * u_ext[1:-1] + u_ext[2:]
        lap_v = v_ext[:-2] - 2 * v_ext[1:-1] + v_ext[2:]
        fu = c1 * lap_u + a - (b + 1) * u + u * u * v
        fv = c2 * lap_v + b * u - u * u * v
        return torch.cat([fu, fv])

    u0 = torch.cat([torch.full((n,), alpha, dtype=dtype, device=dev),
                    torch.full((n,), beta / alpha, dtype=dtype, device=dev)])
    params = _params({"alpha": alpha, "beta": beta, "D1": D1, "D2": D2,
                      "l": l}, dtype, dev)
    return BifurcationProblem(F, u0=u0, params=params, lens="l")


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
