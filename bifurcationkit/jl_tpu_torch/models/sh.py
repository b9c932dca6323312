"""Swift-Hohenberg SH2d-fronts — the port of `jl_tpu/models/sh.py::
swift_hohenberg_2d` (ref examples/SH2d-fronts.jl:8-60), the flagship
matrix-free PDE workload, whose J.v is the hand-written CUDA kernel
(`ops/sh_jv.py`) through the problem's `jac_op` hook; and Mittelmann's
Gelfand-Bratu problem (`mittelmann`, ref examples/mittleman.jl), the
square-domain showcase of Nd branch points."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import DEFAULT_DTYPE, resolve_device
from ..core.problem import BifurcationProblem
from ..ops.sh_jv import lap_neumann, sh_jv_operator


# ---------------------------------------------------------------------------
# Orthonormal DCT-II and its inverse on torch.fft (Makhoul's reordering:
# one complex FFT of length n per transform)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _dct_factors(n: int, dtype: torch.dtype, device: torch.device):
    """(forward twiddle with the ortho scale folded in, ortho scale,
    inverse twiddle / 2) for length n."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    scale = torch.full((n,), math.sqrt(1.0 / (2 * n)), dtype=torch.float64,
                       device=device)
    scale[0] = math.sqrt(1.0 / (4 * n))
    twiddle = torch.exp(-1j * math.pi * k / (2 * n))
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return ((2 * scale * twiddle).to(cdtype), scale.to(dtype),
            (torch.conj(twiddle) / 2).to(cdtype))


def dct_ortho(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis (scipy's `dct(type=2,
    norm="ortho")`)."""
    fwd, _, _ = _dct_factors(x.shape[-1], x.dtype, x.device)
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    return torch.real(torch.fft.fft(v, dim=-1) * fwd)


def idct_ortho(y: torch.Tensor) -> torch.Tensor:
    """Inverse of `dct_ortho` (scipy's `idct(type=2, norm="ortho")`)."""
    n = y.shape[-1]
    _, scale, inv = _dct_factors(n, y.dtype, y.device)
    # unnormalised coefficients Y; V[k] = e^{i pi k/2n} (Y[k] - i Y[n-k]) / 2
    # with Y[n] := 0 is the FFT of the reordered signal
    Y = y / scale
    Y_rev = torch.cat([torch.zeros_like(Y[..., :1]), Y[..., 1:].flip(-1)],
                      dim=-1)
    v = torch.real(torch.fft.ifft((Y - 1j * Y_rev) * inv, dim=-1))
    x = torch.empty_like(y)
    half = (n + 1) // 2
    x[..., 0::2] = v[..., :half]
    x[..., 1::2] = v[..., half:].flip(-1)
    return x


def dct2(u: torch.Tensor) -> torch.Tensor:
    """2-D orthonormal DCT-II over the last two axes (axis -2 first)."""
    v = dct_ortho(u.transpose(-1, -2)).transpose(-1, -2)
    return dct_ortho(v)


def idct2(u: torch.Tensor) -> torch.Tensor:
    v = idct_ortho(u)
    return idct_ortho(v.transpose(-1, -2)).transpose(-1, -2)


def swift_hohenberg_2d(Nx: int = 151, Ny: int = 100, lx: float = 8 * np.pi,
                       ly: float = 2 * 2 * np.pi / np.sqrt(3),
                       l: float = -0.1, nu: float = 1.3, device=None,
                       dtype: torch.dtype = DEFAULT_DTYPE):
    """SH2d-fronts (ref examples/SH2d-fronts.jl:8-60): snaking localized
    patterns.  The state is the (Nx, Ny) field; residual
    F = -(I+Delta)^2 u + l u + nu u^2 - u^3.

    `device=None` means the card (raises where there is none); pass
    `device="cpu"` to run on the CPU.  The parameters `l`, `nu` are 0-d
    tensors on that device, so the J.v scalars are built there without a
    host round trip."""
    dev = resolve_device(device)
    hx = 2 * lx / Nx
    hy = 2 * ly / Ny
    hx2, hy2 = float(hx * hx), float(hy * hy)

    def lap(u):
        return lap_neumann(u, hx2, -2) + lap_neumann(u, hy2, -1)

    def F(u, par):
        v = u + lap(u)
        L1u = v + lap(v)
        return -L1u + par["l"] * u + par["nu"] * u * u - u ** 3

    # analytic derivatives (ref d2F_sh/d3F_sh, examples/SH2d-fronts.jl:42-43)
    def d2F(u, par, dx1, dx2):
        return (2 * par["nu"] * dx2 - 6 * dx2 * u) * dx1

    def d3F(u, par, dx1, dx2, dx3):
        return -6 * dx1 * dx2 * dx3

    inv_h2 = torch.tensor([1.0 / hx2, 1.0 / hy2], dtype=torch.float64,
                          device=dev)

    def jac_op(u, par):
        """v -> J(u, par) v through the fused kernel; v is (Nx, Ny) or a
        batch (K, Nx, Ny).  u and the scalars are checked once here, at
        the linearisation point, not at every product."""
        dt = u.dtype
        # a parameter may be a Python float (the normal forms set the lens
        # to the point's p): made at u's dtype, not at torch's default f32
        lnu = torch.stack([torch.as_tensor(par["l"], dtype=dt, device=dev),
                           torch.as_tensor(par["nu"], dtype=dt, device=dev)])
        op = sh_jv_operator(u.contiguous(), torch.cat([lnu, inv_h2.to(dt)]))
        return lambda v: op(v.contiguous())

    X = -lx + 2 * lx / Nx * np.arange(Nx)
    Y = -ly + 2 * ly / Ny * np.arange(Ny)
    sol0 = (np.cos(X)[:, None]
            + np.cos(X / 2)[:, None] * np.cos(np.sqrt(3) * Y / 2)[None, :])
    sol0 = sol0 - sol0.min()
    sol0 = sol0 / sol0.max()
    sol0 = (sol0 - 0.25) * 1.7

    def record(x, p, **k):
        flat = x.reshape(-1)
        return {"param": p, "norm": torch.linalg.vector_norm(flat),
                "n8": torch.pow(torch.sum(flat ** 8), 1.0 / 8)}

    prob = BifurcationProblem(
        F, u0=torch.as_tensor(sol0, dtype=dtype, device=dev),
        params={"l": torch.tensor(l, dtype=dtype, device=dev),
                "nu": torch.tensor(nu, dtype=dtype, device=dev)},
        lens="l", jac_op=jac_op,
        d2F_user=d2F, d3F_user=d3F, record_from_solution=record)

    # exact spectral preconditioner: DCT-II diagonalizes the
    # modified-corner Neumann Laplacian, so (-(I+Delta)^2 - shift)^{-1} is
    # diagonal in the 2D cosine basis (ref examples/SH2d-fronts-cuda.jl:31-65)
    lx_ = 2 * (np.cos(np.pi * np.arange(Nx) / Nx) - 1) / hx2
    ly_ = 2 * (np.cos(np.pi * np.arange(Ny) / Ny) - 1) / hy2
    sym = torch.as_tensor(-(1.0 + lx_[:, None] + ly_[None, :]) ** 2,
                          dtype=torch.float64, device=dev)

    def precond(v, shift=1.0):
        """(sym - shift)^{-1} in the cosine basis; v is a state, a flat
        vector or a block of them (any leading dims).  The output keeps
        v's dtype; the division runs at f64 as in the JAX package."""
        x = v.reshape(-1, Nx, Ny)
        out = idct2(dct2(x) / (sym - shift)).to(v.dtype)
        return out.reshape(v.shape)

    object.__setattr__(prob, "spectral_precond", precond)
    return prob


def mittelmann(Nx: int = 30, Ny: int = 30, lx: float = 0.5, ly: float = 0.5,
               lam: float = 0.01, device=None,
               dtype: torch.dtype = DEFAULT_DTYPE):
    """Mittelmann's 2D Gelfand-Bratu problem (ref examples/mittleman.jl:14-82):
    F(u) = Delta u - 10 (u - lam e^u) with the modified-corner Neumann
    Laplacian on [-lx,lx] x [-ly,ly].  The square's symmetry makes the
    branch points 2d — the reference's showcase for Nd normal forms,
    `multicontinuation` and automatic bifurcation diagrams.

    The state is the (Nx, Ny) field; `record_from_solution` gives the
    reference's symmetry-breaking weighted norm `nw` (ref mittleman.jl:7,73)
    so distinct sheets separate in diagram plots.  `device=None` means the
    card; pass `device="cpu"` to run on the CPU."""
    dev = resolve_device(device)
    hx2 = float((2 * lx / Nx) ** 2)
    hy2 = float((2 * ly / Ny) ** 2)

    def F(u, par):
        lap = lap_neumann(u, hx2, -2) + lap_neumann(u, hy2, -1)
        return lap - 10.0 * (u - par["lam"] * torch.exp(u))

    X = np.linspace(-lx, lx, Nx)
    Y = np.linspace(-ly, ly, Ny)
    w = (lx + X)[:, None] * Y[None, :]
    w = torch.as_tensor(w - w.min(), dtype=dtype, device=dev).reshape(-1)

    def record(x, p, **k):
        flat = x.reshape(-1)
        return {"param": p,
                "nw": torch.linalg.vector_norm(flat * w)
                / math.sqrt(flat.shape[0]),
                "norm": torch.linalg.vector_norm(flat),
                "n_inf": torch.max(torch.abs(flat))}

    return BifurcationProblem(
        F, u0=torch.zeros((Nx, Ny), dtype=dtype, device=dev),
        params={"lam": torch.tensor(lam, dtype=dtype, device=dev)},
        lens="lam", record_from_solution=record)
