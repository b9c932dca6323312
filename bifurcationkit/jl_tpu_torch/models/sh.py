"""Swift-Hohenberg models — the port of `jl_tpu/models/sh.py`:
SH2d-fronts (`swift_hohenberg_2d`, ref examples/SH2d-fronts.jl:8-60), the
flagship matrix-free PDE workload, and the periodic SH2d of the
reference's GPU example (`swift_hohenberg_periodic_2d`, ref
examples/SH2d-fronts-cuda.jl), whose J.v is the hand-written CUDA kernel
(`ops/sh_jv.py`, Neumann and periodic closures) through the problem's
`jac_op` hook; SH3d (`swift_hohenberg_3d`, ref examples/SH3d.jl), whose
3D stencil has no kernel; and Mittelmann's Gelfand-Bratu problem
(`mittelmann`, ref examples/mittleman.jl), the square-domain showcase of
Nd branch points."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import DEFAULT_DTYPE, resolve_device
from ..core.problem import BifurcationProblem
from ..ops.sh_jv import lap_neumann, lap_periodic, sh_jv_operator


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


def _along(fn, x: torch.Tensor, axis: int) -> torch.Tensor:
    """A transform of the last axis applied along `axis`."""
    return fn(x.movedim(axis, -1)).movedim(-1, axis)


def dct3(u: torch.Tensor) -> torch.Tensor:
    """3-D orthonormal DCT-II over the last three axes (axis -3 first, as
    the JAX model's `dct3`)."""
    for ax in (-3, -2, -1):
        u = _along(dct_ortho, u, ax)
    return u


def idct3(u: torch.Tensor) -> torch.Tensor:
    for ax in (-1, -2, -3):
        u = _along(idct_ortho, u, ax)
    return u


def _sh_jac_op(dev, inv_h2, closure):
    """The SH models' `jac_op`: (u, par) -> (v -> J(u, par) v) through
    the fused kernel; v is (Nx, Ny) or a batch (K, Nx, Ny).  u and the
    scalars are checked once, at the linearisation point, not at every
    product."""

    def jac_op(u, par):
        dt = u.dtype
        # a parameter may be a Python float (the normal forms set the lens
        # to the point's p): made at u's dtype, not at torch's default f32
        lnu = torch.stack([torch.as_tensor(par["l"], dtype=dt, device=dev),
                           torch.as_tensor(par["nu"], dtype=dt, device=dev)])
        op = sh_jv_operator(u.contiguous(), torch.cat([lnu, inv_h2.to(dt)]),
                            closure)
        return lambda v: op(v.contiguous())

    return jac_op


def _sh_record(x, p, **k):
    flat = x.reshape(-1)
    return {"param": p, "norm": torch.linalg.vector_norm(flat),
            "n8": torch.pow(torch.sum(flat ** 8), 1.0 / 8)}


# analytic derivatives (ref d2F_sh/d3F_sh, examples/SH2d-fronts.jl:42-43)
def _sh_d2F(u, par, dx1, dx2):
    return (2 * par["nu"] * dx2 - 6 * dx2 * u) * dx1


def _sh_d3F(u, par, dx1, dx2, dx3):
    return -6 * dx1 * dx2 * dx3


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

    inv_h2 = torch.tensor([1.0 / hx2, 1.0 / hy2], dtype=torch.float64,
                          device=dev)

    X = -lx + 2 * lx / Nx * np.arange(Nx)
    Y = -ly + 2 * ly / Ny * np.arange(Ny)
    sol0 = (np.cos(X)[:, None]
            + np.cos(X / 2)[:, None] * np.cos(np.sqrt(3) * Y / 2)[None, :])
    sol0 = sol0 - sol0.min()
    sol0 = sol0 / sol0.max()
    sol0 = (sol0 - 0.25) * 1.7

    prob = BifurcationProblem(
        F, u0=torch.as_tensor(sol0, dtype=dtype, device=dev),
        params={"l": torch.tensor(l, dtype=dtype, device=dev),
                "nu": torch.tensor(nu, dtype=dtype, device=dev)},
        lens="l", jac_op=_sh_jac_op(dev, inv_h2, "neumann"),
        d2F_user=_sh_d2F, d3F_user=_sh_d3F, record_from_solution=_sh_record)

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


def swift_hohenberg_periodic_2d(Nx: int = 512, Ny: int = None,
                                lx: float = 16 * np.pi,
                                ly: float = 4 * np.pi * 2 / np.sqrt(3),
                                l: float = -0.15, nu: float = 1.3,
                                dtype: torch.dtype = None,
                                operator: str = "fd", N: int = None,
                                L: float = None, device=None):
    """Periodic SH2d — the reference GPU example's workload
    (ref examples/SH2d-fronts-cuda.jl:19-20,31-65: N = 2^9 x 2^9, Float64;
    JAX `sh.py:122-240`).

    operator="fd" (default): a real-space 13-point periodic finite
    difference stencil; its `jac_op` is the fused kernel with the periodic
    closure (`sh_jv(..., closure="periodic")`).  The FFT is the EXACT
    diagonal inverse of the linear part (`spectral_precond`), because the
    periodic FD Laplacian is diagonalized by the DFT with the discrete
    symbol lambda_j = 2 (cos(2 pi j / N) - 1) / h^2.

    operator="fft": the literal spectral operator of the CUDA example
    (continuous symbol -(1 - k^2)^2) on `torch.fft`; no `jac_op` (J.v is
    forward AD of F).

    dtype defaults to float64 for both operators: the card has complex128
    FFTs (the JAX function drops the fft operator to f32 on a TPU, whose
    FFT is complex64-only).  Box, guess and defaults follow the
    reference: Nx = Ny = 2^9 on [-lx, lx] x [-ly, ly] with lx = 16 pi,
    ly = 4 pi 2/sqrt(3), hexagon ansatz
    0.5 (cos x + cos(x/2) cos(sqrt(3) y / 2)) (ref
    examples/SH2d-fronts-cuda.jl:66-76,117).  The legacy (N, L)
    square-box aliases are accepted.  `device=None` means the card."""
    dev = resolve_device(device)
    if operator not in ("fd", "fft"):
        raise ValueError(f"operator must be 'fd' or 'fft', got {operator!r}")
    if N is not None:
        Nx = N
    if Ny is None:
        Ny = Nx
    if L is not None:
        lx = ly = L / 2
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    hx = 2 * lx / Nx
    hy = 2 * ly / Ny
    hx2, hy2 = float(hx * hx), float(hy * hy)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    jac_op = None

    if operator == "fd":
        # discrete symbols of the periodic 5-point Laplacian: the FFT
        # diagonalizes the FD operator EXACTLY (not just asymptotically)
        lam_x = 2.0 * (np.cos(2 * np.pi * np.arange(Nx) / Nx) - 1.0) / hx2
        lam_y = 2.0 * (np.cos(2 * np.pi * np.arange(Ny) / Ny) - 1.0) / hy2
        sym_np = -((1.0 + lam_x[:, None] + lam_y[None, :]) ** 2)

        def lap(u):
            return lap_periodic(u, hx2, -2) + lap_periodic(u, hy2, -1)

        def F(u, par):
            v = u + lap(u)
            L1u = v + lap(v)
            return -L1u + par["l"] * u + par["nu"] * u * u - u ** 3

        inv_h2 = torch.tensor([1.0 / hx2, 1.0 / hy2], dtype=torch.float64,
                              device=dev)
        jac_op = _sh_jac_op(dev, inv_h2, "periodic")
    else:
        kx = np.fft.fftfreq(Nx, d=hx) * 2 * np.pi
        ky = np.fft.fftfreq(Ny, d=hy) * 2 * np.pi
        sym_np = -((1 - kx[:, None] ** 2 - ky[None, :] ** 2) ** 2)
        sym_op = torch.as_tensor(sym_np, dtype=dtype, device=dev)

        def apply_L(u):
            return torch.real(torch.fft.ifft2(
                sym_op * torch.fft.fft2(u.to(cdtype)))).to(u.dtype)

        def F(u, par):
            return apply_L(u) + par["l"] * u + par["nu"] * u * u - u ** 3

    sym = torch.as_tensor(sym_np, dtype=torch.float64, device=dev)
    sym32 = sym.to(torch.float32)

    def precond(v, shift=1.0):
        """Exact diagonal inverse of (linear part - shift) in Fourier
        space; v is a state, a flat vector or a block of them.  complex128
        on f64 input; the f32 route (complex64) only for f32 input, as
        the JAX function on a non-TPU backend."""
        x = v.reshape(-1, Nx, Ny)
        if x.dtype == torch.float32:
            out = torch.real(torch.fft.ifft2(torch.fft.fft2(x)
                                             / (sym32 - shift)))
        else:
            out = torch.real(torch.fft.ifft2(torch.fft.fft2(x)
                                             / (sym - shift)))
        return out.to(v.dtype).reshape(v.shape)

    # hexagon ansatz (ref examples/SH2d-fronts-cuda.jl:76)
    X = -lx + hx * np.arange(Nx)
    Y = -ly + hy * np.arange(Ny)
    sol0 = 0.5 * (np.cos(X)[:, None]
                  + np.cos(X / 2)[:, None]
                  * np.cos(np.sqrt(3) * Y / 2)[None, :])

    prob = BifurcationProblem(
        F, u0=torch.as_tensor(sol0, dtype=dtype, device=dev),
        params={"l": torch.tensor(l, dtype=dtype, device=dev),
                "nu": torch.tensor(nu, dtype=dtype, device=dev)},
        lens="l", jac_op=jac_op, d2F_user=_sh_d2F, d3F_user=_sh_d3F,
        record_from_solution=_sh_record)
    object.__setattr__(prob, "spectral_precond", precond)
    return prob


def swift_hohenberg_3d(N: int = 22, L: float = np.pi, l: float = 0.1,
                       nu: float = 1.2, seed: int = 0, device=None,
                       dtype: torch.dtype = DEFAULT_DTYPE):
    """SH3d (ref examples/SH3d.jl:69-124; JAX `sh.py:283-367`): N^3
    state, hexagonal-lattice guess `1.2 * normalized(cos x cos y)`, record
    (n2, n8, nw) with nw's weight numpy's `default_rng(seed).random`, as
    the JAX function.  The exact DCT-II spectral preconditioner in three
    axes (the Neumann analog of the reference's cholesky((I+Delta)^2) at
    :91), analytic d2F/d3F (ref :63-64) and a closed-form J.v
    (`jac_op`).  The 3D stencil is plain PyTorch: the fused kernel is
    2D."""
    dev = resolve_device(device)
    h = 2 * L / N
    h2 = float(h * h)

    def lap(u):
        return (lap_neumann(u, h2, -3) + lap_neumann(u, h2, -2)
                + lap_neumann(u, h2, -1))

    def F(u, par):
        v = u + lap(u)
        L1u = v + lap(v)
        return -L1u + par["l"] * u + par["nu"] * u * u - u ** 3

    def jac_op(u, par):
        """v -> J(u, par) v in closed form, plain PyTorch; v is a state
        or a batch (K, N, N, N).  The same map as forward AD of F, without
        its per-product cost."""
        coef = par["l"] + 2 * par["nu"] * u - 3 * u * u

        def op(v):
            w = v + lap(v)
            return -(w + lap(w)) + coef * v

        return op

    # ref SH3d.jl:74-81: hexa guess from cos(x)cos(y), shifted/normalized
    X = -L + 2 * L / N * np.arange(N)
    sol0 = np.broadcast_to(
        (np.cos(X)[:, None] * np.cos(X)[None, :])[:, :, None],
        (N, N, N)).copy()
    sol0 = sol0 - sol0.min()
    sol0 = sol0 / sol0.max() * 1.2

    w = torch.as_tensor(np.random.default_rng(seed).random((N, N, N)),
                        dtype=dtype, device=dev).reshape(-1)

    def record(x, p, **k):
        flat = x.reshape(-1)
        return {"param": p, "norm": torch.linalg.vector_norm(flat),
                "n8": torch.pow(torch.sum(flat ** 8), 1.0 / 8),
                "nw": torch.linalg.vector_norm(flat * w)
                / math.sqrt(flat.shape[0])}

    prob = BifurcationProblem(
        F, u0=torch.as_tensor(sol0, dtype=dtype, device=dev),
        params={"l": torch.tensor(l, dtype=dtype, device=dev),
                "nu": torch.tensor(nu, dtype=dtype, device=dev)},
        lens="l", jac_op=jac_op, d2F_user=_sh_d2F, d3F_user=_sh_d3F,
        record_from_solution=record)

    # DCT-II diagonalizes the modified-corner Neumann second difference in
    # each axis, so (-(I+Delta)^2 - shift)^{-1} is exactly diagonal in the
    # 3D cosine basis
    lam1 = 2 * (np.cos(np.pi * np.arange(N) / N) - 1) / h2
    sym = torch.as_tensor(
        -(1.0 + lam1[:, None, None] + lam1[None, :, None]
          + lam1[None, None, :]) ** 2, dtype=torch.float64, device=dev)

    def precond(v, shift=1.0):
        """(sym - shift)^{-1} in the 3D cosine basis; v is a state, a flat
        vector or a block of them; the output keeps v's dtype."""
        x = v.reshape(-1, N, N, N)
        out = idct3(dct3(x) / (sym - shift)).to(v.dtype)
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
