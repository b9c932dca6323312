"""Plain reference for `sh2d_periodic_512`, in PyTorch, from upstream's
definitions and not from the port: the periodic Swift-Hohenberg residual
F(u) = -(I + Lap)^2 u + l u + nu u^2 - u^3 with the periodic 5-point
Laplacian of the example's finite-difference grid (upstream
`examples/SH2d-fronts-cuda.jl` on the box [-lx, lx) x [-ly, ly)), and its
J.v by the same stencil, and the rightmost eigenvalues of that symmetric
J by a plain block LOBPCG preconditioned with the exact Fourier inverse
of the stencil's linear part.

`check` judges what a window recorded: every point's residual, every
point's arclength row, the program's J.v (through its `sh_jv` kernel, in
float64 as the Krylov solves apply it and in float32 as the eigensolver's
blocks do) at a sample of points, the program's stability count at every
point where it is decided, and every located bifurcation point.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import common


def grid(cfg):
    """(1/hx^2, 1/hy^2) of the periodic box."""
    hx = 2 * cfg["lx"] / cfg["Nx"]
    hy = 2 * cfg["ly"] / cfg["Ny"]
    return 1.0 / (hx * hx), 1.0 / (hy * hy)


def lap(a, cfg):
    """The periodic 5-point Laplacian over the last two axes."""
    ix2, iy2 = grid(cfg)
    return ((torch.roll(a, 1, -2) - 2 * a + torch.roll(a, -1, -2)) * ix2
            + (torch.roll(a, 1, -1) - 2 * a + torch.roll(a, -1, -1)) * iy2)


def L2(a, cfg):
    """(I + Lap)^2 a."""
    w = a + lap(a, cfg)
    return w + lap(w, cfg)


def residual(u, l, cfg):
    nu = cfg["nu"]
    return -L2(u, cfg) + l * u + nu * u * u - u ** 3


def jv(u, l, v, cfg):
    """J(u, l) v for v (..., Nx, Ny), in v's dtype."""
    u = u.to(v.dtype)
    return -L2(v, cfg) + (l + 2 * cfg["nu"] * u - 3 * u * u) * v


def symbol(cfg, device, dtype):
    """The Fourier symbol of (I + Lap)^2 for the periodic 5-point
    Laplacian, on `rfft2`'s half grid."""
    ix2, iy2 = grid(cfg)
    kx = torch.arange(cfg["Nx"], device=device, dtype=dtype)
    ky = torch.arange(cfg["Ny"] // 2 + 1, device=device, dtype=dtype)
    lx = -4 * ix2 * torch.sin(torch.pi * kx / cfg["Nx"]) ** 2
    ly = -4 * iy2 * torch.sin(torch.pi * ky / cfg["Ny"]) ** 2
    return (1 + lx[:, None] + ly[None, :]) ** 2


# rows of a reference eigensolve beyond those it returns
GUARD = 6


def top_eigs(u, l, cfg, k: int, X0=None, tol: float = 1e-7,
             maxiter: int = 400):
    """The `k` rightmost eigenvalues (descending) of the symmetric J(u, l),
    with their eigenvectors as rows, by block LOBPCG in u's dtype to a
    residual of `tol` a pair: each eigenvalue is then within `tol` of
    one of J's.  `X0` (rows) warm-starts the block; random rows fill the
    rest of its k + GUARD."""
    shape, n = tuple(u.shape), u.numel()
    S2 = symbol(cfg, u.device, u.dtype)

    def A(X):
        return jv(u, l, X.reshape((-1,) + shape), cfg).reshape(X.shape[0], n)

    def T(R):
        f = torch.fft.rfft2(R.reshape((-1,) + shape))
        return torch.fft.irfft2(f / (1.0 + S2), s=shape).reshape(R.shape)

    m = k + GUARD
    gen = torch.Generator(device=u.device).manual_seed(0)
    X = torch.randn((m, n), generator=gen, dtype=u.dtype, device=u.device)
    if X0 is not None:
        X[:min(m, X0.shape[0])] = X0[:m]

    def ritz(S):
        Q = torch.linalg.qr(S.T).Q.T        # Householder: orthonormal
        AQ = A(Q)
        w, Y = torch.linalg.eigh(0.5 * (Q @ AQ.T + AQ @ Q.T))
        Y = Y.flip(1)[:, :m]
        return w.flip(0)[:m], Y.T @ Q, Y.T @ AQ

    theta, X, AX = ritz(X)
    P = None
    for _ in range(maxiter):
        R = AX - theta[:, None] * X
        rn = torch.linalg.vector_norm(R, dim=1)
        if bool(torch.all(rn[:k] <= tol)):
            break
        W = T(R)
        S = torch.cat([X, W] + ([P] if P is not None else []))
        theta_n, Xn, AXn = ritz(S)
        P = Xn - (Xn @ X.T) @ X
        theta, X, AX = theta_n, Xn, AXn
    rn = torch.linalg.vector_norm(AX - theta[:, None] * X, dim=1)
    return theta[:k], X[:k], float(rn[:k].max())


def neutral(u, cfg, X) -> np.ndarray:
    """Which rows of X (unit eigenvectors) are the pattern's translation
    modes: more than half of the row lies in the span of du/dx and du/dy
    (spectral derivatives).  On the periodic box J has them at 0 at every
    point (1e-13 in the reference), so they cross nothing."""
    shape = tuple(u.shape)
    f = torch.fft.fft2(u)
    kx = torch.fft.fftfreq(shape[0], device=u.device, dtype=u.dtype)
    ky = torch.fft.fftfreq(shape[1], device=u.device, dtype=u.dtype)
    T = torch.stack([torch.fft.ifft2(1j * kx[:, None] * f).real,
                     torch.fft.ifft2(1j * ky[None, :] * f).real])
    if float(torch.linalg.vector_norm(T)) == 0.0:      # a flat state
        return np.zeros(X.shape[0], dtype=bool)
    Q = torch.linalg.qr(T.reshape(2, -1).T).Q.T
    X = X.to(u.dtype)
    share = torch.sum((X @ Q.T) ** 2, dim=1) \
        / torch.sum(X * X, dim=1)
    return (share > 0.5).cpu().numpy()


def stability(pts, cfg, control: bool):
    """The reference's rightmost eigenvalues at every point, in order,
    each eigensolve warm started from the last: as many as the program
    computed there and GUARD more, with which of them are translation
    modes.  In the control, float32 stands in: each state as float32
    holds it, the eigensolve in float32 to 1e-3."""
    out, X = [], None
    for q in pts:
        k = len(q["eigvals"]) + GUARD
        u = q["u"].to(torch.float32) if control else q["u"].double()
        vals, X, rn = top_eigs(u, q["p"], cfg, k,
                               tol=1e-3 if control else 1e-7,
                               maxiter=60 if control else 400,
                               X0=None if X is None else X.to(u.dtype))
        out.append((vals.double().cpu().numpy(), neutral(u, cfg, X), rn))
    return out


# each limit lies between the program's largest reading over a dozen
# seeds and the control's smallest (PERF.md gives both); the residual's is
# the configuration's Newton tolerance; a stability count is exact (0
# counts outside `count_bounds`): EIG_MARGIN lies above the largest
# eigenvalue that sound runs left uncounted, ROUND is the rounding of an
# eigenvalue at tol_stability
EIG_MARGIN = 0.08
ROUND = 1e-8
LIMITS = {"counts": 0, "located": 1e-2, "arclength": 1e-12, "jv_f64": 1e-10,
          "jv_f32": 1e-4}


def check(cfg, mix, outputs, seed: int,
          control: bool = False) -> list:
    """The compared numbers of a window.  `outputs["points"]` are the
    points the hook saw, `outputs["jv"]` the program's J.v at sampled
    points: (point index, v, J v).  With `control`, the reference in the
    next precision down stands in the program's place: each point's state
    as float32 holds it, J.v by the reference's stencil in float32 (for
    the program's float64 products) and bfloat16 (for its float32 ones)."""
    cont = mix["continuation"]
    tol = cfg["newton_branch"]["tol"]
    pts = outputs["points"]
    U = [common.as_f32(q["u"]) if control else q["u"] for q in pts]

    res = [float(torch.linalg.vector_norm(residual(u, q["p"], cfg)))
           for u, q in zip(U, pts)]
    out = [common.number("residual", max(res) if res else float("inf"),
                         tol, points=len(res))]

    pts_c = [dict(q, u=u) for q, u in zip(pts, U)]
    rows = common.arclength_rows(pts_c, outputs["theta"], cont,
                                 bisects=cont["detect_bifurcation"] == 3)
    out.append(common.number(
        "arclength", max((r for _, r in rows), default=float("inf")),
        LIMITS["arclength"], points=len(rows)))

    # the kernel's J.v, relative to the reference's largest entry
    gaps = {"float64": [], "float32": []}
    low = {"float64": torch.float32, "float32": torch.bfloat16}
    for i, v, got in outputs["jv"]:
        q = pts[i]
        ref = jv(q["u"].double(), q["p"], v.double(), cfg)
        name = str(v.dtype).split(".")[-1]
        if control:
            got = jv(q["u"], q["p"], v.to(low[name]), cfg)
        gaps[name].append(float((got.double() - ref).abs().max()
                                / ref.abs().max()))
    for name in ("float64", "float32"):
        key = "jv_" + name.replace("float", "f")
        out.append(common.number(
            key, max(gaps[name]) if gaps[name] else float("inf"),
            LIMITS[key], points=len(gaps[name])))
    out.extend(stability_numbers(pts, cfg, cont, control))
    return out


def count_bounds(vals, nev: int, tol: float):
    """The stability counts a sound eigensolve of the `nev` rightmost
    eigenvalues may report, from the reference's eigenvalues `vals`
    (descending): Rayleigh-Ritz values lie below the eigenvalues they
    approximate, rank by rank, so it counts no more than the reference
    does above tol (less ROUND, for the rounding of values at tol: the
    translation modes), and, where its values lie within EIG_MARGIN of
    the eigenvalues, no fewer than the reference has above tol +
    EIG_MARGIN."""
    top = np.asarray(vals)[:nev]
    return int(np.sum(top > tol + EIG_MARGIN)), int(np.sum(top > tol - ROUND))


def stability_numbers(pts, cfg, cont, control: bool) -> list:
    """The stability count at every point against the bounds the
    reference's eigenvalues set (`count_bounds`), and at every located
    bifurcation point the reference's eigenvalue nearest 0 but for the
    translation modes (J is singular at a bifurcation point).  In the
    control, the float32 eigensolve's counts stand in the program's."""
    tol = cont.get("tol_stability", 1e-10)
    ref = stability(pts, cfg, False)
    ctl = stability(pts, cfg, True) if control else None
    mism, missed, located, seen = 0, 0.0, [], []
    for i, (q, (vals, neut, _)) in enumerate(zip(pts, ref)):
        nev = len(q["eigvals"])
        n = unstable(ctl[i][0][:nev], tol) if control else q["n_unstable"][0]
        lo, hi = count_bounds(vals, nev, tol)
        mism += int(not lo <= n <= hi)
        # the largest eigenvalue left uncounted: what EIG_MARGIN must cover
        if n < nev and vals[n] > tol:
            missed = max(missed, float(vals[n]))
        near = None
        if any(sp["type"] in BIFURCATIONS for sp in q["special"]):
            near = float(np.min(np.abs(vals[~neut])))
            located.append(near)
        seen.append(dict(p=q["p"], n=n, lo=lo, hi=hi, located=near,
                         neutral=vals[neut].tolist(),
                         ref=vals[:6].tolist(),
                         special=[sp["type"] for sp in q["special"]]))
    return [common.number("counts", mism, LIMITS["counts"], points=len(pts),
                          missed=missed, ref_residual=max(r for *_, r in ref),
                          per_point=seen),
            common.number("located", max(located, default=0.0),
                          LIMITS["located"], points=len(located))]


def unstable(vals, tol_stability: float) -> int:
    return int(np.sum(np.asarray(vals) > tol_stability))


# the types that detection bisects for (a fold is located by detect_fold)
BIFURCATIONS = ("bp", "nd", "hopf")
