"""Plain reference for `brusselator_po_coll`, in PyTorch and NumPy, from
upstream's definitions and not from the port:

- the Brusselator vector field (upstream `examples/brusselator.jl:26-49`,
  `Fbru`): sites x_i = i h, h = 1/n, Dirichlet ends u = alpha,
  v = beta / alpha, diffusion D / (l h)^2 with the domain length l;
- its jacobian, dense, in closed form;
- orthogonal collocation (upstream
  `src/periodicorbit/PeriodicOrbitCollocation.jl`): Lagrange bases on m + 1
  equispaced nodes of [-1, 1], the m Gauss-Legendre points, the basis's
  derivative by upstream's central difference with step 1e-7 (its
  `compute_legendre_matrices`; the derivative is part of the
  discretization the residual is taken in), a uniform mesh of Ntst
  intervals, the periodicity rows and the integral phase condition against
  the previous orbit;
- the monodromy: each interval's map by a dense solve of its collocation
  block, the maps multiplied in order, the multipliers by `numpy.linalg.eig`.

`check` judges what a window recorded: every point's residual, every
point's arclength row, and the Floquet multipliers at a sample of points.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import common


def vector_field(x, l, cfg):
    """F(x) for states x (..., 2n) = [u; v] at domain length l."""
    n = cfg["sites"]
    a, b = cfg["alpha"], cfg["beta"]
    h = 1.0 / n
    u, v = x[..., :n], x[..., n:]

    def d2(w, edge):
        e = torch.full(w.shape[:-1] + (1,), edge, dtype=w.dtype,
                       device=w.device)
        ext = torch.cat([e, w, e], -1)
        return ext[..., :-2] - 2 * ext[..., 1:-1] + ext[..., 2:]

    c1 = cfg["D1"] / (l * l * h * h)
    c2 = cfg["D2"] / (l * l * h * h)
    fu = c1 * d2(u, a) + a - (b + 1) * u + u * u * v
    fv = c2 * d2(v, b / a) + b * u - u * u * v
    return torch.cat([fu, fv], -1)


def jacobian(x, l, cfg):
    """Dense dF/dx at states x (..., 2n): (..., 2n, 2n)."""
    n = cfg["sites"]
    b = cfg["beta"]
    h = 1.0 / n
    u, v = x[..., :n], x[..., n:]
    D = (torch.diag(torch.full((n,), -2.0, dtype=x.dtype, device=x.device))
         + torch.diag(torch.ones(n - 1, dtype=x.dtype, device=x.device), 1)
         + torch.diag(torch.ones(n - 1, dtype=x.dtype, device=x.device), -1))
    c1 = cfg["D1"] / (l * l * h * h)
    c2 = cfg["D2"] / (l * l * h * h)
    J = torch.zeros(x.shape[:-1] + (2 * n, 2 * n), dtype=x.dtype,
                    device=x.device)
    J[..., :n, :n] = c1 * D + torch.diag_embed(-(b + 1) + 2 * u * v)
    J[..., :n, n:] = torch.diag_embed(u * u)
    J[..., n:, :n] = torch.diag_embed(b - 2 * u * v)
    J[..., n:, n:] = c2 * D + torch.diag_embed(-u * u)
    return J


def legendre(m: int):
    """L, dL ((m+1, m)), Gauss weights (m,), as upstream computes them."""
    sig = np.linspace(-1.0, 1.0, m + 1)
    zg, wg = np.polynomial.legendre.leggauss(m)

    def lag(j, z):
        # left to right, as upstream's `lagrange`: the central difference
        # below turns a rounding of the product into 1e-9 in dL, and 1e-9
        # in dL into 1e-7 in a residual of this size
        out = 1.0
        for k in range(m + 1):
            if k != j:
                out = out * (z - sig[k]) / (sig[j] - sig[k])
        return out

    L = np.array([[lag(j, z) for z in zg] for j in range(m + 1)])
    eps = 1e-7
    dL = np.array([[(lag(j, z + eps) - lag(j, z - eps)) / (2 * eps)
                    for z in zg] for j in range(m + 1)])
    return L, dL, wg


class Orbit:
    """One recorded orbit X = [nodes (Ntst m + 1, 2n) flat, T] at l."""

    def __init__(self, X, l, cfg):
        self.cfg, self.l = cfg, float(l)
        Ntst, m, n2 = cfg["Ntst"], cfg["m"], 2 * cfg["sites"]
        self.Ntst, self.m, self.n2 = Ntst, m, n2
        self.nodes = X[:-1].reshape(Ntst * m + 1, n2)
        self.T = X[-1]
        L, dL, wg = legendre(m)
        kw = dict(dtype=X.dtype, device=X.device)
        self.L, self.dL = torch.as_tensor(L, **kw), torch.as_tensor(dL, **kw)
        self.wg = torch.as_tensor(wg, **kw)
        self.d = 1.0 / Ntst                   # the uniform mesh's interval
        idx = (torch.arange(Ntst)[:, None] * m
               + torch.arange(m + 1)[None, :]).to(X.device)
        self.U = self.nodes[idx]              # (Ntst, m+1, 2n)
        self.P = torch.einsum("li,jln->jin", self.L, self.U)   # Gauss states

    def residual(self, prev=None):
        """The collocation rows, the periodicity rows and, given the
        previous orbit, the phase row."""
        dP = torch.einsum("li,jln->jin", self.dL, self.U)
        F = vector_field(self.P, self.l, self.cfg)
        rows = dP - (self.T * self.d / 2.0) * F
        parts = [rows.reshape(-1), self.nodes[0] - self.nodes[-1]]
        if prev is not None:
            phi = vector_field(prev.P, prev.l, self.cfg)
            phase = torch.sum(self.wg[None, :, None] * (self.P - prev.P)
                              * phi * (self.d / 2.0))
            parts.append(phase.reshape(1))
        return torch.cat(parts)

    def monodromy(self):
        """The product of the intervals' maps, each from its collocation
        block: r_{j,i} = sum_l (dL[l,i] I - a L[l,i] J(p_{j,i})) u_l with
        a = T d / 2 over the local nodes l = 0..m, solved for nodes 1..m
        given node 0."""
        Ntst, m, n = self.Ntst, self.m, self.n2
        Jp = jacobian(self.P, self.l, self.cfg)          # (Ntst, m, n, n)
        a = self.T * self.d / 2.0
        eye = torch.eye(n, dtype=Jp.dtype, device=Jp.device)
        # A[j, i, l] = dL[l, i] I - a L[l, i] J(p_{j,i}), l = 0..m
        A = (self.dL.T[None, :, :, None, None] * eye
             - a * self.L.T[None, :, :, None, None] * Jp[:, :, None])
        rhs = -A[:, :, 0]                                  # (Ntst, m, n, n)
        blk = A[:, :, 1:].permute(0, 1, 3, 2, 4).reshape(Ntst, m * n, m * n)
        sol = torch.linalg.solve(blk, rhs.reshape(Ntst, m * n, n))
        maps = sol[:, -n:, :]
        M = torch.eye(n, dtype=Jp.dtype, device=Jp.device)
        for j in range(Ntst):
            M = maps[j] @ M
        return M


def multipliers(orbit) -> np.ndarray:
    M = orbit.monodromy()
    return np.linalg.eigvals(M.detach().cpu().numpy().astype(np.float64))


def floquet_gap(mu_prog, dense) -> float:
    """Both ways: each program multiplier to the nearest dense one, and
    each of the dense ones of largest modulus, as many, to the nearest
    program multiplier."""
    top = dense[np.argsort(-np.abs(dense))[:len(mu_prog)]]
    g1 = max(float(np.min(np.abs(dense - m))) for m in mu_prog)
    g2 = max(float(np.min(np.abs(mu_prog - d))) for d in top)
    return max(g1, g2)


# each limit lies between the program's largest reading over a dozen
# seeds and the control's smallest (PERF.md gives both); the residual's is
# the configuration's Newton tolerance
LIMITS = {"arclength": 1e-12, "floquet": 1e-7}


def check(cfg, mix, outputs, seed: int,
          control: bool = False) -> list:
    """The compared numbers of a window.  `outputs["points"]` are the
    points the hook saw.  With `control`, the reference in float32 stands
    in the program's place: each point's state as float32 holds it, the
    monodromy computed in float32."""
    cont = mix["continuation"]
    tol = cfg["newton_branch"]["tol"]
    pts = outputs["points"]
    X = [common.as_f32(q["u"].double()) if control else q["u"].double()
         for q in pts]
    orbits = [Orbit(x, q["p"], cfg) for x, q in zip(X, pts)]

    res = []
    for i, (q, o) in enumerate(zip(pts, orbits)):
        prev = orbits[i - 1] if i > 0 and pts[i - 1]["job"] == q["job"] \
            else None
        r = o.residual(prev)
        res.append(float(torch.linalg.vector_norm(r)))
    out = [common.number("residual", max(res) if res else float("inf"),
                         tol, points=len(res))]

    pts_c = [dict(q, u=x) for q, x in zip(pts, X)]
    rows = common.arclength_rows(pts_c, outputs["theta"], cont,
                                 bisects=cont["detect_bifurcation"] == 3)
    out.append(common.number(
        "arclength", max((r for _, r in rows), default=float("inf")),
        LIMITS["arclength"], points=len(rows)))

    # Floquet multipliers at a sample drawn from the seed, with the first
    # and last point of every job
    ends = {0, len(pts) - 1} | {i for i in range(1, len(pts))
                                if pts[i]["job"] != pts[i - 1]["job"]} \
        | {i - 1 for i in range(1, len(pts))
           if pts[i]["job"] != pts[i - 1]["job"]}
    idx = common.sample(len(pts), mix["check"]["floquet_points"], seed,
                        must=sorted(ends)[:mix["check"]["floquet_points"]])
    gaps = []
    for i in idx:
        o = orbits[i]
        dense = multipliers(o)
        mu = np.exp(np.asarray(pts[i]["eigvals"]))
        if control:
            o32 = Orbit(pts[i]["u"].to(torch.float32), pts[i]["p"], cfg)
            mu = np.linalg.eigvals(o32.monodromy().cpu().numpy()
                                   .astype(np.float64))
            mu = mu[np.argsort(-np.abs(mu))[:len(pts[i]["eigvals"])]]
        gaps.append(floquet_gap(mu, dense))
    out.append(common.number("floquet", max(gaps) if gaps else float("inf"),
                             LIMITS["floquet"], points=len(idx)))
    return out
