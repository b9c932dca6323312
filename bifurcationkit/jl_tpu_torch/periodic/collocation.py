"""Orthogonal collocation periodic-orbit discretization — the port of
`jl_tpu/periodic/collocation.py` (ref
src/periodicorbit/PeriodicOrbitCollocation.jl).

Per coarse-mesh interval j (Ntst intervals), the state is interpolated by
the Lagrange basis on m+1 equispaced nodes sigma in [-1,1] and collocated
at the m Gauss-Legendre points (ref MeshCollocationCache, :23-132):

    residual[j, i] = sum_l dL[l,i] u_{j,l}
                     - (T d_j / 2) F(sum_l L[l,i] u_{j,l})

Unknown X = [nodes (Ntst*m + 1, n) flattened, T]; rows = collocation
(Ntst*m*n) + periodicity (n) + phase (1).

The (m+1, m) Lagrange matrices contract against all intervals in one
einsum, the vector field evaluates over the Ntst*m Gauss points as one
batch (`F_batch`), and the per-node jacobians come from one batched call
(`slice_jacobians`: a batched model's J.v on the identity, else a vmapped
jacfwd).  The per-interval fundamental maps are one batched dense solve.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .. import resolve_device
from .trapezoid import F_batch, slice_jacobians


@lru_cache(maxsize=32)
def legendre_matrices(m: int):
    """L, dL ((m+1, m)), Gauss nodes & weights (m,) — Lagrange basis on the
    equispaced sigma-mesh evaluated at Gauss points (ref
    compute_legendre_matrices, PeriodicOrbitCollocation.jl:90-105).  dL is
    the reference's central difference (eps 1e-7), kept as it is: an exact
    derivative moves it by about 1e-9."""
    sigmas = np.linspace(-1.0, 1.0, m + 1)
    zg, wg = np.polynomial.legendre.leggauss(m)

    def lagrange(i, x):
        l = 1.0
        for k in range(m + 1):
            if k != i:
                l = l * (x - sigmas[k]) / (sigmas[i] - sigmas[k])
        return l

    def dlagrange(i, x, eps=1e-7):
        return (lagrange(i, x + eps) - lagrange(i, x - eps)) / (2 * eps)

    L = np.zeros((m + 1, m))
    dL = np.zeros((m + 1, m))
    for j in range(m + 1):
        for i, z in enumerate(zg):
            L[j, i] = lagrange(j, z)
            dL[j, i] = dlagrange(j, z)
    return L, dL, zg, wg


@lru_cache(maxsize=32)
def legendre_tensors(m: int, dtype: torch.dtype, device: torch.device):
    """(L, dL, wg) of `legendre_matrices` as tensors on `device`."""
    L, dL, _, wg = legendre_matrices(m)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (L, dL, wg))


def gauss_states(L, U):
    """The states at the Gauss points, (Ntst, m, n), of local node blocks
    U (Ntst, m+1, n)."""
    return torch.einsum("li,jln->jin", L, U)


def interval_blocks(L, dL, Jp, alpha):
    """The collocation rows' derivatives per interval: A (Ntst, m n, m n)
    over the local nodes 1..m and B0 (Ntst, m n, n) over local node 0,
    d r_{j,i} / d u_l = dL[l,i] I - alpha_j L[l,i] J(p_{j,i}), from the
    node jacobians Jp (Ntst, m, n, n)."""
    Ntst, m, n, _ = Jp.shape
    eye = torch.eye(n, dtype=Jp.dtype, device=Jp.device)
    a = alpha[:, None, None, None, None]
    blk = (dL[1:, :].T[None, :, :, None, None] * eye
           - a * L[1:, :].T[None, :, :, None, None] * Jp[:, :, None])
    A = blk.permute(0, 1, 3, 2, 4).reshape(Ntst, m * n, m * n)
    B0 = (dL[0, :][None, :, None, None] * eye
          - alpha[:, None, None, None] * L[0, :][None, :, None, None] * Jp)
    return A, B0.reshape(Ntst, m * n, n)


@dataclasses.dataclass(frozen=True)
class Collocation:
    """Discretization config (ref `Collocation`,
    PeriodicOrbitCollocation.jl:212)."""

    Ntst: int = 20
    m: int = 4
    adapt_mesh: bool = False

    @property
    def n_nodes(self) -> int:
        return self.Ntst * self.m + 1

    def unknown_size(self, n: int) -> int:
        return self.n_nodes * n + 1

    def split(self, X, n: int):
        return X[:-1].reshape(self.n_nodes, n), X[-1]

    def pack(self, nodes, T):
        return torch.cat([nodes.reshape(-1), torch.as_tensor(
            T, dtype=nodes.dtype, device=nodes.device).reshape(1)])

    def period(self, X):
        return X[-1]

    def local_nodes(self, nodes):
        """The (Ntst, m+1, n) local node blocks (shared endpoints)."""
        idx = (torch.arange(self.Ntst, device=nodes.device)[:, None] * self.m
               + torch.arange(self.m + 1, device=nodes.device)[None, :])
        return nodes[idx]

    def node_times(self, mesh):
        """Times in [0,1] of every unknown node (ref get_times, :112-131)."""
        m = self.m
        sig = np.linspace(-1.0, 1.0, m + 1)
        mesh = _host(mesh)
        ts = [0.0]
        for j in range(self.Ntst):
            d = mesh[j + 1] - mesh[j]
            for l in range(1, m + 1):
                ts.append(mesh[j] + (sig[l] + 1) / 2 * d)
        return np.asarray(ts)

    # ------------------------------------------------------------------
    def residual(self, prob_vf, X, po_par):
        """po_par = {"_inner", "_uref" (nodes), "_phi" (Ntst, m, n),
        "_mesh" (Ntst+1,)}."""
        L, dL, wg = legendre_tensors(self.m, X.dtype, X.device)
        params = po_par["_inner"]
        mesh = po_par["_mesh"]
        n = po_par["_uref"].shape[1]
        nodes, T = self.split(X, n)
        U = self.local_nodes(nodes)                       # (Ntst, m+1, n)
        d = mesh[1:] - mesh[:-1]                          # (Ntst,)

        p = gauss_states(L, U)
        dp = gauss_states(dL, U)                          # d/dsigma
        Fp = F_batch(prob_vf, p.reshape(-1, n), params).reshape(
            self.Ntst, self.m, n)
        rows = dp - (T * d[:, None, None] / 2.0) * Fp

        per = nodes[0] - nodes[-1]
        pref = gauss_states(L, self.local_nodes(po_par["_uref"]))
        # integral phase condition with Gauss weights (ref :504-547)
        phase = torch.sum(wg[None, :, None] * (p - pref) * po_par["_phi"]
                          * (d[:, None, None] / 2.0))
        return torch.cat([rows.reshape(-1), per, phase.reshape(1)])

    # ------------------------------------------------------------------
    def interval_maps(self, prob_vf, X, po_par):
        """Per-interval fundamental maps M_j: u(tau_j) -> u(tau_{j+1}),
        (Ntst, n, n): one batched dense solve of the interval blocks
        (stage 1 of FloquetColl without the product; FloquetGEV takes
        them as its pencil)."""
        L, dL, _ = legendre_tensors(self.m, X.dtype, X.device)
        params = po_par["_inner"]
        mesh = po_par["_mesh"]
        n = po_par["_uref"].shape[1]
        nodes, T = self.split(X, n)
        p = gauss_states(L, self.local_nodes(nodes))
        Jp = slice_jacobians(prob_vf, p.reshape(-1, n), params).reshape(
            self.Ntst, self.m, n, n)
        A, B0 = interval_blocks(L, dL, Jp, T * (mesh[1:] - mesh[:-1]) / 2.0)
        return torch.linalg.solve(A, -B0)[:, -n:, :]

    def monodromy(self, prob_vf, X, po_par):
        """Floquet monodromy: the interval maps chained in order (ref
        FloquetColl, Floquet.jl:533-760)."""
        maps = self.interval_maps(prob_vf, X, po_par)
        Mn = torch.eye(maps.shape[-1], dtype=maps.dtype, device=maps.device)
        for Mi in maps:
            Mn = Mi @ Mn
        return Mn

    # ------------------------------------------------------------------
    def generate_solution(self, orbit_fn, T, n: int, mesh=None,
                          dtype=torch.float64, device=None):
        """Sample a 2pi-periodic function onto the node mesh (ref
        generate_solution / generate_ci_problem, :369-430).  Samples stay
        on the device `orbit_fn` returns them on; numpy samples go to
        `device` (None means the card)."""
        mesh = np.linspace(0, 1, self.Ntst + 1) if mesh is None else mesh
        samples = [orbit_fn(2 * np.pi * t) for t in self.node_times(mesh)]
        if isinstance(samples[0], torch.Tensor) and device is None:
            device = samples[0].device
        dev = resolve_device(device)
        nodes = torch.stack([torch.as_tensor(s).to(dtype=dtype, device=dev)
                             .reshape(n) for s in samples])
        return self.pack(nodes, T)

    def phase_data(self, prob_vf, nodes, params, mesh):
        """phi at the Gauss points = F(uref) there (Poincare-style integral
        phase condition)."""
        L, _, _ = legendre_tensors(self.m, nodes.dtype, nodes.device)
        n = nodes.shape[1]
        p = gauss_states(L, self.local_nodes(nodes))
        phi = F_batch(prob_vf, p.reshape(-1, n), params).reshape(
            self.Ntst, self.m, n)
        return nodes, phi

    # ------------------------------------------------------------------
    def adapt(self, nodes, mesh, verbose: bool = False):
        """Equidistribute the coarse mesh on the interpolation-error density
        (ref compute_error!, PeriodicOrbitCollocation.jl:1235-1400, de
        Boor), on the host: estimates the m-th derivative per interval from
        the local Lagrange coefficients, equidistributes |u^(m)|^{1/m} h,
        and re-interpolates the nodes onto the new mesh.  Returns
        (new_nodes, new_mesh) as tensors like `nodes`."""
        nodes_np = _host(nodes)
        mesh_np = _host(mesh)
        m = self.m
        sig = np.linspace(-1.0, 1.0, m + 1)
        # m-th divided difference per interval ~ u^(m) / m!
        dens = np.zeros(self.Ntst)
        for j in range(self.Ntst):
            dd = nodes_np[j * m: j * m + m + 1].astype(float)
            for order in range(1, m + 1):
                dd = (dd[1:] - dd[:-1]) / (
                    (sig[order:] - sig[:-order])[:, None])
            scale = (mesh_np[j + 1] - mesh_np[j]) / 2.0
            dens[j] = (np.linalg.norm(dd[0]) / max(scale, 1e-12) ** m
                       ) ** (1.0 / m) + 1e-8
        # equidistribute the integral of the density with a weight floor
        # (each interval keeps >= 30% of the average weight): pure
        # equidistribution starves smooth regions
        w = dens * np.diff(mesh_np)
        w = np.maximum(w, 0.3 * w.mean())
        cum = np.concatenate([[0.0], np.cumsum(w)])
        cum /= cum[-1]
        new_mesh = np.interp(np.linspace(0, 1, self.Ntst + 1), cum, mesh_np)
        new_mesh[0], new_mesh[-1] = 0.0, 1.0
        new_nodes = np.stack([self.interpolate(nodes_np, mesh_np, t)
                              for t in self.node_times(new_mesh)])
        if verbose:
            print(f"[mesh-adapt] h in [{np.diff(new_mesh).min():.4f}, "
                  f"{np.diff(new_mesh).max():.4f}]")
        like = dict(dtype=nodes.dtype, device=nodes.device)
        return (torch.as_tensor(new_nodes, **like),
                torch.as_tensor(new_mesh, **like))

    # ------------------------------------------------------------------
    def interpolate(self, nodes, mesh, t):
        """The collocation polynomial at time t in [0, 1], numpy (ref
        :1196-1233)."""
        mesh = _host(mesh)
        j = int(np.clip(np.searchsorted(mesh, t, side="right") - 1, 0,
                        self.Ntst - 1))
        d = mesh[j + 1] - mesh[j]
        sigma = 2 * (t - mesh[j]) / d - 1.0
        sigmas = np.linspace(-1.0, 1.0, self.m + 1)
        U = _host(nodes)[j * self.m: j * self.m + self.m + 1]
        out = np.zeros(U.shape[1])
        for i in range(self.m + 1):
            li = 1.0
            for k in range(self.m + 1):
                if k != i:
                    li *= (sigma - sigmas[k]) / (sigmas[i] - sigmas[k])
            out = out + li * U[i]
        return out


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
