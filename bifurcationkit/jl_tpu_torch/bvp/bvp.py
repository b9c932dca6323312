"""Generic boundary-value problems — the port of `jl_tpu/bvp/bvp.py`
(ref src/bvp/*).

`BVPModel(F, g)` holds the ODE right-hand side u' = F(u, p) on t in
[0, 1] and the boundary-condition functional g(u(0), u(1), p) (n
conditions) (ref BVPModel, src/bvp/BVPModel.jl:34).  Discretizers reuse
the periodic-orbit machinery without the periodicity/phase rows
(ref src/bvp/Discretizers.jl, discretize.jl):

* `BVPCollocation(Ntst, m)` — Gauss-Legendre collocation
  (`periodic/collocation.py::legendre_matrices`),
* `BVPTrapezoid(M)`         — the trapezoid rule,
* `BVPShooting(M)`          — (multiple) shooting on `periodic/flow.py::Flow`.

F and g act on one state; the discretizers apply F to every node in one
`torch.func.vmap`.  `bvp_problem` wraps everything into a standard
BifurcationProblem so the whole continuation stack applies
(ref BVPBifProblem, src/bvp/BVPBifProblem.jl:38).  The unknowns are the
nodes' states, node after node (`X.reshape(-1, n)`), as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import resolve_device
from ..core.lens import Lens, as_lens
from ..core.problem import BifurcationProblem
from ..core.state import ravel
from ..periodic.collocation import Collocation, legendre_tensors
from ..periodic.flow import Flow


@dataclasses.dataclass(frozen=True)
class BVPModel:
    """u' = F(u, p), g(u(0), u(1), p) = 0 (g returns n values)."""

    F: Callable
    g: Callable


def _at_nodes(model: BVPModel, U, params):
    """F at every row of U (k, n)."""
    return vmap(lambda x: model.F(x, params))(U)


def _bc(model: BVPModel, a, b, params):
    return torch.atleast_1d(model.g(a, b, params))


def _mesh_of(mesh, Ntst, like):
    if mesh is None:
        return torch.linspace(0.0, 1.0, Ntst + 1, dtype=like.dtype,
                              device=like.device)
    return torch.as_tensor(mesh, dtype=like.dtype, device=like.device)


def _stack_profile(profile: Callable, ts, device):
    """The profile at every time, as one float64 vector on `device` (the
    card unless told)."""
    prof = np.stack([np.asarray(profile(t), dtype=np.float64) for t in ts])
    return torch.as_tensor(prof.reshape(-1), dtype=torch.float64,
                           device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class BVPCollocation:
    Ntst: int = 20
    m: int = 4
    # de Boor mesh adaptation via the update hook (ref the collocation
    # mesh-adapt path of BVPBifProblem, src/bvp/BVPBifProblem.jl:225-296);
    # run every `adapt_every` accepted steps
    adapt_mesh: bool = False
    adapt_every: int = 5

    @property
    def n_nodes(self):
        return self.Ntst * self.m + 1

    def unknown_size(self, n):
        return self.n_nodes * n

    def local_nodes(self, nodes):
        idx = (torch.arange(self.Ntst, device=nodes.device)[:, None] * self.m
               + torch.arange(self.m + 1, device=nodes.device)[None, :])
        return nodes[idx]

    def _gauss(self, model, X, params, n, mesh):
        """(L, dL, interval lengths, local nodes, Gauss states)."""
        L, dL, _ = legendre_tensors(self.m, X.dtype, X.device)
        nodes = X.reshape(self.n_nodes, n)
        mesh = _mesh_of(mesh, self.Ntst, X)
        d = mesh[1:] - mesh[:-1]
        U = self.local_nodes(nodes)
        p = torch.einsum("li,jln->jin", L, U)
        return L, dL, d, nodes, U, p

    def residual(self, model: BVPModel, X, params, n: int, mesh=None):
        L, dL, d, nodes, U, p = self._gauss(model, X, params, n, mesh)
        dp = torch.einsum("li,jln->jin", dL, U)
        Fp = _at_nodes(model, p.reshape(-1, n), params).reshape(
            self.Ntst, self.m, n)
        rows = dp - (d[:, None, None] / 2.0) * Fp
        bc = _bc(model, nodes[0], nodes[-1], params)
        return torch.cat([rows.reshape(-1), bc])

    def _po_coll(self):
        """Internal periodic-orbit Collocation twin: hosts the shared
        interpolation / de Boor adaptation machinery."""
        return Collocation(Ntst=self.Ntst, m=self.m)

    def node_times(self, mesh):
        mesh = np.asarray(torch.as_tensor(mesh).cpu())
        sig = np.linspace(-1.0, 1.0, self.m + 1)
        ts = [float(mesh[0])]
        for j in range(self.Ntst):
            dd = mesh[j + 1] - mesh[j]
            for l in range(1, self.m + 1):
                ts.append(float(mesh[j] + (sig[l] + 1) / 2 * dd))
        return np.asarray(ts)

    def initial_guess(self, profile: Callable, n: int, device=None):
        ts = self.node_times(np.linspace(0, 1, self.Ntst + 1))
        return _stack_profile(profile, ts, device)

    def times(self, mesh=None):
        if mesh is None:
            mesh = np.linspace(0, 1, self.Ntst + 1)
        return self.node_times(mesh)


@dataclasses.dataclass(frozen=True)
class BVPTrapezoid:
    """Trapezoid-rule BVP discretizer (ref src/bvp trapeze path)."""

    M: int = 50

    def unknown_size(self, n):
        return self.M * n

    def residual(self, model: BVPModel, X, params, n: int):
        u = X.reshape(self.M, n)
        h = 1.0 / (self.M - 1)
        Fu = _at_nodes(model, u, params)
        rows = (u[1:] - u[:-1]) - (h / 2.0) * (Fu[1:] + Fu[:-1])
        bc = _bc(model, u[0], u[-1], params)
        return torch.cat([rows.reshape(-1), bc])

    def initial_guess(self, profile: Callable, n: int, device=None):
        return _stack_profile(profile, self.times(), device)

    def times(self):
        return np.linspace(0, 1, self.M)


@dataclasses.dataclass(frozen=True)
class BVPShooting:
    M: int = 4
    steps_per_segment: int = 60

    def unknown_size(self, n):
        return self.M * n

    def residual(self, model: BVPModel, X, params, n: int):
        u = X.reshape(self.M, n)
        fl = Flow(model.F, steps=self.steps_per_segment)
        ends = fl(u, params, 1.0 / self.M)
        match = (ends[:-1] - u[1:]).reshape(-1)
        bc = _bc(model, u[0], ends[-1], params)
        return torch.cat([match, bc])

    def initial_guess(self, profile: Callable, n: int, device=None):
        return _stack_profile(profile, self.times(), device)

    def times(self):
        return np.linspace(0, 1, self.M, endpoint=False)


def discretize(model: BVPModel, disc, profile: Callable, n: int,
               device=None):
    """Initial guess on the discretization mesh (ref src/bvp/discretize.jl):
    a float64 tensor on `device`, the card unless told."""
    return disc.initial_guess(profile, n, device)


# ---------------------------------------------------------------------------
# analytical block jacobian + condensed solve for BVP collocation
# (ref the collocation jacobian/COP path of src/bvp/collocation/*;
#  the PO machinery minus the period column/phase row, closed by the BC
#  rows dg/du(0), dg/du(1))
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BVPBlocks:
    """Structured BVP collocation jacobian."""

    Aint: Any    # (Ntst, m*n, m*n)
    B0: Any      # (Ntst, m*n, n)
    G0: Any      # (n, n)  dg/du(0)
    G1: Any      # (n, n)  dg/du(1)
    n: int
    m: int
    Ntst: int

    def _interior(self):
        idx = (torch.arange(self.Ntst, device=self.Aint.device)[:, None]
               * self.m
               + torch.arange(1, self.m + 1,
                              device=self.Aint.device)[None, :])
        return idx

    def __call__(self, dX):
        n, m, Ntst = self.n, self.m, self.Ntst
        nodes = dX.reshape(Ntst * m + 1, n)
        loc = nodes[self._interior()].reshape(Ntst, m * n)
        u0 = nodes[:-1:m]
        rows = (torch.einsum("jab,jb->ja", self.Aint, loc)
                + torch.einsum("jan,jn->ja", self.B0, u0))
        bc = self.G0 @ nodes[0] + self.G1 @ nodes[-1]
        return torch.cat([rows.reshape(-1), bc])


def bvp_block_jacobian(disc: BVPCollocation, model: BVPModel, X, params,
                       n: int, mesh=None) -> BVPBlocks:
    """d r_{j,i} / d U_l = dL[l,i] I - (d_j/2) L[l,i] J(p_{j,i}) plus the
    BC rows — the analytical jacobian the reference assembles for BVP
    collocation (src/bvp/collocation)."""
    m, Ntst = disc.m, disc.Ntst
    L, dL, d, nodes, U, p = disc._gauss(model, X, params, n, mesh)
    Jf = vmap(jacfwd(lambda x: model.F(x, params)))(
        p.reshape(-1, n)).reshape(Ntst, m, n, n)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    a = (d / 2.0)[:, None, None, None, None]
    # blkI[j, i, l] = dL[l+1, i] I - a_j L[l+1, i] J_{j,i}
    blkI = (dL[1:, :].T[None, :, :, None, None] * eye
            - a * L[1:, :].T[None, :, :, None, None] * Jf[:, :, None])
    Aint = blkI.permute(0, 1, 3, 2, 4).reshape(Ntst, m * n, m * n)
    a0 = (d / 2.0)[:, None, None, None]
    blk0 = (dL[0, :][None, :, None, None] * eye
            - a0 * L[0, :][None, :, None, None] * Jf)
    B0 = blk0.reshape(Ntst, m * n, n)
    G0 = jacfwd(lambda u: _bc(model, u, nodes[-1], params))(nodes[0])
    G1 = jacfwd(lambda u: _bc(model, nodes[0], u, params))(nodes[-1])
    return BVPBlocks(Aint=Aint, B0=B0, G0=G0, G1=G1, n=n, m=m, Ntst=Ntst)


def bvp_cop_solve(blocks: BVPBlocks, rhs):
    """Condensed solve of the BVP collocation jacobian: one batched
    pivoted LU of the interior blocks (as `cop._stage1`), then a dense
    pivoted external system on the interval boundaries closed by the BC
    rows (the BVP twin of `periodic/cop.py::cop_solve`)."""
    n, m, Ntst = blocks.n, blocks.m, blocks.Ntst
    rc = rhs[:Ntst * m * n].reshape(Ntst, m * n)
    r_bc = rhs[Ntst * m * n:]

    LU, piv = torch.linalg.lu_factor(blocks.Aint)
    sol = torch.linalg.lu_solve(LU, piv,
                                torch.cat([blocks.B0, rc[..., None]], -1))
    H, G = sol[..., :n], sol[..., n]
    S = -H[:, -n:, :]
    h = G[:, -n:]

    dtype, dev = rhs.dtype, rhs.device
    eye = torch.eye(n, dtype=dtype, device=dev)
    jidx = torch.arange(Ntst, device=dev)
    rowsA = torch.zeros((Ntst, n, Ntst + 1, n), dtype=dtype, device=dev)
    rowsA[jidx, :, jidx, :] = -S
    rowsA[jidx, :, jidx + 1, :] += eye
    K = (Ntst + 1) * n
    A = torch.zeros((K, K), dtype=dtype, device=dev)
    A[:Ntst * n, :] = rowsA.reshape(Ntst * n, K)
    A[Ntst * n:, 0:n] = blocks.G0
    A[Ntst * n:, Ntst * n:] += blocks.G1
    b = torch.cat([h.reshape(-1), r_bc])
    du_bound = torch.linalg.solve(A, b).reshape(Ntst + 1, n)

    du_loc = G - torch.einsum("jrn,jn->jr", H, du_bound[:Ntst])
    nodes = torch.empty((Ntst * m + 1, n), dtype=dtype, device=dev)
    nodes[0] = du_bound[0]
    nodes[blocks._interior().reshape(-1)] = du_loc.reshape(-1, n)
    nodes[-1] = du_bound[-1]
    return nodes.reshape(-1)


@dataclasses.dataclass(frozen=True)
class BVPCOPLS:
    """Linear solver consuming BVPBlocks (use with
    bvp_problem(..., use_cop=True))."""

    needs_matrix = True

    def __call__(self, J: BVPBlocks, rhs, a0=0.0, a1=1.0):
        flat, unravel = ravel(rhs)
        return unravel(bvp_cop_solve(J, flat)), True, 1


def bvp_problem(model: BVPModel, disc, X0, params, lens,
                n: Optional[int] = None,
                record_from_solution=None,
                use_cop: bool = False) -> BifurcationProblem:
    """Wrap (model, discretizer) into a BifurcationProblem
    (ref BVPBifProblem, src/bvp/BVPBifProblem.jl:38).

    For BVPCollocation: `use_cop=True` attaches the analytical block
    jacobian + condensed solver (pair with NewtonPar(linsolver=BVPCOPLS())),
    and `disc.adapt_mesh=True` enables de Boor mesh adaptation through the
    update hook (ref BVPBifProblem.jl:225-296) — the mesh then lives in the
    parameters under "_mesh" and the user lens is wrapped.  X0 and the
    parameters give the device and dtype."""
    if n is None:
        raise ValueError("pass n (ODE dimension) explicitly")

    is_coll = isinstance(disc, BVPCollocation)
    adaptive = is_coll and disc.adapt_mesh
    if (use_cop or adaptive) and not is_coll:
        raise ValueError("use_cop / adapt_mesh require BVPCollocation")

    def record(X, p, **k):
        u = X.reshape(-1, n)
        return {"param": p, "norm": torch.linalg.vector_norm(X),
                "max": torch.max(u[:, 0]), "min": torch.min(u[:, 0])}

    record_fn = record_from_solution or record

    if not adaptive:
        def F(X, par):
            return disc.residual(model, X, par, n)

        jac = None
        if use_cop:
            def jac(X, par):
                return bvp_block_jacobian(disc, model, X, par, n)
        return BifurcationProblem(
            F, u0=X0, params=params, lens=lens, jac=jac,
            record_from_solution=record_fn)

    # adaptive-mesh wrap: the mesh rides the parameters
    inner_lens = as_lens(lens)
    par0 = {"_inner": params,
            "_mesh": torch.linspace(0.0, 1.0, disc.Ntst + 1,
                                    dtype=X0.dtype, device=X0.device)}
    wlens = Lens(
        get=lambda par: inner_lens.get(par["_inner"]),
        set=lambda par, v: {**par,
                            "_inner": inner_lens.set(par["_inner"], v)},
        name=f"bvp/{inner_lens.name}")

    def F(X, par):
        return disc.residual(model, X, par["_inner"], n, mesh=par["_mesh"])

    jac = None
    if use_cop:
        def jac(X, par):
            return bvp_block_jacobian(disc, model, X, par["_inner"], n,
                                      mesh=par["_mesh"])

    def update(it, state):
        """Re-equidistribute the mesh on the current solution (de Boor,
        shared with the PO collocation adapt).  The WHOLE continuation
        state (z, z_old, tau) is re-interpolated onto the new mesh so the
        secant tangent stays consistent across the remesh."""
        if state.in_bisection or state.step % disc.adapt_every != 0:
            return None
        par = it.current_params
        old_mesh = par["_mesh"]
        nodes = state.z.u.reshape(disc.n_nodes, n)
        tw = disc._po_coll()
        new_nodes, new_mesh = tw.adapt(nodes, old_mesh)
        times_new = disc.node_times(new_mesh)
        like = state.z.u

        def remap(flat):
            arr = flat.detach().cpu().numpy().reshape(disc.n_nodes, n)
            out = np.stack([tw.interpolate(arr, old_mesh, t)
                            for t in times_new])
            return torch.as_tensor(out.reshape(-1), dtype=like.dtype,
                                   device=like.device)

        state.z = dataclasses.replace(state.z, u=new_nodes.reshape(-1))
        if state.z_old is not None and state.z_old.u.shape == \
                state.z.u.shape:
            state.z_old = dataclasses.replace(state.z_old,
                                              u=remap(state.z_old.u))
        if state.tau is not None:
            state.tau = dataclasses.replace(state.tau, u=remap(state.tau.u))
        return {**par, "_mesh": new_mesh}

    return BifurcationProblem(
        F, u0=X0, params=par0, lens=wlens, jac=jac,
        record_from_solution=record_fn, update=update)
