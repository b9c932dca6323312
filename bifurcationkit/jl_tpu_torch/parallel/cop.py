"""The time-sharded COP solve: the collocation jacobian's intervals split
over the ranks of a mesh axis (`time`), the counterpart of the JAX
package's `periodic/cop.py` solves under a `P("time")` sharding of the
`COPBlocks` (`__graft_entry__.py::dryrun_multichip`, legs 3, 5 and 6).

Each rank holds the rows of its `Ntst / ranks` intervals (`COPShard`)
and runs stage 1 on them alone: the batched LU of the interval blocks and
the batched `lu_solve` of their columns, the O(Ntst (m n)^3) work that is
split.  What the external system needs from each interval (its boundary
map S_j, t_j [, tp_j], the last n rows of G_j, and its share of the phase
and arclength rows) is then gathered over the axis (`mesh.gather_blocks`),
and every rank assembles and solves the small external system, of
(Ntst + 1) n + 1 [+ 1] unknowns, replicated: that dense solve is gathered,
not split.  Each rank back-substitutes its own intervals' local unknowns,
and the node vector is gathered, so every rank returns the whole dX.

The right-hand sides, borders and results are global tensors, the same on
every rank.  The functions take their mesh and axis from the shard, not
from `use_mesh`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..linalg.linear import dense_factor, dense_factor_solve
from ..periodic.cop import COPBlocks, assemble_external
from .mesh import axis_info, gather_blocks, local_block

_FIELDS = ("Aint", "B0", "cT", "phi0", "phiI")


@dataclasses.dataclass
class COPShard:
    """One rank's intervals of a COP jacobian whose intervals are split,
    in order and in equal parts, over the ranks of `axis` of `mesh`:
    `blocks` holds this rank's rows (`blocks.Ntst` of them)."""

    blocks: COPBlocks
    mesh: DeviceMesh
    axis: str = "time"

    @property
    def ranks(self) -> int:
        return axis_info(self.mesh, self.axis)[1]

    @property
    def Ntst(self) -> int:
        """The whole jacobian's number of intervals."""
        return self.blocks.Ntst * self.ranks

    @property
    def first(self) -> int:
        """The index of this rank's first interval."""
        return axis_info(self.mesh, self.axis)[0] * self.blocks.Ntst

    def local_rows(self, rc: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (Ntst, ...) per-interval tensor."""
        return rc[self.first:self.first + self.blocks.Ntst]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The (Ntst, ...) tensor from every rank's (local Ntst, ...)."""
        return gather_blocks(t, self.mesh, self.axis, dim=0)


def shard_blocks(blocks: COPBlocks, mesh: DeviceMesh,
                 axis: str = "time") -> COPShard:
    """This rank's intervals of `blocks` (the whole jacobian, the same on
    every rank), split along dim 0 as `torch.chunk` splits."""
    size = axis_info(mesh, axis)[1]
    assert blocks.Ntst % size == 0, (
        f"{blocks.Ntst} intervals do not split over {size} ranks")
    local = dataclasses.replace(
        blocks, Ntst=blocks.Ntst // size,
        **{f: local_block(mesh, getattr(blocks, f), axis, 0)
           for f in _FIELDS})
    return COPShard(local, mesh, axis)


# the JAX dry run's leg-6 placement on a (time, space) mesh: the dims of
# each field split over `space` (the collocation rows; phi0 has none)
_SPACE_DIM = {"Aint": 1, "B0": 1, "cT": 1, "phi0": None, "phiI": 1}


def place_blocks_2d(blocks: COPBlocks, mesh: DeviceMesh, time: str = "time",
                    space: str = "space") -> COPBlocks:
    """This rank's block of each field of `blocks` (the whole jacobian, on
    every rank) on a (time, space) mesh, as the JAX dry run's leg 6
    places them: the intervals over `time`, and the m n collocation rows
    of `Aint`, `B0`, `cT` and `phiI` over `space` (P("time", "space",
    None), P("time", "space")); `phi0` over `time` only."""
    size = axis_info(mesh, time)[1]
    out = {}
    for f in _FIELDS:
        t = local_block(mesh, getattr(blocks, f), time, 0)
        if _SPACE_DIM[f] is not None:
            t = local_block(mesh, t, space, _SPACE_DIM[f])
        out[f] = t
    return dataclasses.replace(blocks, Ntst=blocks.Ntst // size, **out)


def shard_from_2d(placed: COPBlocks, mesh: DeviceMesh, time: str = "time",
                  space: str = "space") -> COPShard:
    """The `COPShard` over `time` from `place_blocks_2d`'s blocks: each
    rank gathers its intervals' collocation rows over `space` (an
    interval's m n block is not LU-factored in pieces)."""
    full = {f: getattr(placed, f) if _SPACE_DIM[f] is None else
            gather_blocks(getattr(placed, f), mesh, space, _SPACE_DIM[f])
            for f in _FIELDS}
    return COPShard(dataclasses.replace(placed, **full), mesh, time)


def _split_rhs(sh: COPShard, rhs):
    """This rank's collocation rows, the periodicity rows and the phase
    entry of a global rhs [collocation (Ntst m n), periodicity (n),
    phase]."""
    b = sh.blocks
    nc = sh.Ntst * b.m * b.n
    rc = rhs[:nc].reshape(sh.Ntst, b.m * b.n)
    return sh.local_rows(rc), rhs[nc:nc + b.n], rhs[-1]


def _local_weights(sh: COPShard, dzu):
    """The arclength row's weights on this rank's local unknowns (each
    interval's last node rides the external path) and on the boundary
    nodes, from the global border dzu (see `cop._border_reduction`)."""
    b = sh.blocks
    w_nodes = dzu[:-1].reshape(sh.Ntst * b.m + 1, b.n)
    wI = sh.local_rows(w_nodes[1:].reshape(sh.Ntst, b.m * b.n)).clone()
    wI[:, -b.n:] = 0.0
    return wI, w_nodes[::b.m]


def cop_factor_sharded(sh: COPShard, dRc=None, border=None) -> dict:
    """The time-sharded `cop.cop_factor`: stage 1 on this rank's
    intervals (their batched LU and the solves of the node-0, period
    [and parameter] columns), one gather of each interval's boundary
    map, phase-row share [and arclength-row share], then the external
    matrix assembled and factored on every rank.  `dRc` is the global
    (Ntst, m n) parameter column of the collocation rows; `border =
    (dzu, dzp, xi_u, xi_p, dot_scale, dR_per, dR_phase)` as in
    `cop_factor`, dzu global."""
    b = sh.blocks
    n = b.n
    fac = dense_factor(b.Aint)
    cols = [b.B0, b.cT[..., None]]
    bordered = border is not None
    if bordered:
        cols.append(sh.local_rows(dRc)[..., None])
    sol = torch.linalg.lu_solve(*fac, torch.cat(cols, dim=-1))
    H, k = sol[..., :n], sol[..., n]
    kp = sol[..., n + 1] if bordered else None
    # per interval: S_j, t_j, the phase row's coefficient of du_j and its
    # share of the dT coefficient [, tp_j, the phase row's share of the dp
    # coefficient, the arclength row's shares]
    parts = [-H[:, -n:, :].reshape(b.Ntst, n * n), -k[:, -n:],
             b.phi0 - torch.einsum("jr,jrn->jn", b.phiI, H),
             -torch.sum(b.phiI * k, dim=1, keepdim=True)]
    wI = s = None
    if bordered:
        dzu, dzp, xi_u, xi_p, dot_scale, dR_per, dR_phase = border
        wI, w0 = _local_weights(sh, dzu)
        s = torch.as_tensor(xi_u * dot_scale, dtype=H.dtype,
                            device=H.device)
        parts += [kp[:, -n:],
                  -torch.sum(b.phiI * kp, dim=1, keepdim=True),
                  torch.einsum("jr,jrn->jn", wI, H),
                  torch.sum(wI * k, dim=1, keepdim=True),
                  torch.sum(wI * kp, dim=1, keepdim=True)]
    g = sh.gather(torch.cat(parts, dim=1))
    S = g[:, :n * n].reshape(-1, n, n)
    t, ph_du = g[:, n * n:n * n + n], g[:, n * n + n:n * n + 2 * n]
    ph_T = torch.sum(g[:, n * n + 2 * n])
    if not bordered:
        A = assemble_external(S, t, ph_du, ph_T)
    else:
        o = n * n + 2 * n + 1
        tp, ph_p = g[:, o:o + n], torch.sum(g[:, o + n]) + dR_phase
        wH = g[:, o + n + 1:o + 2 * n + 1]
        wk = torch.sum(g[:, o + 2 * n + 1])
        wkp = torch.sum(g[:, o + 2 * n + 2])
        c_du = s * w0
        c_du[:sh.Ntst] -= s * wH
        c_T = s * (dzu[-1] - wk)
        c_p = -s * wkp + xi_p * torch.as_tensor(dzp, dtype=H.dtype,
                                                 device=H.device)
        border_row = torch.cat([c_du.reshape(-1), c_T.reshape(1),
                                c_p.reshape(1)])
        A = assemble_external(S, t, ph_du, ph_T, tp=tp, ph_p=ph_p,
                              dR_per=dR_per, border_row=border_row)
    return dict(fac=fac, H=H, k=k, kp=kp, A_fac=dense_factor(A), wI=wI, s=s)


def cop_factor_solve_sharded(sh: COPShard, F: dict, rhs, rn=None):
    """Solve with a `cop_factor_sharded` factorization (the time-sharded
    `cop.cop_factor_solve`): the triangular solves of this rank's
    intervals, one gather of the pieces of the external rhs, the
    replicated external solve, this rank's back-substitution and one
    gather of the local unknowns.  rhs (and rn) global; returns the
    global (dX, dp_or_None) on every rank."""
    b = sh.blocks
    n, Ntst = b.n, sh.Ntst
    rc, r_per, r_phase = _split_rhs(sh, rhs)
    G = torch.linalg.lu_solve(*F["fac"], rc[..., None])[..., 0]
    bordered = F["kp"] is not None
    parts = [G[:, -n:], torch.sum(b.phiI * G, dim=1, keepdim=True)]
    if bordered:
        parts.append(torch.sum(F["wI"] * G, dim=1, keepdim=True))
    g = sh.gather(torch.cat(parts, dim=1))
    ext = [g[:, :n].reshape(-1), r_per,
           (r_phase - torch.sum(g[:, n])).reshape(1)]
    if bordered:
        rn = torch.as_tensor(rn, dtype=G.dtype, device=G.device)
        ext.append((rn - F["s"] * torch.sum(g[:, n + 1])).reshape(1))
    y = dense_factor_solve(F["A_fac"], torch.cat(ext))
    du_bound = y[:(Ntst + 1) * n].reshape(Ntst + 1, n)
    dT = y[(Ntst + 1) * n]
    dp = y[-1] if bordered else None
    du_loc = (G - torch.einsum("jrn,jn->jr", F["H"], sh.local_rows(du_bound))
              - F["k"] * dT)
    if bordered:
        du_loc = du_loc - F["kp"] * dp
    du_all = sh.gather(du_loc)
    return torch.cat([du_bound[0], du_all.reshape(-1), dT.reshape(1)]), dp


def cop_solve_sharded(sh: COPShard, rhs):
    """The time-sharded `cop.cop_solve`: J dX = rhs, rhs and dX global."""
    return cop_factor_solve_sharded(sh, cop_factor_sharded(sh), rhs)[0]


def cop_solve_bordered_sharded(sh: COPShard, rhs, rn, dR, dzu, dzp,
                               xi_u=1.0, xi_p=1.0, dot_scale=1.0):
    """The time-sharded `cop.cop_solve_bordered` (one condensation of the
    PALC-bordered system); every argument global.  Returns (dX, dp)."""
    b = sh.blocks
    nc = sh.Ntst * b.m * b.n
    dRc = dR[:nc].reshape(sh.Ntst, b.m * b.n)
    F = cop_factor_sharded(sh, dRc, border=(
        dzu, dzp, xi_u, xi_p, dot_scale, dR[nc:nc + b.n], dR[-1]))
    return cop_factor_solve_sharded(sh, F, rhs, rn)


def cop_solve_block_sharded(sh: COPShard, R, C, D, E, s):
    """The time-sharded `cop.cop_solve_block`: one sharded factorization
    serves x1 = J\\R and the k columns X2 = J\\C, then the k x k Schur
    complement E - D X2 is solved on every rank; every argument global.
    Returns (x, y)."""
    F = cop_factor_sharded(sh)
    x1, _ = cop_factor_solve_sharded(sh, F, R)
    X2 = torch.stack([cop_factor_solve_sharded(sh, F, C[:, i])[0]
                      for i in range(C.shape[1])], dim=1)
    y = torch.linalg.solve(E - D @ X2, s - D @ x1)
    return x1 - X2 @ y, y


@dataclasses.dataclass(frozen=True)
class POMinAugLSSharded:
    """`periodic.codim2.POMinAugLS` on a `POMAJac` whose `blocks` are a
    `COPShard`: pd and fold through `cop_solve_bordered_sharded`, ns
    through `cop_solve_block_sharded` (one sharded factorization, k
    column solves, the k x k Schur complement replicated).  The rhs and
    the solution are global."""

    needs_matrix = True

    def __call__(self, J: Any, rhs, a0=0.0, a1=1.0):
        nX = J.dRdp1.shape[0]
        if not J.has_theta:
            dX, dp1 = cop_solve_bordered_sharded(
                J.blocks, rhs[:nX], rhs[nX], J.dRdp1, J.sig_X[0],
                J.sig_p1[0])
            return torch.cat([dX, dp1.reshape(1)]), True, 1
        C = torch.stack([J.dRdp1, torch.zeros_like(J.dRdp1)], dim=1)
        E = torch.stack([J.sig_p1, J.sig_th], dim=1)           # (2, 2)
        x, y = cop_solve_block_sharded(J.blocks, rhs[:nX], C, J.sig_X, E,
                                       rhs[nX:])
        return torch.cat([x, y]), True, 1
