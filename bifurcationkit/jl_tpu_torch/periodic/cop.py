"""Condensation of parameters — AUTO's collocation linear algebra, the port
of `jl_tpu/periodic/cop.py` (ref src/periodicorbit/cop.jl).

The collocation jacobian has per-interval block structure: interval j's
m*n collocation rows couple the local nodes 0..m (node m is shared with
interval j+1) plus the period column.  COP eliminates the local unknowns
1..m with one batched pivoted LU over all intervals (stage 1, the
reference's blockwise elimination, cop.jl:215), leaving an external
block-bidiagonal system on the interval-boundary unknowns
(du_0..du_Ntst, dT [, dp]) of size (Ntst+1)*n + 1 [+1], solved dense with
pivoting (ref cop.jl:322,484).  Solving the external system directly —
instead of eliminating the boundary unknowns through an unpivoted chain
product P <- S_j P — keeps full accuracy on strongly unstable orbits,
where the chain recursion loses digits exactly like the raw monodromy
product (ref the precision caveat, Floquet.jl:28-31).

`COPBLS` condenses the PALC-bordered system [J dFdp; theta dzu' (1-theta)dzp]
in the same single pass (ref COPBLS, cop.jl:107): the parameter column and
the arclength row ride through stage 1 with the period column, so one
corrector iteration costs one condensation.

Stage 1 factors the (Ntst, m n, m n) blocks with one batched
`torch.linalg.lu_factor` and solves every column it needs (node 0, the
period, the rhs, the parameter) with one batched `lu_solve`; the external
system is one pivoted dense LU.  The mixed-precision solvers factor in a
low dtype and refine against the f64 structured matvec in Python loops.

The PO codim-2 layer adds two solvers: `cop_bc_sigma`, the minimally
augmented test function on the collocation operator closed by a Floquet
boundary condition (complex for Neimark-Sacker, solved in complex128
directly; the JAX package's real 2K embedding is a TPU workaround), with
the adjoint weights its gradient needs; and `cop_solve_block`, the
k-border Schur elimination over one shared COP factorization.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.state import ravel
from ..linalg.bordered import _default_dotp, _dotp_row_scale
from ..linalg.linear import dense_factor, dense_factor_solve, dense_solve
from .collocation import (Collocation, gauss_states, interval_blocks,
                          legendre_tensors)
from .trapezoid import F_batch, slice_jacobians


@dataclasses.dataclass
class COPBlocks:
    """Structured collocation jacobian."""

    Aint: Any    # (Ntst, m*n, m*n)  d rows / d local nodes 1..m
    B0: Any      # (Ntst, m*n, n)    d rows / d local node 0
    cT: Any      # (Ntst, m*n)       d rows / d T
    phi0: Any    # (Ntst, n)         phase-row coeff of local node 0
    phiI: Any    # (Ntst, m*n)       phase-row coeff of local nodes 1..m
    n: int       # vector-field dimension
    m: int
    Ntst: int

    def __call__(self, dX):
        """The matvec J @ dX."""
        n, m, Ntst = self.n, self.m, self.Ntst
        nodes = dX[:-1].reshape(Ntst * m + 1, n)
        loc = nodes[1:].reshape(Ntst, m * n)         # local nodes 1..m
        u0 = nodes[:-1:m]                             # local node 0
        rows = (torch.einsum("jab,jb->ja", self.Aint, loc)
                + torch.einsum("jan,jn->ja", self.B0, u0)
                + self.cT * dX[-1])
        per = nodes[0] - nodes[-1]
        phase = torch.sum(self.phi0 * u0) + torch.sum(self.phiI * loc)
        return torch.cat([rows.reshape(-1), per, phase.reshape(1)])


def collocation_block_jacobian(disc: Collocation, prob_vf, X, po_par
                               ) -> COPBlocks:
    """Analytical block jacobian (ref po_analytical_jacobian,
    PeriodicOrbitCollocation.jl:646-905):
    d r_{j,i} / d u_l = dL[l,i] I - alpha_j L[l,i] J(p_{j,i})."""
    L, dL, wg = legendre_tensors(disc.m, X.dtype, X.device)
    params = po_par["_inner"]
    mesh = po_par["_mesh"]
    n = po_par["_uref"].shape[1]
    m, Ntst = disc.m, disc.Ntst
    nodes, T = disc.split(X, n)
    d = mesh[1:] - mesh[:-1]

    P = gauss_states(L, disc.local_nodes(nodes)).reshape(-1, n)
    Jp = slice_jacobians(prob_vf, P, params).reshape(Ntst, m, n, n)
    Fp = F_batch(prob_vf, P, params).reshape(Ntst, m, n)
    Aint, B0 = interval_blocks(L, dL, Jp, T * d / 2.0)
    cT = (-(d[:, None, None] / 2.0) * Fp).reshape(Ntst, m * n)

    # phase row: phi(X) = sum_{j,i} w_i (d_j/2) <p_ji - pref_ji, phi_ji>
    # d/d u_l = sum_i w_i (d_j/2) L[l, i] phi_{j,i}
    coeff = torch.einsum("i,li,jin->jln", wg, L, po_par["_phi"]) * (
        d[:, None, None] / 2.0)                           # (Ntst, m+1, n)
    return COPBlocks(Aint=Aint, B0=B0, cT=cT, phi0=coeff[:, 0, :],
                     phiI=coeff[:, 1:, :].reshape(Ntst, m * n),
                     n=n, m=m, Ntst=Ntst)


def ravel_vf(prob_vf, x, params):
    return ravel(prob_vf.F(x, params))[0]


def _stage1(blocks: COPBlocks, rc, dRc=None):
    """Batched pivoted elimination of the interior collocation unknowns
    (ref condensation_of_parameters2!, cop.jl:215): one batched LU of the
    (m n) blocks and one batched triangular solve of the node-0 column,
    the period column, the rhs and optionally the continuation-parameter
    column.  The last n rows of each reduced quantity give the boundary
    map du_{j+1} = h_j + S_j du_j + t_j dT [+ tp_j dp].
    Returns (H, k, G, kp, factorization)."""
    n = blocks.n
    fac = dense_factor(blocks.Aint)
    cols = [blocks.B0, blocks.cT[..., None], rc[..., None]]
    if dRc is not None:
        cols.append(dRc[..., None])
    sol = torch.linalg.lu_solve(*fac, torch.cat(cols, dim=-1))
    H, k, G = sol[..., :n], sol[..., n], sol[..., n + 1]
    kp = sol[..., n + 2] if dRc is not None else None
    return H, k, G, kp, fac


def cop_interval_maps(blocks: COPBlocks):
    """Per-interval fundamental maps S_j (the B_j^-1 A_j couples of the
    reference's FloquetColl stage, Floquet.jl:625-659):
    du_{j+1} = S_j du_j on the homogeneous system."""
    fac = dense_factor(blocks.Aint)
    H = torch.linalg.lu_solve(*fac, blocks.B0)
    return -H[:, -blocks.n:, :]                      # (Ntst, n, n)


def _external_matrix(blocks: COPBlocks, H, k, kp=None, dR_per=None,
                     dR_phase=None, border_row=None):
    """Assemble the (rhs-independent) external matrix on the boundary
    unknowns y = [du_0..du_Ntst, dT (, dp)] (ref build_external_system!,
    cop.jl:322) from stage 1's reduced couplings (`assemble_external`)."""
    n = blocks.n
    bordered = border_row is not None
    return assemble_external(
        -H[:, -n:, :], -k[:, -n:],
        blocks.phi0 - torch.einsum("jr,jrn->jn", blocks.phiI, H),
        -torch.sum(blocks.phiI * k),
        tp=kp[:, -n:] if bordered else None,
        ph_p=(-torch.sum(blocks.phiI * kp) + dR_phase) if bordered
        else None, dR_per=dR_per, border_row=border_row)


def assemble_external(S, t, ph_du, ph_T, tp=None, ph_p=None, dR_per=None,
                      border_row=None):
    """The external matrix from each interval's boundary map
    du_{j+1} = S_j du_j + t_j dT [- tp_j dp] + ... (S (Ntst, n, n), t and
    tp (Ntst, n)) and the phase row reduced over the local unknowns
    (ph_du (Ntst, n) on du_0..du_{Ntst-1}, ph_T on dT, ph_p on dp).  Rows:
    Ntst coupling blocks du_{j+1} - S_j du_j - t_j dT (- tp_j dp), n
    periodicity rows, the phase row, and optionally the PALC arclength
    row pre-reduced over the local unknowns (`border_row`)."""
    Ntst, n = t.shape
    bordered = border_row is not None
    nb = (Ntst + 1) * n
    Next = nb + 1 + (1 if bordered else 0)
    A = torch.zeros((Next, Next), dtype=S.dtype, device=S.device)
    eye = torch.eye(n, dtype=S.dtype, device=S.device)

    # the coupling block rows, scattered through a (Ntst, n, Ntst+1, n)
    # view of A's top-left corner
    C = A[:Ntst * n, :nb].unflatten(0, (Ntst, n)).unflatten(2, (Ntst + 1, n))
    jidx = torch.arange(Ntst, device=S.device)
    C[jidx, :, jidx, :] = -S
    C[jidx, :, jidx + 1, :] = eye
    A[:Ntst * n, nb] = -t.reshape(-1)
    A[Ntst * n:nb, :n] = eye
    A[Ntst * n:nb, Ntst * n:nb] -= eye

    # the phase row after substituting the local unknowns:
    # coeff(du_j) = phi0_j - phiI_j H_j; coeff(dT) = sum_j -phiI_j k_j
    A[nb, :Ntst * n] = ph_du.reshape(-1)
    A[nb, nb] = ph_T

    if bordered:
        pcol = Next - 1
        A[:Ntst * n, pcol] = tp.reshape(-1)
        A[Ntst * n:nb, pcol] = dR_per
        A[nb, pcol] = ph_p
        A[pcol, :] = border_row
    return A


def _external_b(blocks: COPBlocks, G, r_per, r_phase, border_rhs=None):
    """The rhs of the external system for a reduced rhs G (the constant
    parts of the phase row move here)."""
    n = blocks.n
    parts = [G[:, -n:].reshape(-1), r_per,
             (r_phase - torch.sum(blocks.phiI * G)).reshape(1)]
    if border_rhs is not None:
        parts.append(torch.as_tensor(border_rhs, dtype=G.dtype,
                                     device=G.device).reshape(1))
    return torch.cat(parts)


def _external_system(blocks: COPBlocks, H, k, G, kp, r_per, r_phase,
                     dR_per=None, dR_phase=None,
                     border_row=None, border_rhs=None):
    """Assemble and solve the external system (ref cop.jl:322,484).
    Returns (du_bound (Ntst+1, n), dT, dp_or_None)."""
    n, Ntst = blocks.n, blocks.Ntst
    bordered = border_row is not None
    A = _external_matrix(blocks, H, k, kp, dR_per, dR_phase, border_row)
    b = _external_b(blocks, G, r_per, r_phase,
                    border_rhs if bordered else None)
    y = dense_solve(A, b)
    du_bound = y[:(Ntst + 1) * n].reshape(Ntst + 1, n)
    return du_bound, y[(Ntst + 1) * n], (y[-1] if bordered else None)


def _assemble_nodes(blocks: COPBlocks, H, k, G, kp, du_bound, dT, dp=None):
    """Back-substitution (batched): the local unknowns from the boundary
    solution, then the node vector in Collocation layout."""
    n, Ntst = blocks.n, blocks.Ntst
    du_loc = (G - torch.einsum("jrn,jn->jr", H, du_bound[:Ntst])
              - k * dT)                                      # (Ntst, m*n)
    if dp is not None:
        du_loc = du_loc - kp * dp
    # local nodes 1..m of interval j are the global nodes j*m+1..j*m+m
    return torch.cat([du_bound[0], du_loc.reshape(-1), dT.reshape(1)])


def _split_rhs(blocks: COPBlocks, rhs):
    n, m, Ntst = blocks.n, blocks.m, blocks.Ntst
    return (rhs[:Ntst * m * n].reshape(Ntst, m * n),
            rhs[Ntst * m * n: Ntst * m * n + n], rhs[-1])


def cop_solve(blocks: COPBlocks, rhs):
    """Solve J dX = rhs for the collocation jacobian in COP form.  rhs
    layout as Collocation.residual: [collocation rows (Ntst*m*n),
    periodicity (n), phase (1)]; returns dX = [nodes (Ntst*m+1)*n, dT]."""
    rc, r_per, r_phase = _split_rhs(blocks, rhs)
    H, k, G, _, _ = _stage1(blocks, rc)
    du_bound, dT, _ = _external_system(blocks, H, k, G, None, r_per,
                                       r_phase)
    return _assemble_nodes(blocks, H, k, G, None, du_bound, dT)


def _border_reduction(blocks: COPBlocks, H, k, kp, dzu, dzp, xi_u, xi_p,
                      dot_scale):
    """Reduce the PALC arclength row over the local unknowns (its
    rhs-independent part): returns (border_row, wI, s); the G-dependent
    constant is applied per solve (`- s * <wI, G>`)."""
    n, m, Ntst = blocks.n, blocks.m, blocks.Ntst
    dtype = H.dtype
    w_nodes = dzu[:-1].reshape(Ntst * m + 1, n)
    w0 = w_nodes[::m]                                      # (Ntst+1, n)
    # each boundary node (j+1)*m is both interval j's m-th local unknown
    # and the external unknown du_{j+1}; its weight enters once — through
    # the external (w0) path
    wI = w_nodes[1:].reshape(Ntst, m * n).clone()
    wI[:, -n:] = 0.0
    # every scalar at the factorization dtype
    s = torch.as_tensor(xi_u * dot_scale, dtype=dtype, device=H.device)
    c_du = s * w0
    c_du[:Ntst] -= s * torch.einsum("jr,jrn->jn", wI, H)
    c_T = s * (dzu[-1] - torch.sum(wI * k))
    c_p = -s * torch.sum(wI * kp) + xi_p * torch.as_tensor(
        dzp, dtype=dtype, device=H.device)
    border_row = torch.cat([c_du.reshape(-1), c_T.reshape(1),
                            c_p.reshape(1)])
    return border_row, wI, s


def cop_solve_bordered(blocks: COPBlocks, rhs, rn, dR, dzu, dzp,
                       xi_u=1.0, xi_p=1.0, dot_scale=1.0):
    """One-pass bordered condensation (ref COPBLS, cop.jl:107): solve

        | J      dR  | |dX|   |rhs|
        | c^T    cp  | |dp| = |rn |

    with c = xi_u * dot_scale * dzu (over all unknowns incl. T) and
    cp = xi_p * dzp.  Returns (dX, dp)."""
    rc, r_per, r_phase = _split_rhs(blocks, rhs)
    dRc, dR_per, dR_phase = _split_rhs(blocks, dR)
    H, k, G, kp, _ = _stage1(blocks, rc, dRc)
    border_row, wI, s = _border_reduction(blocks, H, k, kp, dzu, dzp,
                                          xi_u, xi_p, dot_scale)
    border_rhs = rn - s * torch.sum(wI * G)
    du_bound, dT, dp = _external_system(
        blocks, H, k, G, kp, r_per, r_phase,
        dR_per=dR_per, dR_phase=dR_phase,
        border_row=border_row, border_rhs=border_rhs)
    return _assemble_nodes(blocks, H, k, G, kp, du_bound, dT, dp), dp


def _cast_blocks(blocks: COPBlocks, dt) -> COPBlocks:
    return dataclasses.replace(
        blocks, **{f: getattr(blocks, f).to(dt)
                   for f in ("Aint", "B0", "cT", "phi0", "phiI")})


def cop_factor(blocks: COPBlocks, dRc=None, border=None):
    """Reusable COP factorization at a fixed jacobian: the batched pivoted
    block LU, the reduced couplings (H, k [, kp]) and the factored external
    matrix.  `border = (dzu_flat, dzp, xi_u, xi_p, dot_scale, dR_per,
    dR_phase)` adds the PALC parameter column and the pre-reduced
    arclength row.  Factored once in a low dtype, each solve is refined
    against the f64 structured matvec (`cop_solve_mixed`)."""
    zeros = torch.zeros_like(blocks.cT)
    H, k, _, kp, fac = _stage1(blocks, zeros, dRc)
    border_row = wI = s = dR_per = dR_phase = None
    if border is not None:
        dzu, dzp, xi_u, xi_p, dot_scale, dR_per, dR_phase = border
        border_row, wI, s = _border_reduction(blocks, H, k, kp, dzu, dzp,
                                              xi_u, xi_p, dot_scale)
    A = _external_matrix(blocks, H, k, kp, dR_per, dR_phase, border_row)
    return dict(fac=fac, H=H, k=k, kp=kp, A_fac=dense_factor(A), wI=wI, s=s)


def cop_factor_solve(blocks: COPBlocks, F, rhs, rn=None):
    """Solve with a `cop_factor` factorization: triangular solves, the
    small external back-substitution and the node assembly, no new
    factorization.  Returns (dX, dp_or_None)."""
    n, Ntst = blocks.n, blocks.Ntst
    rc, r_per, r_phase = _split_rhs(blocks, rhs)
    G = torch.linalg.lu_solve(*F["fac"], rc[..., None])[..., 0]
    bordered = F["kp"] is not None
    border_rhs = (rn - F["s"] * torch.sum(F["wI"] * G)) if bordered \
        else None
    y = dense_factor_solve(F["A_fac"],
                           _external_b(blocks, G, r_per, r_phase, border_rhs))
    du_bound = y[:(Ntst + 1) * n].reshape(Ntst + 1, n)
    dT = y[(Ntst + 1) * n]
    dp = y[-1] if bordered else None
    return _assemble_nodes(blocks, F["H"], F["k"], G, F["kp"], du_bound, dT,
                           dp), dp


def cop_factor_solve_adjoint(blocks: COPBlocks, F, b):
    """Solve J^T y = b with an (unbordered) `cop_factor` factorization:
    the condensation's steps transposed, in reverse order, on the same
    LU factors (no new factorization).  b over the unknowns
    [nodes (Ntst*m+1)*n, T]; y over the rows [collocation (Ntst*m*n),
    periodicity (n), phase (1)]."""
    n, m, Ntst = blocks.n, blocks.m, blocks.Ntst
    H, k = F["H"], F["k"]
    bn = b[:-1].reshape(Ntst * m + 1, n)
    # node assembly x = [du_0, G - H du_j - k dT (local nodes), dT]
    gG = bn[1:].reshape(Ntst, m * n)
    gdu = torch.cat([bn[:1] - torch.einsum("jrn,jr->jn", H[:1], gG[:1]),
                     -torch.einsum("jrn,jr->jn", H[1:], gG[1:]),
                     torch.zeros_like(bn[:1])])
    gdT = b[-1] - torch.sum(k * gG)
    # the external solve
    LU, piv = F["A_fac"]
    z = torch.linalg.lu_solve(LU, piv, torch.cat(
        [gdu.reshape(-1), gdT.reshape(1)])[:, None], adjoint=True)[:, 0]
    # the external rhs [G_j's last n, r_per, r_phase - <phiI, G>]
    z_c, z_per, z_ph = (z[:Ntst * n].reshape(Ntst, n),
                        z[Ntst * n:(Ntst + 1) * n], z[-1])
    gG = gG - z_ph * blocks.phiI + torch.cat(
        [torch.zeros_like(gG[:, :-n]), z_c], dim=1)
    # G = Aint^-1 rc
    yc = torch.linalg.lu_solve(*F["fac"], gG[..., None], adjoint=True)
    return torch.cat([yc.reshape(-1), z_per, z_ph.reshape(1)])


def cop_solve_mixed(blocks: COPBlocks, rhs, low_dtype=torch.float32,
                    refinements: int = 3, rtol: float = 1e-10,
                    atol: float = 1e-13):
    """Mixed-precision COP solve: one factorization in `low_dtype`
    (stage 1 and the external LU) and f64 residual refinement through the
    structured matvec.  Returns (x, converged)."""
    lo = low_dtype
    blo = _cast_blocks(blocks, lo)
    F = cop_factor(blo)
    x = cop_factor_solve(blo, F, rhs.to(lo))[0].to(rhs.dtype)
    tol = max(rtol * float(torch.linalg.vector_norm(rhs)), atol)
    rn = float(torch.linalg.vector_norm(rhs - blocks(x)))
    kk = 0
    while rn > tol and kk < refinements:
        d, _ = cop_factor_solve(blo, F, (rhs - blocks(x)).to(lo))
        x = x + d.to(rhs.dtype)
        rn = float(torch.linalg.vector_norm(rhs - blocks(x)))
        kk += 1
    return x, rn <= tol


def cop_solve_bordered_mixed(blocks: COPBlocks, rhs, rn_s, dR, dzu, dzp,
                             xi_u=1.0, xi_p=1.0, dot_scale=1.0,
                             low_dtype=torch.float32, refinements: int = 3,
                             rtol: float = 1e-10, atol: float = 1e-13):
    """Mixed-precision one-pass bordered condensation (the COPBLS analogue
    of `cop_solve_mixed`): the low-dtype factorization carries the
    parameter column and the pre-reduced arclength row; refinement
    measures the full bordered residual [J dX + dR dp - rhs;
    <c,dX> + cp dp - rn].  Returns (dX, dp, converged)."""
    lo = low_dtype
    dt = rhs.dtype
    blo = _cast_blocks(blocks, lo)
    dRc, dR_per, dR_phase = _split_rhs(blocks, dR)
    F = cop_factor(blo, dRc.to(lo),
                   border=(dzu.to(lo), float(dzp), xi_u, xi_p, dot_scale,
                           dR_per.to(lo), dR_phase.to(lo)))
    x0, dp0 = cop_factor_solve(blo, F, rhs.to(lo),
                               rn=torch.as_tensor(rn_s).to(lo))
    x, dp = x0.to(dt), dp0.to(dt)
    sclu = xi_u * dot_scale

    def resid(x, dp):
        top = rhs - blocks(x) - dp * dR
        bot = rn_s - sclu * torch.dot(dzu, x) - xi_p * dzp * dp
        return top, bot, max(float(torch.linalg.vector_norm(top)),
                             abs(float(bot)))

    tol = max(rtol * max(float(torch.linalg.vector_norm(rhs)),
                         abs(float(rn_s))), atol)
    top, bot, rnorm = resid(x, dp)
    kk = 0
    while rnorm > tol and kk < refinements:
        d, ddp = cop_factor_solve(blo, F, top.to(lo), rn=bot.to(lo))
        x = x + d.to(dt)
        dp = dp + ddp.to(dt)
        top, bot, rnorm = resid(x, dp)
        kk += 1
    return x, dp, rnorm <= tol


@dataclasses.dataclass(frozen=True)
class COPLS:
    """Linear solver consuming the structured `COPBlocks` jacobian (ref
    COPLS, cop.jl:85).  Use via `periodic_orbit_problem(..., use_cop=True)`
    and `NewtonPar(linsolver=COPLS())`.  `low_dtype=torch.float32`
    switches to the mixed-precision solve (low-dtype stage-1 and external
    factorizations, f64 residual refinement through the structured
    matvec)."""

    needs_matrix = True   # Newton asks prob.jacobian for the blocks
    low_dtype: Any = None
    refinements: int = 3
    rtol: float = 1e-10
    atol: float = 1e-13

    def __call__(self, J: COPBlocks, rhs, a0=0.0, a1=1.0):
        flat, unravel = ravel(rhs)
        if self.low_dtype is not None:
            sol, cv = cop_solve_mixed(J, flat, low_dtype=self.low_dtype,
                                      refinements=self.refinements,
                                      rtol=self.rtol, atol=self.atol)
            return unravel(sol), cv, 1 + self.refinements
        return unravel(cop_solve(J, flat)), True, 1


@dataclasses.dataclass(frozen=True)
class COPBLS:
    """Bordered linear solver doing one condensation for the whole PALC
    system (ref COPBLS, cop.jl:107) — the drop-in for BorderingBLS when
    the jacobian is `COPBlocks`; `continuation_po(..., use_cop=True)` wires
    it.  `low_dtype=torch.float32` is the mixed-precision condensation
    (see COPLS)."""

    needs_matrix = True
    low_dtype: Any = None
    refinements: int = 3
    rtol: float = 1e-10
    atol: float = 1e-13

    def __call__(self, J: COPBlocks, dR, dzu, dzp, R, n, xi_u=1.0,
                 xi_p=1.0, shift=None, dotp=None):
        if shift is not None:
            raise NotImplementedError("COPBLS does not support shifts")
        dR_flat, _ = ravel(dR)
        dzu_flat, unravel_state = ravel(dzu)
        R_flat, _ = ravel(R)
        scale = _dotp_row_scale(dotp or _default_dotp, dzu,
                                dzu_flat.shape[0])
        if self.low_dtype is not None:
            dX, dp, cv = cop_solve_bordered_mixed(
                J, R_flat, n, dR_flat, dzu_flat, dzp, xi_u=xi_u, xi_p=xi_p,
                dot_scale=scale, low_dtype=self.low_dtype,
                refinements=self.refinements, rtol=self.rtol,
                atol=self.atol)
            return unravel_state(dX), dp, cv, 1 + self.refinements
        dX, dp = cop_solve_bordered(J, R_flat, n, dR_flat, dzu_flat, dzp,
                                    xi_u=xi_u, xi_p=xi_p, dot_scale=scale)
        return unravel_state(dX), dp, True, 1


# ---------------------------------------------------------------------------
# the PO codim-2 solvers
# ---------------------------------------------------------------------------


def cop_bc_sigma(blocks: COPBlocks, a_res, b_unk, s_re, s_im=0.0,
                 adjoint: bool = False):
    """Minimally augmented test function on the discretized variational
    operator (the matrix-free PO codim-2 core, ref MinAugPD.jl:35-257 /
    MinAugNS.jl:36-236, which formulate sigma on the full collocation
    problem, not on the dense monodromy): solve

        [ A_bc   a ] [v]   [0]
        [ b^H    0 ] [sig] [1]

    where A_bc is the collocation linearization (the interior blocks Aint
    and B0, no period column) closed by the Floquet boundary condition
    du_Ntst = s du_0, s = s_re + i s_im: singular exactly when s is a
    Floquet multiplier (s = -1: period doubling; s = e^{i theta}:
    Neimark-Sacker).

    Stage 1 stays real (the blocks are real; a complex border column rides
    as its real and imaginary parts); the external system on
    [du_0..du_Ntst, sig] is solved in complex128 when s or a border is
    complex, else in the blocks' dtype.  It is assembled out of place, so
    `torch.func` differentiates through the whole solve.

    a_res: border column over the rows [collocation (Ntst*m*n), boundary
    (n)]; b_unk: border row over the node unknowns ((Ntst*m+1)*n).
    Returns (sig_re, sig_im, v_re, v_im) with v over the nodes; with
    `adjoint=True` also (Wc, Wb), the weights of the linear functional
    r -> sig(r) that the solve with right-hand side [r; 0] would give on
    the collocation rows ((Ntst, m, n)) and the boundary rows ((n,)):
    d sig = -(Wc . dA_c v + Wb . dA_b v) for a change dA of A_bc."""
    n, m, Ntst = blocks.n, blocks.m, blocks.Ntst
    rdt = blocks.Aint.dtype
    dev = blocks.Aint.device
    from ..codim2.minaug import _is_complex

    real_case = (not isinstance(s_im, torch.Tensor) and float(s_im) == 0.0
                 and not _is_complex(a_res) and not _is_complex(b_unk))
    dt = rdt if real_case else (torch.complex128 if rdt == torch.float64
                                else torch.complex64)
    nc = Ntst * m * n
    a_c = a_res[:nc].reshape(Ntst, m * n)
    a_b = a_res[nc:]

    fac = dense_factor(blocks.Aint)
    cols = [blocks.B0, torch.real(a_c).to(rdt)[..., None]]
    if not real_case:
        cols.append(torch.imag(a_c).to(rdt)[..., None] if _is_complex(a_c)
                    else torch.zeros_like(cols[-1]))
    sol = torch.linalg.lu_solve(*fac, torch.cat(cols, dim=-1))
    H = sol[..., :n]
    ka = sol[..., n] if real_case else torch.complex(sol[..., n],
                                                     sol[..., n + 1])
    S = -H[:, -n:, :]
    t = -ka[:, -n:]

    # the border row b^H v over the local unknowns
    # (du_loc_j = -H_j du_j - ka_j sig); the right-boundary weights ride
    # the external path (see cop_solve_bordered)
    w_nodes = torch.conj(b_unk).to(dt).reshape(Ntst * m + 1, n)
    w0 = w_nodes[::m]
    wI = torch.cat([w_nodes[1:].reshape(Ntst, m * n)[:, :-n],
                    torch.zeros((Ntst, n), dtype=dt, device=dev)], dim=1)
    Hd = H.to(dt)
    c_du = w0 - torch.cat([torch.einsum("jr,jrn->jn", wI, Hd),
                           torch.zeros((1, n), dtype=dt, device=dev)])
    c_sig = -torch.sum(wI * ka)

    # the external system on y = [du_0..du_Ntst, sig], K unknowns
    K = (Ntst + 1) * n + 1
    eye = torch.eye(n, dtype=dt, device=dev)
    zc = torch.zeros((Ntst * n, n), dtype=dt, device=dev)
    coupling = (torch.cat([torch.block_diag(*(-S.to(dt))), zc], dim=1)
                + torch.cat([zc, torch.eye(Ntst * n, dtype=dt, device=dev)],
                            dim=1))
    s = (torch.as_tensor(s_re, device=dev).to(dt) if real_case
         else torch.complex(torch.as_tensor(s_re, dtype=rdt, device=dev),
                            torch.as_tensor(s_im, dtype=rdt, device=dev)))
    bound = torch.cat([-s * eye, torch.zeros((n, (Ntst - 1) * n), dtype=dt,
                                             device=dev), eye,
                       a_b.to(dt)[:, None]], dim=1)
    Mx = torch.cat([
        torch.cat([coupling, -t.reshape(-1, 1).to(dt)], dim=1),
        bound,
        torch.cat([c_du.reshape(1, -1), c_sig.reshape(1, 1)], dim=1)])
    e = torch.zeros((K,), dtype=dt, device=dev)
    e = torch.cat([e[:-1], torch.ones((1,), dtype=dt, device=dev)])
    # one factorization of the external matrix for sigma and, with
    # `adjoint`, for z = Mx^-T e (Mx^T z = e is conj(z) = Mx^-H e, e real)
    Mx_fac = torch.linalg.lu_factor(Mx)
    y = torch.linalg.lu_solve(*Mx_fac, e[:, None])[:, 0]
    du = y[:-1].reshape(Ntst + 1, n)
    sig = y[-1]
    vloc = -torch.einsum("jrn,jn->jr", Hd, du[:Ntst]) - ka * sig
    v = torch.cat([du[0], vloc.reshape(-1)[:-n], du[-1]])
    out = (torch.real(sig), torch.imag(sig) if not real_case
           else torch.zeros_like(sig), torch.real(v),
           torch.imag(v) if not real_case else torch.zeros_like(v))
    if not adjoint:
        return out
    # sig(r) = z^T b_ext(r) with z = Mx^-T e; the collocation part
    # sum_j c_j . Aint_j^-1 r_j turns into the weights Aint_j^-T c_j
    z = torch.conj_physical(torch.linalg.lu_solve(
        *Mx_fac, e[:, None], adjoint=True)[:, 0])
    zc_, zb, zK = z[:Ntst * n].reshape(Ntst, n), z[Ntst * n:-1], z[-1]
    c = torch.cat([torch.zeros((Ntst, (m - 1) * n), dtype=dt, device=dev),
                   zc_], dim=1) - zK * wI
    if real_case:
        Wc = torch.linalg.lu_solve(*fac, c[..., None], adjoint=True)[..., 0]
    else:
        W2 = torch.linalg.lu_solve(*fac, torch.stack(
            [c.real, c.imag], dim=-1).to(rdt), adjoint=True)
        Wc = torch.complex(W2[..., 0], W2[..., 1])
    return out + (Wc.reshape(Ntst, m, n), zb)


def cop_solve_block(blocks: COPBlocks, R, C, D, E, s):
    """k-border block solve over the COP inner solver (the explicit
    multi-border elimination of ref solve_bls_block,
    src/LinearBorderSolver.jl:173-206):

        [ J_PO  C ] [x]   [R]       J_PO = blocks ((N+1) square),
        [ D     E ] [y] = [s]       C: (N+1, k), D: (k, N+1), E: (k, k).

    One COP factorization serves x1 = J\\R and X2 = J\\C (the k columns);
    then the Schur complement E - D X2 gives y and x = x1 - X2 y."""
    F = cop_factor(blocks)
    x1, _ = cop_factor_solve(blocks, F, R)
    X2 = torch.stack([cop_factor_solve(blocks, F, C[:, i])[0]
                      for i in range(C.shape[1])], dim=1)
    y = torch.linalg.solve(E - D @ X2, s - D @ x1)
    return x1 - X2 @ y, y
