"""Codim-2 continuation of periodic-orbit bifurcations — the port of
`jl_tpu/periodic/codim2.py` (ref src/periodicorbit/codim2/MinAugPD.jl,
MinAugNS.jl).

Curves of period-doubling / Neimark-Sacker / fold points of periodic
orbits, continued in two parameters with minimally augmented functionals:

  PD:   sigma from [A_bc(s = -1),        a; b^H 0][v; sig] = [0; 1]
  NS:   sigma from [A_bc(s = e^{i th}),  a; b^H 0]  (extra unknown theta)
  Fold: sigma = -1 / <b, J_PO^-1 a> on the full discretized problem

Two formulations, as in the JAX package:

* functional (collocation, the PDE-scale path): sigma on the discretized
  operator closed by the Floquet boundary condition (`cop_bc_sigma`), the
  Newton solves by one bordered COP condensation (`POMinAugLS`).  The
  jacobian is structured (`POMAJac`): the COP blocks from the model's
  J.v (the DIA kernel for the PDE models), the p1 column, and the sigma
  gradient rows in closed form, sigma_z = -<w, d_z(A_bc) v> with the
  adjoint weights w of `cop_bc_sigma`, the model's d2F at the Gauss
  states, the period's alpha = T d/2 column, d(J v)/dp from a jvp of F
  and d/dtheta of the boundary row.  The fold's gradient takes its
  adjoint y = J_PO^-T b from the COP factorization that gives sigma
  (`cop_factor_solve_adjoint`).  Nothing differentiates through the
  kernel.  `po_sigma_autodiff` gives the same gradient by `torch.func`
  through a plain, differentiable jacobian of F, as a reference.
* monodromy (Trapeze, Shooting, or asked for): sigma from the dense
  monodromy, the whole functional differentiated by `torch.func`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.func import jacfwd, jvp

from ..codim2.minaug import _adjoint_border_solve, _border_solve, _host
from ..continuation.algorithms import PALC
from ..continuation.driver import continuation
from ..continuation.results import Branch
from ..core.lens import Lens, as_lens
from ..core.problem import BifurcationProblem
from ..detection.events import ContinuousEvent
from ..linalg.eig import dense_eig
from .collocation import Collocation, gauss_states, legendre_tensors
from .trapezoid import F_batch, jv_batch, slice_jacobians


# ---------------------------------------------------------------------------
# functional formulation (collocation; ref MinAugPD.jl:35-257,
# MinAugNS.jl:36-236: sigma on the full discretized PO problem with
# bordered solves, which scales to PDE orbits)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class POMAJac:
    """Structured jacobian of the augmented PO-MA system: the PO collocation
    blocks plus the borders (p1 column, sigma gradient rows).  Consumed by
    `POMinAugLS`; callable as the matvec for residual refinement."""

    blocks: Any            # COPBlocks at (X, p1)
    dRdp1: Any             # (N+1,) residual derivative in p1
    sig_X: Any             # (k, N+1) gradients of the sigma rows in X
    sig_p1: Any            # (k,)
    sig_th: Any            # (k,) (zeros without a theta unknown)
    kind: str              # 'pd' | 'fold' | 'ns'

    @property
    def has_theta(self):
        return self.kind == "ns"

    def __call__(self, dY):
        nX = self.dRdp1.shape[0]
        dX = dY[:nX]
        dp1 = dY[nX]
        dth = dY[nX + 1] if self.has_theta else 0.0
        top = self.blocks(dX) + self.dRdp1 * dp1
        sig = self.sig_X @ dX + self.sig_p1 * dp1 + self.sig_th * dth
        return torch.cat([top, sig])


@dataclasses.dataclass(frozen=True)
class POMinAugLS:
    """Linear solver for the `POMAJac` augmented system: one bordered COP
    condensation for pd/fold (k = 1), the k = 2 block elimination of
    `cop_solve_block` for ns; the (N+2)^2 jacobian is never formed (ref
    the MinAug linear solvers, MinAugPD.jl:141-257)."""

    needs_matrix = True

    def __call__(self, J: POMAJac, rhs, a0=0.0, a1=1.0):
        from .cop import cop_solve_block, cop_solve_bordered

        nX = J.dRdp1.shape[0]
        if not J.has_theta:
            dX, dp1 = cop_solve_bordered(J.blocks, rhs[:nX], rhs[nX],
                                         J.dRdp1, J.sig_X[0], J.sig_p1[0])
            return torch.cat([dX, dp1.reshape(1)]), True, 1
        C = torch.stack([J.dRdp1, torch.zeros_like(J.dRdp1)], dim=1)
        E = torch.stack([J.sig_p1, J.sig_th], dim=1)           # (2, 2)
        x, y = cop_solve_block(J.blocks, rhs[:nX], C, J.sig_X, E, rhs[nX:])
        return torch.cat([x, y]), True, 1


def _floquet_mode_border(disc, prob_vf, X, par, zeta, s_re, s_im, n):
    """Propagate a monodromy eigenvector along the orbit into the border
    pair of the functional MA: b = the time-dependent Floquet mode over
    the nodes (phi_{j+1} = M_j phi_j, linearly interpolated onto the local
    nodes), a = the boundary-row unit column carrying the mode's start
    value."""
    maps = disc.interval_maps(prob_vf, X, par)          # (Ntst, n, n)
    cplx = abs(float(s_im)) > 0
    zeta = torch.as_tensor(zeta).to(X.device)
    phi = zeta if cplx else torch.real(zeta).to(X.dtype)
    if cplx:
        maps = maps.to(torch.complex128)
        phi = phi.to(torch.complex128)
    phis = [phi]
    for Mj in maps:
        phis.append(Mj @ phis[-1])
    phis = torch.stack(phis)                            # (Ntst+1, n)
    phis = phis / torch.clamp_min(phis.abs().max(), 1e-300)
    m = disc.m
    fr = torch.arange(m, dtype=X.dtype, device=X.device)[None, :, None] / m
    phi_nodes = ((1 - fr) * phis[:-1, None, :]
                 + fr * phis[1:, None, :]).reshape(-1, n)
    b_unk = torch.cat([phi_nodes.reshape(-1), phis[-1]])
    a_res = torch.cat([torch.zeros(disc.Ntst * m * n, dtype=phis.dtype,
                                   device=X.device), phis[0]])
    na = torch.clamp_min(torch.linalg.vector_norm(a_res), 1e-300)
    nb = torch.clamp_min(torch.linalg.vector_norm(b_unk), 1e-300)
    return a_res / na, b_unk / nb


def _d_jv_dp(prob_vf, P, V, params, lens, p):
    """d/dp [J(P_i, p) V_i] for the rows (complex V by parts): a jvp in p
    of the jvp of F in the state (F is plain torch; no kernel)."""
    if V.is_complex():
        return torch.complex(_d_jv_dp(prob_vf, P, V.real, params, lens, p),
                             _d_jv_dp(prob_vf, P, V.imag, params, lens, p))
    p0 = torch.as_tensor(float(p), dtype=P.dtype, device=P.device)

    def jv(pp):
        par = lens.set(params, pp)
        return jvp(lambda Y: F_batch(prob_vf, Y, par), (P,), (V,))[1]

    return jvp(jv, (p0,), (torch.ones_like(p0),))[1]


def _d_F_dp(prob_vf, P, params, lens, p):
    p0 = torch.as_tensor(float(p), dtype=P.dtype, device=P.device)
    return jvp(lambda pp: F_batch(prob_vf, P, lens.set(params, pp)),
               (p0,), (torch.ones_like(p0),))[1]


def _grad_pairing(prob_vf, params, P, V, W):
    """g_i = grad_x <W_i, J(x) V_i> at x = P_i (no conjugation; complex W, V
    by parts): the model's d2F on the identity's columns when it gives a
    batched one, else the vjp of the jvp of F."""
    if V.is_complex() or W.is_complex():
        Vr, Vi = torch.real(V), (torch.imag(V) if V.is_complex() else None)
        Wr, Wi = torch.real(W), (torch.imag(W) if W.is_complex() else None)
        re = _grad_pairing(prob_vf, params, P, Vr, Wr)
        im = torch.zeros_like(re)
        if Vi is not None and Wi is not None:
            re = re - _grad_pairing(prob_vf, params, P, Vi, Wi)
        if Vi is not None:
            im = im + _grad_pairing(prob_vf, params, P, Vi, Wr)
        if Wi is not None:
            im = im + _grad_pairing(prob_vf, params, P, Vr, Wi)
        return torch.complex(re, im)
    n = P.shape[1]
    if getattr(prob_vf, "batched_F", False) and \
            prob_vf.d2F_user is not None:
        eye = torch.eye(n, dtype=P.dtype, device=P.device)
        D = prob_vf.d2F_user(P[:, None, :], params, V[:, None, :],
                             eye[None])                       # (K, n, n)
        return torch.einsum("iko,io->ik", D, W)

    def pairing(Y):
        return torch.sum(W * jvp(lambda Z: F_batch(prob_vf, Z, params),
                                 (Y,), (V,))[1])

    return torch.func.grad(pairing)(P)


def _node_scatter(disc, coeff):
    """Accumulate per-interval local-node coefficients (Ntst, m+1, n) onto
    the global nodes (shared interval ends summed), flat."""
    n = coeff.shape[-1]
    idx = (torch.arange(disc.Ntst, device=coeff.device)[:, None] * disc.m
           + torch.arange(disc.m + 1, device=coeff.device)[None, :])
    out = torch.zeros((disc.n_nodes, n), dtype=coeff.dtype,
                      device=coeff.device)
    out.index_add_(0, idx.reshape(-1), coeff.reshape(-1, n))
    return out.reshape(-1)


def _traced(t) -> bool:
    """Whether t carries a derivative (autograd or a `torch.func`
    transform): such calls bypass the point cache."""
    if not isinstance(t, torch.Tensor):
        return False
    return t.requires_grad or \
        torch._C._functorch.is_functorch_wrapped_tensor(t)


def _po_par(par, p1, inner_lens):
    po_par = {k: v for k, v in par.items() if k not in ("_a", "_b")}
    po_par["_inner"] = inner_lens.set(par["_inner"], p1)
    return po_par


def _po_ma_problem_functional(po_prob, lens2, kind: str):
    """PO codim-2 MA problem with sigma on the discretized functional via
    COP condensation (collocation only), the PDE-scale path."""
    from .cop import (collocation_block_jacobian, cop_bc_sigma, cop_factor,
                      cop_factor_solve, cop_factor_solve_adjoint)

    prob_vf = po_prob.prob_vf
    disc = po_prob.disc
    n = po_prob.n_vf
    inner_lens = as_lens(prob_vf.lens)
    outer_lens = as_lens(lens2)
    nX = int(po_prob.u0.shape[0])
    has_theta = kind == "ns"
    memo = {}

    def split(Y):
        if has_theta:
            return Y[:nX], Y[nX], Y[nX + 1]
        return Y[:nX], Y[nX], None

    def _shift(theta):
        if kind == "pd":
            return -1.0, 0.0
        return torch.cos(theta), torch.sin(theta)

    def point(Y, par, grad: bool):
        """blocks, sigma and the bordered vector at Y; with `grad` also the
        adjoint weights.  One entry, reused by G, jac and dFdp at the same
        point and borders."""
        p2 = outer_lens.get(par["_inner"])
        cacheable = not (_traced(Y) or _traced(p2))
        key = (float(p2), id(par["_a"]), id(par["_b"]),
               id(par.get("_uref")))
        hit = memo.get("pt") if cacheable else None
        if hit is not None and hit["key"] == key and \
                torch.equal(hit["Y"], Y) and (hit["grad"] or not grad):
            return hit
        X, p1, theta = split(Y)
        po_par = _po_par(par, p1, inner_lens)
        blocks = collocation_block_jacobian(disc, prob_vf, X, po_par)
        out = {"key": key, "Y": Y.clone(), "grad": grad, "blocks": blocks,
               "po_par": po_par}
        if kind == "fold":
            # generic fold MA on the full discretized problem (ref
            # "Fold-of-PO via generic Fold MA + COP"): sigma =
            # -1 / <b, J^-1 a>.  The Floquet-BC operator at s = +1 is
            # singular through the trivial multiplier on every orbit.
            # One COP factorization serves w = J^-1 a and the gradient's
            # adjoint y = J^-T b
            fac = cop_factor(blocks)
            w = cop_factor_solve(blocks, fac, par["_a"])[0]
            sig = -1.0 / torch.dot(par["_b"], w)
            out.update(sr=sig, si=torch.zeros_like(sig), v=w)
            if grad:
                out.update(y=cop_factor_solve_adjoint(blocks, fac,
                                                      par["_b"]))
        else:
            s_re, s_im = _shift(theta)
            res = cop_bc_sigma(blocks, par["_a"], par["_b"], s_re, s_im,
                               adjoint=grad)
            sr, si, vr, vi = res[:4]
            out.update(sr=sr, si=si,
                       v=torch.complex(vr, vi) if has_theta else vr)
            if grad:
                out.update(Wc=res[4], Wb=res[5])
        if cacheable:
            memo["pt"] = out
        return out

    def G(Y, par):
        X, p1, _ = split(Y)
        pt = point(Y, par, False)
        R = disc.residual(prob_vf, X, pt["po_par"])
        sig = [pt["sr"].reshape(1)]
        if has_theta:
            sig.append(pt["si"].reshape(1))
        return torch.cat([R] + sig)

    def _gauss(pt, X):
        L, _, _ = legendre_tensors(disc.m, X.dtype, X.device)
        mesh = pt["po_par"]["_mesh"]
        nodes, T = disc.split(X, n)
        P = gauss_states(L, disc.local_nodes(nodes)).reshape(-1, n)
        d = mesh[1:] - mesh[:-1]
        return L, P, d, T

    def _sig_grad(Y, par, lens_p=None):
        """(sig_X (k, nX), sig_p1 (k,), sig_th (k,)), or with `lens_p`
        (lens, value) the sigma rows' derivative in that parameter."""
        X, p1, theta = split(Y)
        pt = point(Y, par, True)
        L, P, d, T = _gauss(pt, X)
        params = pt["po_par"]["_inner"]
        Ntst, m = disc.Ntst, disc.m
        if kind == "fold":
            return _fold_grad(pt, X, L, P, d, T, params, lens_p)
        v = pt["v"]
        vg = gauss_states(L.to(v.dtype),
                          disc.local_nodes(v.reshape(-1, n))).reshape(-1, n)
        W = pt["Wc"].reshape(-1, n)
        alpha = (T * d / 2.0).repeat_interleave(m)[:, None]
        if lens_p is not None:
            lens, pv = lens_p
            dJv = _d_jv_dp(prob_vf, P, vg, params, lens, pv)
            ds = torch.sum(alpha * W * dJv)
            return _rows(ds)
        g = _grad_pairing(prob_vf, params, P, vg, W)          # (K, n)
        coeff = torch.einsum("li,jin->jln", L.to(g.dtype),
                             (alpha * g).reshape(Ntst, m, n))
        sX = torch.cat([_node_scatter(disc, coeff),
                        torch.sum((d / 2.0).repeat_interleave(m)[:, None]
                                  * W * jv_batch(prob_vf, P, params, vg))
                        .reshape(1)])
        dJv = _d_jv_dp(prob_vf, P, vg, params, inner_lens, p1)
        sp1 = torch.sum(alpha * W * dJv)
        if has_theta:
            s = torch.complex(torch.cos(theta), torch.sin(theta))
            sth = 1j * s * torch.sum(pt["Wb"] * v[:n])
            return _rows(sX), _rows(sp1), _rows(sth)
        return _rows(sX), _rows(sp1), torch.zeros(1, dtype=X.dtype,
                                                  device=X.device)

    def _rows(z):
        if has_theta:
            return torch.stack([torch.real(z), torch.imag(z)])
        return torch.real(z).reshape((1,) + tuple(z.shape))

    def _fold_grad(pt, X, L, P, d, T, params, lens_p):
        """sigma = -1/<b, w>, w = J^-1 a: d sigma = -sigma^2 <y, J' w>
        with y = J^-T b; J' w is the derivative of the collocation rows
        dL w - alpha J(P) w_g - (d/2) w_T F(P)."""
        Ntst, m = disc.Ntst, disc.m
        sig = pt["sr"]
        w, y = pt["v"], pt["y"]
        wg = gauss_states(L, disc.local_nodes(w[:-1].reshape(-1, n))
                          ).reshape(-1, n)
        wT = w[-1]
        Yc = y[:Ntst * m * n].reshape(-1, n)
        alpha = (T * d / 2.0).repeat_interleave(m)[:, None]
        half = (d / 2.0).repeat_interleave(m)[:, None]
        if lens_p is not None:
            lens, pv = lens_p
            t = -(torch.sum(alpha * Yc * _d_jv_dp(prob_vf, P, wg, params,
                                                  lens, pv))
                  + wT * torch.sum(half * Yc * _d_F_dp(prob_vf, P, params,
                                                       lens, pv)))
            return (-sig * sig * t).reshape(1)
        g = _grad_pairing(prob_vf, params, P, wg, Yc)
        Jp = slice_jacobians(prob_vf, P, params)
        JtY = torch.einsum("kon,ko->kn", Jp, Yc)
        gp = -(alpha * g + wT * half * JtY)
        coeff = torch.einsum("li,jin->jln", L, gp.reshape(Ntst, m, n))
        tT = -torch.sum(half * Yc * jv_batch(prob_vf, P, params, wg))
        tX = torch.cat([_node_scatter(disc, coeff), tT.reshape(1)])
        p1 = inner_lens.get(params)
        tp = -(torch.sum(alpha * Yc * _d_jv_dp(prob_vf, P, wg, params,
                                               inner_lens, p1))
               + wT * torch.sum(half * Yc * _d_F_dp(prob_vf, P, params,
                                                    inner_lens, p1)))
        return ((-sig * sig * tX)[None], (-sig * sig * tp).reshape(1),
                torch.zeros(1, dtype=X.dtype, device=X.device))

    def jac(Y, par):
        X, p1, _ = split(Y)
        pt = point(Y, par, True)
        po_par = pt["po_par"]
        p1t = torch.as_tensor(float(p1), dtype=X.dtype, device=X.device)
        dRdp1 = jvp(lambda q: disc.residual(
            prob_vf, X, {**po_par, "_inner": inner_lens.set(
                po_par["_inner"], q)}), (p1t,), (torch.ones_like(p1t),))[1]
        sX, sp1, sth = _sig_grad(Y, par)
        return POMAJac(blocks=pt["blocks"], dRdp1=dRdp1, sig_X=sX,
                       sig_p1=sp1, sig_th=sth, kind=kind)

    def dFdp(Y, par):
        """d G / d p2: the residual's by a jvp of F, sigma's in closed form
        (no derivative through the kernel)."""
        X, _, _ = split(Y)
        pt = point(Y, par, True)
        po_par = pt["po_par"]
        p2 = float(outer_lens.get(po_par["_inner"]))
        p2t = torch.as_tensor(p2, dtype=X.dtype, device=X.device)
        dR = jvp(lambda q: disc.residual(prob_vf, X, {
            **po_par, "_inner": outer_lens.set(po_par["_inner"], q)}),
            (p2t,), (torch.ones_like(p2t),))[1]
        return torch.cat([dR, _sig_grad(Y, par, (outer_lens, p2))])

    lens = Lens(
        get=lambda par: outer_lens.get(par["_inner"]),
        set=lambda par, v: {**par,
                            "_inner": outer_lens.set(par["_inner"], v)},
        name=f"po-{kind}/{outer_lens.name}")

    def record(Y, p2, **k):
        X, p1, theta = split(Y)
        out = {"param": p2, "p1": p1, "period": disc.period(X)}
        if theta is not None:
            out["theta"] = theta
        return out

    def update(it, state):
        """Re-anchor b to the current mode v of the condensation and
        refresh the PO phase section (the left border a is kept: sigma
        only needs borders not orthogonal to the null spaces).  Reads the
        engine's base parameters, as the JAX package."""
        par = it.current_params
        Y = state.z.u
        X, p1, _ = split(Y)
        v = point(Y, par, False)["v"]
        new = dict(par)
        new["_b"] = (v / torch.linalg.vector_norm(v)).to(par["_b"].dtype)
        po_par = _po_par(par, p1, inner_lens)
        if "_uref" in new:
            nodes, _ = disc.split(X, n)
            _, phi = disc.phase_data(prob_vf, nodes, po_par["_inner"],
                                     new["_mesh"])
            new["_uref"] = nodes
            new["_phi"] = phi
        return new

    def eig_jacobian(Y, par):
        """COP blocks of the inner orbit -> FloquetColl along the curve."""
        X, p1, _ = split(Y)
        return collocation_block_jacobian(disc, prob_vf, X,
                                          _po_par(par, p1, inner_lens))

    maprob = BifurcationProblem(G, u0=None, params=None, lens=lens, jac=jac,
                                dFdp_user=dFdp, record_from_solution=record,
                                update=update)
    _ma_attrs(maprob, po_prob, kind, eig_jacobian, eig_two_stage=True,
              sigma_gradient=lambda Y, par: _sig_grad(Y, par))
    return maprob, split


def _ma_attrs(maprob, po_prob, kind, eig_jacobian, **extra):
    attrs = dict(inner_prob=po_prob, ma_kind=f"po-{kind}",
                 eig_jacobian=eig_jacobian, eig_max_nev=po_prob.n_vf,
                 **extra)
    for k, v in attrs.items():
        object.__setattr__(maprob, k, v)


def po_sigma_autodiff(maprob, Y, par):
    """The sigma rows' gradient (sig_X, sig_p1, sig_th) of a functional
    PO-MA problem by `torch.func.jacrev` through a plain, differentiable
    route: per-node jacobians by `vmap(jacfwd(F))` (no `jac_op`, so no
    kernel) and the same `cop_bc_sigma`.  The reference the closed-form
    gradient (`POMAJac`) is held against."""
    from .cop import collocation_block_jacobian, cop_bc_sigma, cop_solve

    po_prob = maprob.inner_prob
    kind = maprob.ma_kind[3:]
    disc = po_prob.disc
    vf = po_prob.prob_vf
    plain = vf.re_make(jac_op=None, jac=None)
    object.__setattr__(plain, "batched_F", False)
    inner_lens = as_lens(vf.lens)
    nX = int(po_prob.u0.shape[0])
    X, p1 = Y[:nX], Y[nX]
    th = Y[nX + 1] if kind == "ns" else torch.zeros_like(p1)

    def rows(Xv, p1v, thv):
        po_par = _po_par(par, p1v, inner_lens)
        blocks = collocation_block_jacobian(disc, plain, Xv, po_par)
        if kind == "fold":
            w = cop_solve(blocks, par["_a"])
            return (-1.0 / torch.dot(par["_b"], w)).reshape(1)
        if kind == "pd":
            sr, _, _, _ = cop_bc_sigma(blocks, par["_a"], par["_b"], -1.0)
            return sr.reshape(1)
        sr, si, _, _ = cop_bc_sigma(blocks, par["_a"], par["_b"],
                                    torch.cos(thv), torch.sin(thv))
        return torch.stack([sr, si])

    return torch.func.jacrev(rows, argnums=(0, 1, 2))(X, p1, th)


# ---------------------------------------------------------------------------
# monodromy formulation (ODE scale)
# ---------------------------------------------------------------------------


def _po_ma_problem(po_prob, lens2, kind: str):
    """Augmented problem over Y = [X_po, p1 (, theta)] continued in lens2,
    sigma from the dense monodromy; its jacobian by `torch.func`."""
    prob_vf = po_prob.prob_vf
    disc = po_prob.disc
    inner_lens = as_lens(prob_vf.lens)
    outer_lens = as_lens(lens2)
    nX = int(po_prob.u0.shape[0])
    has_theta = kind == "ns"

    def split(Y):
        if has_theta:
            return Y[:nX], Y[nX], Y[nX + 1]
        return Y[:nX], Y[nX], None

    def _full_dG(X, po_par):
        return jacfwd(lambda Xv: disc.residual(prob_vf, Xv, po_par))(X)

    def G(Y, par):
        X, p1, theta = split(Y)
        po_par = _po_par(par, p1, inner_lens)
        R = disc.residual(prob_vf, X, po_par)
        if kind == "fold":
            # generic fold MA on the full discretized problem: (M - I) is
            # singular through the trivial multiplier on every orbit
            _, sigma = _border_solve(_full_dG(X, po_par), par["_a"],
                                     par["_b"])
            return torch.cat([R, torch.real(sigma).reshape(1)])
        M = disc.monodromy(prob_vf, X, po_par)
        if kind == "pd":
            _, sigma = _border_solve(M, par["_a"], par["_b"], shift=1.0)
            return torch.cat([R, torch.real(sigma).reshape(1)])
        _, sigma = _border_solve(M, par["_a"], par["_b"],
                                 shift=-torch.exp(1j * theta))
        return torch.cat([R, torch.real(sigma).reshape(1),
                          torch.imag(sigma).reshape(1)])

    lens = Lens(
        get=lambda par: outer_lens.get(par["_inner"]),
        set=lambda par, v: {**par,
                            "_inner": outer_lens.set(par["_inner"], v)},
        name=f"po-{kind}/{outer_lens.name}")

    def record(Y, p2, **k):
        X, p1, theta = split(Y)
        out = {"param": p2, "p1": p1, "period": disc.period(X)}
        if theta is not None:
            out["theta"] = theta
        return out

    def update(it, state):
        """Re-anchor the borders to the current null vectors and refresh
        the PO section (ref the update hooks of MinAugPD.jl)."""
        par = it.current_params
        X, p1, theta = split(state.z.u)
        po_par = _po_par(par, p1, inner_lens)
        if kind == "fold":
            dG = _full_dG(X, po_par)
            v, _ = _border_solve(dG, par["_a"], par["_b"])
            w, _ = _adjoint_border_solve(dG, par["_a"], par["_b"])
        else:
            M = disc.monodromy(prob_vf, X, po_par)
            shift = 1.0 if kind == "pd" else -torch.exp(1j * theta)
            v, _ = _border_solve(M, par["_a"], par["_b"], shift)
            w, _ = _adjoint_border_solve(M, par["_a"], par["_b"], shift)
        new = dict(par)
        new["_b"] = (v / torch.linalg.vector_norm(v)).to(par["_b"].dtype)
        new["_a"] = (w / torch.linalg.vector_norm(w)).to(par["_a"].dtype)
        if "_uref" in new:
            n = new["_uref"].shape[1]
            nodes, _ = disc.split(X, n)
            if isinstance(disc, Collocation):
                _, phi = disc.phase_data(prob_vf, nodes, po_par["_inner"],
                                         new["_mesh"])
            else:
                _, phi = disc.phase_data(prob_vf, nodes, po_par["_inner"])
            new["_uref"] = nodes
            new["_phi"] = phi
        return new

    def eig_jacobian(Y, par):
        """The inner orbit's monodromy: secondary bifurcations (fold-flip,
        fold-NS, pd-NS, NS-NS) as ordinary Floquet crossings (the
        border-stripping pattern of MinAugPD.jl:440)."""
        X, p1, _ = split(Y)
        return disc.monodromy(prob_vf, X, _po_par(par, p1, inner_lens))

    maprob = BifurcationProblem(G, u0=None, params=None, lens=lens,
                                record_from_solution=record, update=update)
    _ma_attrs(maprob, po_prob, kind, eig_jacobian)
    return maprob, split


# label conversion for secondary Floquet crossings along PO codim-2 curves
# (ref _correct_event_labels, periodicorbit/codim2/codim2.jl:162-178)
_SECONDARY_LABELS = {
    "fold": {"bp": "R1", "hopf": "foldNS", "pd": "foldpd", "fold": "cusp"},
    "pd": {"bp": "foldFlip", "hopf": "pdNS", "pd": "R2"},
    "ns": {"bp": "foldNS", "hopf": "nsns", "pd": "pdNS"},
}


def _gamma(br):
    return br.gamma if isinstance(br, Branch) else br


def _start_data(br_po, ind_bif, which: str):
    gamma = _gamma(br_po)
    sp = gamma.specialpoint[ind_bif]
    po_prob = gamma.prob
    X = torch.as_tensor(sp.x)
    p1 = sp.param
    disc = po_prob.disc
    prob_vf = po_prob.prob_vf
    par = po_prob.set_lens_param(po_prob.params, p1)
    M = disc.monodromy(prob_vf, X, par)
    mult, vecs = dense_eig(M)
    mult_np = mult.cpu().numpy()
    if which == "pd":
        i0 = int(np.argmin(np.abs(mult_np + 1.0)))
        theta = None
    elif which == "fold":
        # the second multiplier near +1 (not the trivial one)
        order = np.argsort(np.abs(mult_np - 1.0))
        i0 = int(order[1]) if len(order) > 1 else int(order[0])
        theta = None
    else:
        cand = np.where(np.abs(mult_np.imag) > 1e-8)[0]
        i0 = int(cand[np.argmin(np.abs(np.abs(mult_np[cand]) - 1.0))])
        theta = float(np.angle(mult_np[i0]))
    zeta = vecs[:, i0]
    multT, vecsT = dense_eig(M.T)
    iT = int(np.argmin(np.abs(multT.cpu().numpy() - np.conj(mult_np[i0]))))
    return X, p1, theta, zeta, vecsT[:, iT], par


def _po_codim3_event(po_prob, split, kind: str, flow_steps: int,
                     compute_nf: bool):
    """Codim-3 test functions monitored along PO codim-2 curves
    (ref test_for_pd_gpd_cp, MinAugPD.jl:393-438: (GPD, CP, R2);
    test_for_ns_ch, MinAugNS.jl:415-463: (R1..R4, CH) with R1 = omega,
    R2 = cos(omega) + 1, R3 = 2 cos(omega) + 1, R4 = cos(omega)).
    GPD / CH come from the Iooss normalization on collocation, from the
    return map's jets otherwise."""
    from .normal_forms import (_ns_iooss_core, _pd_iooss_core,
                               make_prm_coef_kernels)

    prob_vf = po_prob.prob_vf
    disc = po_prob.disc
    n = po_prob.n_vf
    inner_lens = as_lens(prob_vf.lens)
    use_iooss = isinstance(disc, Collocation) and kind in ("pd", "ns")
    kernels = make_prm_coef_kernels(prob_vf, flow_steps=flow_steps) \
        if (compute_nf and not use_iooss) else None

    def _point(it, state):
        # the current curve parameter p2 (current_params holds the base
        # parameters)
        par = it.prob.set_lens_param(it.current_params, float(state.p))
        X, p1, theta = split(state.z.u)
        po_par = _po_par(par, p1, inner_lens)
        nodes, T = disc.split(X, n)
        return X, po_par, nodes[0], T, theta, par

    def _prm_eig(x0, T, par_inner, which):
        A = _host(kernels[0](x0, T, par_inner))
        vals, vecs = np.linalg.eig(A)
        valsT, vecsT = np.linalg.eig(A.T)
        if which == "pd":
            i0 = int(np.argmin(np.abs(vals + 1.0)))
            iT = int(np.argmin(np.abs(valsT + 1.0)))
            q = np.real(vecs[:, i0])
            q /= np.linalg.norm(q)
            p = np.real(vecsT[:, iT])
            p /= np.dot(p, q)
            return A, vals[i0], q, p
        cand = np.where(vals.imag > 1e-10)[0]
        if len(cand) == 0:
            return A, None, None, None
        i0 = cand[np.argmin(np.abs(np.abs(vals[cand]) - 1.0))]
        lam = vals[i0]
        q = vecs[:, i0] / np.linalg.norm(vecs[:, i0])
        iT = int(np.argmin(np.abs(valsT - np.conj(lam))))
        p = vecsT[:, iT]
        p = p / np.conj(np.vdot(p, q))
        return A, lam, q, p

    def _mono_borders(par, M):
        """n-dim borders for the monodromy tests: the curve's own anchors
        where the shapes match (monodromy formulation), generic ones
        otherwise (the functional formulation's live on the nodes)."""
        a, b = par["_a"], par["_b"]
        if a.shape[0] != M.shape[0]:
            a = torch.ones((M.shape[0],), dtype=M.dtype, device=M.device)
            b = a
        return a, b

    if kind == "pd":
        def cond(it, state):
            X, po_par, x0, T, _, par = _point(it, state)
            M = disc.monodromy(prob_vf, X, po_par)
            a_n, b_n = _mono_borders(par, M)
            v, _ = _border_solve(M, a_n, b_n, shift=1.0)
            w, _ = _adjoint_border_solve(M, a_n, b_n, shift=1.0)
            v = v / torch.linalg.vector_norm(v)
            w = w / torch.linalg.vector_norm(w)
            r2 = float(torch.real(torch.sum(torch.conj(w) * v)))
            cp = float(state.tau.p)
            if compute_nf and use_iooss:
                gpd = _pd_iooss_core(disc, prob_vf, n, X, po_par["_inner"],
                                     po_par["_mesh"])["b3"]
            elif compute_nf:
                _, _, q, p = _prm_eig(x0, T, po_par["_inner"], "pd")
                gpd = float(kernels[1](x0, T, po_par["_inner"], q, p))
            else:
                gpd = 1.0
            return (gpd, cp, r2)

        return ContinuousEvent(nb=3, condition=cond,
                               labels=["gpd", "cusp", "R2"])

    if kind == "ns":
        def cond(it, state):
            X, po_par, x0, T, theta, par = _point(it, state)
            th = float(theta)
            c = np.cos(th)
            if compute_nf and use_iooss:
                ch = _ns_iooss_core(disc, prob_vf, n, X, po_par["_inner"],
                                    po_par["_mesh"], abs(th))["d"].real
            elif compute_nf:
                _, lam, q, p = _prm_eig(x0, T, po_par["_inner"], "ns")
                ch = 1.0 if q is None else float(kernels[2](
                    x0, T, po_par["_inner"], q, p, float(np.angle(lam))))
            else:
                ch = 1.0
            return (th, c + 1.0, 2 * c + 1.0, c, ch)

        return ContinuousEvent(nb=5, condition=cond,
                               labels=["R1", "R2", "R3", "R4", "ch"])

    # fold of PO: cusp = fold of the fold curve in the second parameter
    def cond(it, state):
        return (float(state.tau.p),)

    return ContinuousEvent(nb=1, condition=cond, labels=["cusp"])


def _continuation_po_codim2(br_po, ind_bif, lens2, contparams, kind,
                            **kwargs):
    gamma = _gamma(br_po)
    start = _start_data(br_po, ind_bif, kind)
    return _po_codim2_from_data(gamma.prob, start, lens2, contparams, kind,
                                bp=gamma.specialpoint[ind_bif], **kwargs)


def _po_codim2_from_data(po_prob, start, lens2, contparams, kind,
                         bp=None, alg=None, detect_codim3: int = 1,
                         compute_nf_events: bool = True,
                         nf_flow_steps: int = 120,
                         formulation: str = None, **kwargs):
    """Core PO codim-2 MA continuation from explicit start data, used by
    the on-branch starters (`continuation_pd/ns/fold_po`) and by the
    codim-2 -> PO-curve switch (`codim2.unfolding.switch_codim2_po`,
    ref src/codim2/NormalForms.jl:935,1283,1536-1574)."""
    from .cop import collocation_block_jacobian, cop_solve

    alg = alg or PALC()
    X, p1, theta, zeta, zeta_ad, par = start
    if formulation is None:
        formulation = ("functional" if isinstance(po_prob.disc, Collocation)
                       else "monodromy")
    functional = formulation == "functional"
    if functional and not isinstance(po_prob.disc, Collocation):
        raise ValueError("formulation='functional' requires Collocation")
    maprob, split = (_po_ma_problem_functional if functional
                     else _po_ma_problem)(po_prob, lens2, kind)
    like = dict(dtype=X.dtype, device=X.device)
    tail = [torch.as_tensor(float(p1), **like).reshape(1)]
    if kind == "ns":
        tail.append(torch.as_tensor(float(theta), **like).reshape(1))
    Y0 = torch.cat([X] + tail)
    disc = po_prob.disc
    prob_vf = po_prob.prob_vf

    if kind == "fold":
        # generic-fold-MA borders: an approximate null pair of the full
        # discretized jacobian (near the fold one inverse iteration from a
        # generic start isolates the null direction); the Floquet-mode
        # borders are singular through the trivial multiplier
        po_par = {k: v for k, v in par.items() if k not in ("_a", "_b")}
        g = torch.Generator().manual_seed(17)
        r = torch.randn(X.shape[0], generator=g, dtype=torch.float64
                        ).to(**like)
        r = r / torch.linalg.vector_norm(r)
        if functional:
            w = cop_solve(collocation_block_jacobian(disc, prob_vf, X,
                                                     po_par), r)
            a, b = r, w / torch.linalg.vector_norm(w)
        else:
            dG = jacfwd(lambda Xv: disc.residual(prob_vf, Xv, po_par))(X)
            wr = torch.linalg.solve(dG, r)
            wl = torch.linalg.solve(dG.T, r)
            a = wl / torch.linalg.vector_norm(wl)
            b = wr / torch.linalg.vector_norm(wr)
    elif functional:
        if kind == "pd":
            s_re, s_im = -1.0, 0.0
        else:
            s_re, s_im = float(np.cos(theta)), float(np.sin(theta))
        a, b = _floquet_mode_border(disc, prob_vf, X, par, zeta, s_re, s_im,
                                    po_prob.n_vf)
        if kind != "ns":
            a, b = torch.real(a).to(X.dtype), torch.real(b).to(X.dtype)
    elif kind == "ns":
        a = torch.as_tensor(zeta_ad).to(torch.complex128)
        b = torch.as_tensor(zeta).to(torch.complex128)
    else:
        a = torch.real(torch.as_tensor(zeta_ad)).to(X.dtype)
        a = a / torch.linalg.vector_norm(a)
        b = torch.real(torch.as_tensor(zeta)).to(X.dtype)
        b = b / torch.linalg.vector_norm(b)

    params = dict(par)
    params["_a"] = a
    params["_b"] = b
    maprob2 = maprob.re_make(u0=Y0, params=params)
    cp = contparams
    if functional:
        nopts = cp.newton_options
        if not isinstance(nopts.linsolver, POMinAugLS):
            cp = cp.replace(newton_options=nopts.replace(
                linsolver=POMinAugLS()))
    if cp.detect_bifurcation > 1:
        # secondary bifurcations along the curve from the inner orbit's
        # Floquet spectrum (the tracked critical multiplier and the
        # trivial one sit on the unit circle, below tol_stability)
        from .floquet import FloquetColl, FloquetEig

        nopts = cp.newton_options
        if not getattr(nopts.eigsolver, "is_floquet", False):
            cp = cp.replace(newton_options=nopts.replace(
                eigsolver=FloquetColl() if functional else FloquetEig()))
    event = None
    if detect_codim3 > 0:
        event = _po_codim3_event(po_prob, split, kind,
                                 flow_steps=nf_flow_steps,
                                 compute_nf=compute_nf_events)
        if cp.detect_event == 0:
            cp = cp.replace(detect_event=min(detect_codim3, 2))
    gamma2 = continuation(maprob2, alg, cp, kind=f"POCodim2-{kind}",
                          event=event, **kwargs)
    conv = _SECONDARY_LABELS.get(kind, {})
    for sp2 in gamma2.specialpoint:
        if sp2.type in conv:
            sp2.type = conv[sp2.type]
    return Branch(gamma=gamma2, bp=bp)


def po_codim2_test_values(br_pd_or_ns, idx: int = -1):
    """Codim-3 test quantities along a PO codim-2 curve (ref codim-3
    tests, MinAugPD.jl:392, MinAugNS.jl:415): at a saved point, the
    monodromy multipliers and the resonance distances R1..R4."""
    gamma = _gamma(br_pd_or_ns)
    maprob = gamma.prob
    po_prob = maprob.inner_prob
    disc = po_prob.disc
    prob_vf = po_prob.prob_vf
    sol = gamma.sol[idx]
    Y = torch.as_tensor(sol["x"])
    nX = int(po_prob.u0.shape[0])
    X = Y[:nX]
    p1 = float(Y[nX])
    p2 = float(sol["p"])
    par = {k: v for k, v in maprob.params.items() if k not in ("_a", "_b")}
    par["_inner"] = as_lens(prob_vf.lens).set(par["_inner"], p1)
    par["_inner"] = maprob.lens.set({"_inner": par["_inner"]}, p2)["_inner"]
    mult = dense_eig(disc.monodromy(prob_vf, X, par),
                     with_vectors=False)[0].cpu().numpy()
    return {"multipliers": mult, "theta": np.angle(mult),
            "R1": float(np.min(np.abs(mult - 1.0))),
            "R2": float(np.min(np.abs(mult + 1.0))),
            "R3": float(np.min(np.abs(mult - np.exp(2j * np.pi / 3)))),
            "R4": float(np.min(np.abs(mult - 1j)))}


def continuation_pd(br_po, ind_bif, lens2, contparams, **kwargs) -> Branch:
    """Continue a period-doubling point of a PO in two parameters
    (ref continuation_pd, MinAugPD.jl:307)."""
    return _continuation_po_codim2(br_po, ind_bif, lens2, contparams, "pd",
                                   **kwargs)


def continuation_ns(br_po, ind_bif, lens2, contparams, **kwargs) -> Branch:
    """ref continuation_ns, MinAugNS.jl:328."""
    return _continuation_po_codim2(br_po, ind_bif, lens2, contparams, "ns",
                                   **kwargs)


def continuation_fold_po(br_po, ind_bif, lens2, contparams,
                         **kwargs) -> Branch:
    """Fold-of-periodic-orbits curve (ref Fold-of-PO via the generic Fold
    MA, periodicorbit/codim2)."""
    return _continuation_po_codim2(br_po, ind_bif, lens2, contparams, "fold",
                                   **kwargs)


# ---------------------------------------------------------------------------
# branch switching onto other PO branches
# ---------------------------------------------------------------------------


def _critical_mode(po_prob, sp, which):
    """(par at the point, the unit real mode of the critical multiplier:
    -1 for 'pd', the non-trivial +1 for 'bp')."""
    disc = po_prob.disc
    X = torch.as_tensor(sp.x)
    par = po_prob.set_lens_param(po_prob.params, sp.param)
    mult, vecs = dense_eig(disc.monodromy(po_prob.prob_vf, X, par))
    mult_np = mult.cpu().numpy()
    if which == "pd":
        i0 = int(np.argmin(np.abs(mult_np + 1.0)))
    else:
        order = np.argsort(np.abs(mult_np - 1.0))
        i0 = int(order[1]) if len(order) > 1 else int(order[0])
    phi0 = torch.real(vecs[:, i0]).to(X.dtype)
    return X, par, phi0 / torch.linalg.vector_norm(phi0)


def bp_po_branch_switch(br_po, ind_bp, contparams, ampfactor: float = 0.1,
                        delta_p: float = 0.0, alg=None, **kwargs) -> Branch:
    """aBS at a branch point of periodic orbits (multiplier +1, not a
    fold): the same-period orbit perturbed along the critical
    eigenfunction (ref PO->PO branching, PeriodicOrbits.jl:626-709)."""
    from .orbits import continuation_po

    gamma = _gamma(br_po)
    sp = gamma.specialpoint[ind_bp]
    po_prob = gamma.prob
    disc = po_prob.disc
    prob_vf = po_prob.prob_vf
    X, _, phi0 = _critical_mode(po_prob, sp, "bp")
    nodes, T = disc.split(X, po_prob.n_vf)
    scale = ampfactor * (float(torch.linalg.vector_norm(nodes[0])) + 1.0)
    X2 = disc.pack(nodes + scale * phi0[None, :], T)
    params_new = prob_vf.set_lens_param(prob_vf.params,
                                        float(sp.param + delta_p))
    return continuation_po(prob_vf, disc, X2, contparams, alg=alg,
                           params=params_new, **kwargs)


def _interp_nodes(phis, m):
    """Boundary values (Ntst+1, n) linearly interpolated onto the local
    nodes (node j*m+i at fraction i/m), (Ntst*m+1, n)."""
    fr = torch.arange(m, dtype=phis.dtype, device=phis.device
                      )[None, :, None] / m
    inner = ((1 - fr) * phis[:-1, None, :] + fr * phis[1:, None, :]
             ).reshape(-1, phis.shape[1])
    return torch.cat([inner, phis[-1:]])


def pd_branch_switch(br_po, ind_pd, contparams, ampfactor: float = 0.1,
                     delta_p: float = None, alg=None, **kwargs) -> Branch:
    """aBS at a PD point: the double-period guess is the orbit traversed
    twice, perturbed by +/- the PD eigenfunction propagated along the
    orbit (ref PO->PO branching, PeriodicOrbits.jl:626-709), for
    Collocation, Trapeze and Shooting (`pd_doubled_guess`).  `delta_p`
    defaults to contparams.ds: at the PD point the doubled problem is
    singular (the squared multiplier joins the trivial +1), so the jump
    steps off the point."""
    from .orbits import continuation_po

    if delta_p is None:
        delta_p = contparams.ds
    gamma = _gamma(br_po)
    sp = gamma.specialpoint[ind_pd]
    po_prob = gamma.prob
    X2, disc2 = pd_doubled_guess(po_prob, sp, ampfactor)
    prob_vf = po_prob.prob_vf
    params_new = prob_vf.set_lens_param(prob_vf.params,
                                        float(sp.param + delta_p))
    return continuation_po(prob_vf, disc2, X2, contparams, alg=alg,
                           params=params_new, **kwargs)


def pd_doubled_guess(po_prob, sp, ampfactor: float = 0.1):
    """The doubled-period guess of `pd_branch_switch` and its
    discretization: Collocation (the mode through the interval maps),
    Trapeze (2M-1 slices, the mode through the per-slice trapezoid maps)
    or Shooting (2M points, the mode through the per-segment flow
    jacobians)."""
    disc = po_prob.disc
    prob_vf = po_prob.prob_vf
    n = po_prob.n_vf
    X, par, phi0 = _critical_mode(po_prob, sp, "pd")
    u, T = disc.split(X, n)
    scale = ampfactor * (float(torch.linalg.vector_norm(u[0])) + 1.0)
    from .shooting import Shooting
    from .trapezoid import Trapeze

    if isinstance(disc, Collocation):
        # the time-dependent antiperiodic Floquet mode
        # phi(t_{j+1}) = M_j phi(t_j) (a time-constant perturbation is
        # mostly orthogonal to the period-2 branch)
        maps = disc.interval_maps(prob_vf, X, par)
        phis = [phi0]
        for Mj in maps:
            phis.append(Mj @ phis[-1])
        phis = torch.stack(phis)
        phis = phis / max(float(phis.abs().max()), 1e-300)
        phi_nodes = _interp_nodes(phis, disc.m)
        doubled = torch.cat([u[:-1] + scale * phi_nodes[:-1],
                             u[:-1] - scale * phi_nodes[:-1],
                             u[:1] + scale * phi_nodes[:1]])
        disc2 = Collocation(Ntst=2 * disc.Ntst, m=disc.m)
        return disc2.pack(doubled, 2 * T), disc2
    if isinstance(disc, Trapeze):
        # per-slice trapezoid maps (I - T h/2 J_{i+1})^-1 (I + T h/2 J_i)
        Js = slice_jacobians(prob_vf, u, par["_inner"])
        h = disc.steps(dtype=X.dtype, device=X.device)
        Tf = float(T)
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        phis = [phi0]
        for i in range(disc.M - 1):
            A = eye + (Tf * float(h[i]) / 2.0) * Js[i]
            B = eye - (Tf * float(h[i]) / 2.0) * Js[i + 1]
            phis.append(torch.linalg.solve(B, A @ phis[-1]))
        phis = torch.stack(phis)
        phis = phis / max(float(phis.abs().max()), 1e-300)
        doubled = torch.cat([u[:-1] + scale * phis[:-1],
                             u[:-1] - scale * phis[:-1],
                             u[:1] + scale * phis[:1]])
        if disc.time_mesh is not None:
            hh = np.asarray(disc.time_mesh)
            disc2 = Trapeze(M=2 * disc.M - 1,
                            time_mesh=np.concatenate([hh, hh]) / 2.0)
        else:
            disc2 = Trapeze(M=2 * disc.M - 1)
        return disc2.pack(doubled, 2 * T), disc2
    if isinstance(disc, Shooting):
        # the mode at each segment start through the per-segment flow
        # jacobians: the variational flow on the identity's columns (the
        # JAX package's jacfwd through the flow)
        dPhis = disc._flow(prob_vf).monodromy(u, par["_inner"], T / disc.M)
        phis = [phi0]
        for i in range(disc.M - 1):
            nxt = dPhis[i] @ phis[-1]
            phis.append(nxt / max(float(torch.linalg.vector_norm(nxt)),
                                  1e-300))
        phis = torch.stack(phis)
        doubled = torch.cat([u + scale * phis, u - scale * phis])
        disc2 = dataclasses.replace(disc, M=2 * disc.M)
        return disc2.pack(doubled, 2 * T), disc2
    raise NotImplementedError("PD branch switching requires Collocation, "
                              "Trapeze or Shooting")
