"""Normal forms of periodic-orbit bifurcations — the port of
`jl_tpu/periodic/normal_forms.py` (ref src/periodicorbit/NormalForms.jl:
325-1004, PoincareRM.jl:10-190).

Two routes:

* Iooss periodic normalization in the collocation basis (PD and NS, no
  flow re-integration; ref :574-806, :1004-1204): dense linearized
  collocation operators at the orbit's Gauss states, their null vectors
  by bordered solves, the per-node jets along the orbit.  Each operator
  is built straight into its bordered buffer, one at a time, and each
  bordered matrix is factored once (`lu_factor`) for both its solve and
  its adjoint solve.  The per-node jacobians come from
  `slice_jacobians` (a batched model's J.v, the DIA kernel for the PDE
  models), the forms from the model's d2F / d3F.
* The Poincare return map P (any discretization): hyperplane coordinates
  around the orbit's first node, the flow for the period and three
  Newton corrections of the return time.  Its derivatives are Taylor
  jets through the flow (`_ReturnMapJets`): each Runge-Kutta stage
  evaluates F, J.v, d2F and d3F on the jets of one order, all directions
  of a stage in one batch, so a third-order form costs one pass of the
  integrator with plain tensors (forward AD through a few thousand
  integrator operations would cost 0.3-0.8 ms per operation on a host).
  Mixed directions come from univariate jets by polarization; the
  parameter derivatives of the map (its `branch point` route) are jets
  too, with the parameter as one more direction.
"""
from __future__ import annotations

from math import comb
from types import SimpleNamespace

import numpy as np
import torch
from torch.func import jvp, vmap

from ..continuation.results import Branch
from ..core.problem import BifurcationProblem, re_im_rows, weighted_sum
from ..detection.points import NeimarkSacker, PeriodDoubling
from ..linalg.eig import dense_eig
from ..normal_forms.maps import neimark_sacker_nf, period_doubling_nf
from .collocation import Collocation, gauss_states, legendre_tensors
from .flow import _DOPRI5, _RK4
from .trapezoid import F_batch, jv_batch, slice_jacobians


# ---------------------------------------------------------------------------
# the vector field on rows (K, n)
# ---------------------------------------------------------------------------


def _rows_form(prob_vf, params, X, dirs):
    """The real multilinear form of order len(dirs) (1: J.v, 2: d2F,
    3: d3F) at the rows of X (K, n) on the rows of dirs (K, n each), complex
    directions by multilinearity.  A batched model's J.v and user forms
    take the rows in one call; other models go through `vmap`."""
    if any(d.is_complex() for d in dirs):
        rows, weights = re_im_rows(dirs)
        terms = torch.stack([_rows_form(prob_vf, params, X, list(r))
                             for r in rows])
        return weighted_sum(terms, weights)
    k = len(dirs)
    batched = getattr(prob_vf, "batched_F", False)
    if k == 1:
        return jv_batch(prob_vf, X, params, dirs[0])
    user = prob_vf.d2F_user if k == 2 else prob_vf.d3F_user
    if batched and user is not None:
        return user(X, params, *dirs)
    form = prob_vf.d2F if k == 2 else prob_vf.d3F
    return vmap(lambda x, *ds: form(x, params, *ds))(X, *dirs)


# ---------------------------------------------------------------------------
# Iooss periodic-eigenbasis normal form (collocation)
# ---------------------------------------------------------------------------


def _coll_integral(disc: Collocation, mesh, u_nodes, v_nodes):
    """int_0^1 <u(t), v(t)> dt by Gauss quadrature of the node-interpolated
    functions, conjugating the first argument (LA.dot convention; ref
    PeriodicOrbitCollocation.jl:455-492)."""
    L, _, wg = legendre_tensors(disc.m, mesh.dtype, mesh.device)
    dt = torch.promote_types(u_nodes.dtype, v_nodes.dtype)
    gu = gauss_states(L.to(dt), disc.local_nodes(u_nodes.to(dt)))
    gv = gauss_states(L.to(dt), disc.local_nodes(v_nodes.to(dt)))
    d = mesh[1:] - mesh[:-1]
    return torch.sum(wg[None, :, None] * torch.conj(gu) * gv
                     * (d[:, None, None] / 2.0))


def _integral_weights(disc: Collocation, mesh, v_nodes):
    """The gradient in u (real) of int <u, v>: the node weights of the
    quadrature, flat over the nodes."""
    L, _, wg = legendre_tensors(disc.m, mesh.dtype, mesh.device)
    d = mesh[1:] - mesh[:-1]
    gv = gauss_states(L.to(v_nodes.dtype), disc.local_nodes(v_nodes))
    coeff = torch.einsum("i,li,jin->jln", wg.to(gv.dtype), L.to(gv.dtype),
                         gv) * (d[:, None, None] / 2.0)
    n = v_nodes.shape[1]
    idx = (torch.arange(disc.Ntst, device=mesh.device)[:, None] * disc.m
           + torch.arange(disc.m + 1, device=mesh.device)[None, :])
    out = torch.zeros((disc.n_nodes, n), dtype=gv.dtype, device=mesh.device)
    out.index_add_(0, idx.reshape(-1), coeff.reshape(-1, n))
    return out.reshape(-1)


def _coll_linear_operator(disc: Collocation, prob_vf, nodes, T, mesh, params,
                          transpose: bool = False, rho_f: float = 1.0,
                          rho_i: complex = 0.0, bc: str = "periodic",
                          bordered: bool = False):
    """Dense matrix of the linearized collocation operator
    rows(w) = dL w - alpha (rho_f J^(T) + rho_i I) w at the orbit's Gauss
    states, plus n boundary rows (ref po_analytical_jacobian,
    PeriodicOrbitCollocation.jl:646-724; rho_i = -i theta/T gives the
    Neimark-Sacker shift).  bc: 'periodic' (w(1) - w(0) = 0) or
    'antiperiodic' (w(0) + w(1) = 0, the period-doubling condition).
    `bordered=True` returns it as the top-left block of a zero
    (N+1, N+1) buffer, for `_bordered_lu`."""
    L, dL, _ = legendre_tensors(disc.m, nodes.dtype, nodes.device)
    n = nodes.shape[1]
    m, Ntst = disc.m, disc.Ntst
    d = mesh[1:] - mesh[:-1]
    alpha = T * d / 2.0
    P = gauss_states(L, disc.local_nodes(nodes)).reshape(-1, n)
    Jp = slice_jacobians(prob_vf, P, params).reshape(Ntst, m, n, n)
    if transpose:
        Jp = Jp.transpose(-1, -2)
    cplx = isinstance(rho_i, complex) and rho_i.imag != 0
    dtype = torch.complex128 if cplx else nodes.dtype
    eye = torch.eye(n, dtype=dtype, device=nodes.device)
    shifted = rho_f * Jp.to(dtype) + rho_i * eye
    # (Ntst, m rows i, m+1 cols l, n, n) -> (Ntst, m n, (m+1) n)
    blk = (dL.T.to(dtype)[None, :, :, None, None] * eye
           - alpha.to(dtype)[:, None, None, None, None]
           * L.T.to(dtype)[None, :, :, None, None] * shifted[:, :, None])
    blk = blk.permute(0, 1, 3, 2, 4).reshape(Ntst, m * n, (m + 1) * n)
    n_tot = (Ntst * m + 1) * n
    size = n_tot + 1 if bordered else n_tot
    M = torch.zeros((size, size), dtype=dtype, device=nodes.device)
    for j in range(Ntst):
        M[j * m * n:(j + 1) * m * n, j * m * n:(j * m + m + 1) * n] = blk[j]
    M[n_tot - n:n_tot, :n] = eye if bc == "antiperiodic" else -eye
    M[n_tot - n:n_tot, n_tot - n:n_tot] = eye
    return M


def _uniform_borders(nj, seed, dtype, device):
    g = torch.Generator().manual_seed(int(seed))
    br = torch.rand(nj, generator=g, dtype=torch.float64) - 0.5
    bl = torch.rand(nj, generator=g, dtype=torch.float64) - 0.5
    return br.to(device=device, dtype=dtype), bl.to(device=device,
                                                    dtype=dtype)


def _null_bordered(Mb, seed, borders=None):
    """Null vector of the (numerically singular) operator in the top-left
    of the bordered buffer Mb ((N+1, N+1), last row and column free) by a
    bordered solve with refined borders (ref the extended-system kernel
    computation, periodicorbit/NormalForms.jl:612-637).  The first
    bordered matrix is factored once for its solve and its adjoint solve;
    the refined one once more.  Borders: uniform in [-0.5, 0.5) from a CPU
    `torch.Generator` seeded with `seed`, or the given (br, bl)."""
    nj = Mb.shape[0] - 1
    if borders is None:
        br, bl = _uniform_borders(nj, seed, Mb.dtype, Mb.device)
    else:
        br, bl = (torch.as_tensor(b).to(dtype=Mb.dtype, device=Mb.device)
                  for b in borders)
    rhs = torch.zeros((nj + 1, 1), dtype=Mb.dtype, device=Mb.device)
    rhs[-1] = 1.0
    Mb[:nj, -1] = br
    Mb[-1, :nj] = bl
    LU, piv = torch.linalg.lu_factor(Mb)
    k = torch.linalg.lu_solve(LU, piv, rhs)[:nj, 0]
    l = torch.linalg.lu_solve(LU, piv, rhs, adjoint=True)[:nj, 0]
    del LU
    k = k / torch.linalg.vector_norm(k)
    l = l / torch.linalg.vector_norm(l)
    # refined borders: the right border spans the left null space and
    # vice versa
    Mb[:nj, -1] = l
    Mb[-1, :nj] = k
    LU, piv = torch.linalg.lu_factor(Mb)
    return torch.linalg.lu_solve(LU, piv, rhs)[:nj, 0]


def _icoll_rhs(disc, mesh, g_nodes):
    """Icoll g: the dt-scaled Gauss interpolation rows and the boundary
    rows g(1) - g(0) of a node function."""
    L, _, _ = legendre_tensors(disc.m, mesh.dtype, mesh.device)
    d = mesh[1:] - mesh[:-1]
    gg = gauss_states(L.to(g_nodes.dtype), disc.local_nodes(g_nodes)) \
        * (d[:, None, None] / 2.0)
    return torch.cat([gg.reshape(-1), g_nodes[-1] - g_nodes[0]])


def _pd_iooss_core(disc: Collocation, prob_vf, n: int, X, params, mesh,
                   detailed: bool = True, borders=None):
    """Core of the Iooss PD normalization at one orbit point; returns a
    dict with a, b3 and the eigenfunctions (see period_doubling_iooss).
    `borders` optionally gives the three null solves' (br, bl)."""
    nodes, T = disc.split(X, n)
    Tf = float(T)
    borders = borders or (None, None, None)
    integ = lambda u, v: _coll_integral(disc, mesh, u, v)
    as_nodes = lambda w: w.reshape(disc.n_nodes, n)
    op = lambda **kw: _coll_linear_operator(disc, prob_vf, nodes, T, mesh,
                                            params, bordered=True, **kw)

    # v1: the Floquet eigenfunction for mu = -1 (antiperiodic null)
    v1 = _null_bordered(op(bc="antiperiodic"), 0, borders[0])
    v1 = v1 / torch.sqrt(integ(as_nodes(v1), as_nodes(v1)))
    v1n = as_nodes(v1)
    # adjoint eigenfunction: null of the transposed operator, rho_f = -1
    v1s = _null_bordered(op(transpose=True, rho_f=-1.0, bc="antiperiodic"),
                         1, borders[1])
    v1s = v1s / (2.0 * integ(as_nodes(v1s), v1n))
    if not detailed:
        return {"a": 0.0, "b3": 0.0, "v1": v1, "v1s": v1s, "T": Tf}
    v1sn = as_nodes(v1s)

    # per-node jets along the orbit
    Fu0 = F_batch(prob_vf, nodes, params)
    Av = _rows_form(prob_vf, params, nodes, [v1n])
    Bvv = _rows_form(prob_vf, params, nodes, [v1n, v1n])
    Cvvv = _rows_form(prob_vf, params, nodes, [v1n, v1n, v1n])

    # psi1*: periodic null function of the adjoint operator, normalized by
    # 2 int <psi1*, F(u0)> = 1
    psi1s = _null_bordered(op(transpose=True, rho_f=-1.0), 2, borders[2])
    psi1s = psi1s / (2.0 * integ(as_nodes(psi1s), Fu0))
    psi1sn = as_nodes(psi1s)
    a1 = integ(psi1sn, Bvv)

    # h2: [L_periodic psi1*; grad int(., psi1*) 0] h2 = Icoll rhs
    rhs_nodes = Bvv - 2.0 * a1 * Fu0
    Mb = op()
    n_tot = Mb.shape[0] - 1
    Mb[:n_tot, -1] = psi1s
    Mb[-1, :n_tot] = _integral_weights(disc, mesh, psi1sn)
    rhs = torch.cat([_icoll_rhs(disc, mesh, rhs_nodes),
                     torch.zeros(1, dtype=X.dtype, device=X.device)])
    h2 = torch.linalg.solve(Mb, rhs)[:n_tot]
    del Mb
    Bvh = _rows_form(prob_vf, params, nodes, [v1n, as_nodes(h2)])
    b3 = (integ(v1sn, Cvvv) / (3.0 * Tf) + integ(v1sn, Bvh)
          - 2.0 * a1 / Tf * integ(v1sn, Av))
    return {"a": float(a1) / Tf, "b3": float(b3), "v1": v1, "v1s": v1s,
            "T": Tf}


def _ns_iooss_core(disc: Collocation, prob_vf, n: int, X, params, mesh,
                   theta: float, borders=None):
    """Core of the Iooss NS normalization at one orbit point (see
    neimark_sacker_iooss); theta = the NS multiplier's angle.  Complex
    operators are complex128."""
    nodes, T = disc.split(X, n)
    Tf = float(T)
    borders = borders or (None, None, None)
    cd = torch.complex128
    as_nodes = lambda w: w.reshape(disc.n_nodes, n)
    integ = lambda u, v: complex(_coll_integral(disc, mesh, u, v))
    op = lambda **kw: _coll_linear_operator(disc, prob_vf, nodes, T, mesh,
                                            params, **kw)

    # v1: periodic part of the NS Floquet eigenfunction,
    # null of D - T A + i theta (ref :1038-1062)
    rho = complex(0.0, -theta / Tf)
    v1 = _null_bordered(op(rho_i=rho, bordered=True), 0, borders[0])
    v1 = v1 / np.sqrt(np.real(integ(as_nodes(v1), as_nodes(v1))))
    v1n = as_nodes(v1)

    # phi1*: real periodic null of the adjoint, <phi1*, F(u0)> = 1
    phi1s = _null_bordered(op(transpose=True, rho_f=-1.0, bordered=True), 1,
                           borders[1])
    Fu0 = F_batch(prob_vf, nodes, params)
    phi1s = phi1s / np.real(integ(as_nodes(phi1s), Fu0))
    phi1sn = as_nodes(phi1s)

    # a1 = <phi1*, B(v1, conj v1)> (real)
    v1b = torch.conj(v1n)
    Bvvb = _rows_form(prob_vf, params, nodes, [v1n, v1b])
    a1 = float(np.real(integ(phi1sn, Bvvb)))

    # v1*: null of the adjoint with the NS shift, <v1*, v1> = 1
    v1s = _null_bordered(op(transpose=True, rho_f=-1.0, rho_i=rho,
                            bordered=True), 2, borders[2])
    v1s = v1s / np.conj(integ(as_nodes(v1s), v1n))
    v1sn = as_nodes(v1s)

    # h20: (D - T A + 2 i theta) h = B(v1, v1), periodic (nonsingular)
    Bvv = _rows_form(prob_vf, params, nodes, [v1n, v1n])
    h20 = torch.linalg.solve(op(rho_i=2 * rho),
                             _icoll_rhs(disc, mesh, Bvv.to(cd)))
    h20n = as_nodes(h20)

    # h11: bordered solve with the integral condition <phi1*, h11> = 0
    rhs11 = Bvvb - a1 * Fu0.to(Bvvb.dtype)
    Mb = op(bordered=True).to(cd)
    n_tot = Mb.shape[0] - 1
    Mb[:n_tot, -1] = phi1s.to(cd)
    Mb[-1, :n_tot] = _integral_weights(disc, mesh, phi1sn).to(cd)
    h11 = torch.linalg.solve(Mb, torch.cat([
        _icoll_rhs(disc, mesh, rhs11.to(cd)),
        torch.zeros(1, dtype=cd, device=X.device)]))[:n_tot]
    del Mb
    h11n = as_nodes(h11)

    # the d coefficient (ref :1180-1199)
    Cvvvb = _rows_form(prob_vf, params, nodes, [v1n, v1n, v1b])
    Bh11v = _rows_form(prob_vf, params, nodes, [h11n, v1n])
    Bh20vb = _rows_form(prob_vf, params, nodes, [h20n, v1b])
    Av = _rows_form(prob_vf, params, nodes, [v1n])
    dcoef = (integ(v1sn, Cvvvb) / Tf + 2.0 * integ(v1sn, Bh11v)
             + integ(v1sn, Bh20vb)) / 2.0
    dcoef += -a1 / Tf * integ(v1sn, Av) + 1j * theta * a1 / Tf ** 2
    return {"a": a1, "d": complex(dcoef), "v1": v1, "v1s": v1s,
            "T": Tf, "theta": theta}


def _po_point(br_po, ind_bif):
    gamma = br_po.gamma if isinstance(br_po, Branch) else br_po
    sp = gamma.specialpoint[ind_bif] if isinstance(ind_bif, int) \
        else ind_bif
    return gamma, sp, gamma.prob


def neimark_sacker_iooss(br_po, ind_bif: int, verbose: bool = False):
    """NS normal form by periodic normalization in the collocation basis
    (ref neimark_sacker_normal_form_iooss,
    periodicorbit/NormalForms.jl:1004-1204, after Kuznetsov-Govaerts-
    Doedel-Dhooge 2005): Re d < 0 => supercritical.  The reference's
    `2Ntst` rescalings of h11/h20 are replaced by the weak-form rhs
    scaling (Icoll), as in the JAX package."""
    gamma, sp, po_prob = _po_point(br_po, ind_bif)
    disc = po_prob.disc
    if not isinstance(disc, Collocation):
        raise TypeError("neimark_sacker_iooss requires Collocation")
    prob_vf = po_prob.prob_vf
    X = torch.as_tensor(sp.x)
    params_full = po_prob.set_lens_param(po_prob.params, sp.param)
    mult = dense_eig(disc.monodromy(prob_vf, X, params_full),
                     with_vectors=False)[0].cpu().numpy()
    cand = np.where(mult.imag > 1e-8)[0]
    if len(cand) == 0:
        raise RuntimeError("no complex Floquet multiplier found for NS")
    i0 = cand[np.argmin(np.abs(np.abs(mult[cand]) - 1.0))]
    theta = abs(float(np.angle(mult[i0])))
    out = _ns_iooss_core(disc, prob_vf, po_prob.n_vf, X,
                         params_full["_inner"], params_full["_mesh"], theta)
    pt = NeimarkSacker(x0=X, p=sp.param, params=params_full["_inner"],
                       lens=prob_vf.lens, zeta=out["v1"],
                       zeta_star=out["v1s"], omega=theta,
                       nf={"a": out["a"], "d": out["d"]}, prob=po_prob)
    pt.period = out["T"]
    pt.subtype = "SuperCritical" if out["d"].real < 0 else "SubCritical"
    if verbose:
        print(f"NS Iooss normal form: a = {out['a']:.6g}, "
              f"d = {out['d']:.6g} theta = {theta:.6g} ({pt.subtype})")
    return pt


def period_doubling_iooss(br_po, ind_bif: int, verbose: bool = False,
                          detailed: bool = True):
    """PD normal form by periodic normalization in the collocation basis
    (Iooss form), no flow re-integration (ref
    period_doubling_normal_form_iooss, periodicorbit/NormalForms.jl:
    574-806).  FLOW convention: b3 < 0 => supercritical (opposite sign to
    the return map's coefficient; both vanish at a GPD point)."""
    gamma, sp, po_prob = _po_point(br_po, ind_bif)
    disc = po_prob.disc
    if not isinstance(disc, Collocation):
        raise TypeError("period_doubling_iooss requires Collocation")
    prob_vf = po_prob.prob_vf
    X = torch.as_tensor(sp.x)
    params_full = po_prob.set_lens_param(po_prob.params, sp.param)
    out = _pd_iooss_core(disc, prob_vf, po_prob.n_vf, X,
                         params_full["_inner"], params_full["_mesh"],
                         detailed=detailed)
    pt = PeriodDoubling(x0=X, p=sp.param, params=params_full["_inner"],
                        lens=prob_vf.lens, zeta=out["v1"],
                        zeta_star=out["v1s"],
                        nf={"a": out["a"], "b3": out["b3"],
                            "c": out["b3"]}, prob=po_prob)
    pt.period = out["T"]
    pt.subtype = "SuperCritical" if out["b3"] < 0 else "SubCritical"
    if verbose:
        print(f"PD Iooss normal form: a = {out['a']:.6g}, "
              f"b3 = {out['b3']:.6g} ({pt.subtype})")
    return pt


# ---------------------------------------------------------------------------
# Taylor jets through the flow (the Poincare return map's derivatives)
# ---------------------------------------------------------------------------
#
# A jet is a list [x_0, x_1, ..., x_k] of derivatives in a scalar epsilon
# (x_j = d^j x / d eps^j at 0), one row per direction: vectors (K, n),
# scalars (K, 1).


def _jadd(a, b):
    return [x + y for x, y in zip(a, b)]


def _jlin(coeffs, jets):
    """sum_j c_j jet_j over the nonzero coefficients (None if none)."""
    out = None
    for c, J in zip(coeffs, jets):
        if c != 0.0:
            out = [c * x for x in J] if out is None else \
                [o + c * x for o, x in zip(out, J)]
    return out


def _jmul(a, b):
    """Leibniz: (a b)_k = sum_j C(k, j) a_j b_(k-j), a a scalar jet."""
    if len(a) == 1:
        return [a[0] * x for x in b]
    return [sum(comb(k, j) * a[j] * b[k - j] for j in range(k + 1))
            for k in range(len(b))]


def _jdiv(s, d):
    """q = s / d for scalar jets (from s = q d)."""
    q = []
    for k in range(len(s)):
        acc = s[k] - sum(comb(k, j) * q[j] * d[k - j] for j in range(k))
        q.append(acc / d[0])
    return q


class _VectorFieldJet:
    """F on a jet of states: f_0 = F(x_0), f_1 = J x_1,
    f_2 = J x_2 + B(x_1, x_1), f_3 = J x_3 + 3 B(x_1, x_2) + C(x_1^3),
    each order's J.v, d2F and d3F on the K rows in one call.

    With `pjet = (lens_set, p, dp)` the parameter moves along the jet too,
    p(eps) = p + eps dp (orders <= 2): the terms in x_1 and dp are the
    derivatives of eps -> F(x_0 + eps x_1, p + eps dp) by nested jvps of
    F, and J x_2 the model's J.v."""

    def __init__(self, prob_vf, params, pjet=None):
        self.prob = prob_vf
        self.params = params
        self.pjet = pjet

    def __call__(self, X):
        p, par = self.prob, self.params
        x0 = X[0]
        out = [F_batch(p, x0, par)]
        k = len(X) - 1
        if self.pjet is not None and k >= 1:
            return out + self._param_terms(X)
        if k >= 1:
            Jx = _rows_form(p, par, x0.repeat(k, 1), [torch.cat(X[1:])])
            Js = Jx.split(x0.shape[0])
            out.append(Js[0])
        if k >= 2:
            if k == 2:
                B = _rows_form(p, par, x0, [X[1], X[1]])
                out.append(Js[1] + B)
            else:
                B = _rows_form(p, par, x0.repeat(2, 1),
                               [torch.cat([X[1], X[1]]),
                                torch.cat([X[1], X[2]])])
                B11, B12 = B.split(x0.shape[0])
                out.append(Js[1] + B11)
                C = _rows_form(p, par, x0, [X[1], X[1], X[1]])
                out.append(Js[2] + 3.0 * B12 + C)
        return out

    def _param_terms(self, X):
        lens_set, pv, dp = self.pjet
        x0, x1 = X[0], X[1]
        k = len(X) - 1
        if k > 2:
            raise NotImplementedError("parameter jets go to order 2")
        e0 = torch.zeros((), dtype=x0.dtype, device=x0.device)
        one = torch.ones_like(e0)

        def h(e):
            return F_batch(self.prob, x0 + e * x1,
                           lens_set(self.params, pv + e * dp))

        if k == 1:
            return [jvp(h, (e0,), (one,))[1]]
        d1, d2 = jvp(lambda e: jvp(h, (e,), (one,))[1], (e0,), (one,))
        return [d1, _rows_form(self.prob, self.params, x0, [X[2]]) + d2]


def _erk_jet(fj, U, dt, tableau):
    """One explicit Runge-Kutta step of a state jet U with a step jet dt."""
    A, b = tableau
    ks = []
    for row in A:
        s = _jlin(row, ks)
        Y = U if s is None else _jadd(U, _jmul(dt, s))
        ks.append(fj(Y))
    return _jadd(U, _jmul(dt, _jlin(b, ks)))


_TABLEAUS = {"rk4": _RK4, "dopri5": _DOPRI5}


class _ReturnMapJets:
    """The Poincare return map P over hyperplane coordinates y (n-1)
    around x0 with normal F(x0) (ref PoincareMap solve/extend,
    PoincareRM.jl:32-190): x = x0 + B y, the flow for time T in `steps`
    fixed steps, then `newton_steps` corrections of the return time
    (dt = -<x - x0, nu> / <F(x), nu>, one step of size dt each), and
    P(y) = B^T (x - x0).  `jets(y, dirs, order)` gives the derivatives
    d^j/d eps^j P(y + eps d), j <= order, for the rows d of `dirs`."""

    def __init__(self, prob_vf, x0, params, T, steps=200, newton_steps=3,
                 method="dopri5"):
        self.prob = prob_vf
        self.x0 = x0
        self.params = params
        self.T = float(T)
        self.steps = steps
        self.newton_steps = newton_steps
        self.method = method
        self.tableau = _TABLEAUS[method]
        n = x0.shape[0]
        F0 = F_batch(prob_vf, x0[None], params)[0]
        self.normal = F0 / torch.linalg.vector_norm(F0)
        A = torch.cat([self.normal[:, None],
                       torch.eye(n, dtype=x0.dtype, device=x0.device)], 1)
        Q, _ = torch.linalg.qr(A)
        self.B = Q[:, 1:n]

    def with_params(self, params):
        return _ReturnMapJets(self.prob, self.x0, params, self.T, self.steps,
                              self.newton_steps, self.method)

    def jets(self, y, dirs, order: int, params=None, pjet=None):
        par = self.params if params is None else params
        fj = _VectorFieldJet(self.prob, par, pjet)
        K = dirs.shape[0]
        like = dict(dtype=self.x0.dtype, device=self.x0.device)
        x0 = self.x0
        X = [(x0 + self.B @ y).expand(K, -1).contiguous()]
        if order >= 1:
            X.append(dirs @ self.B.T)
        X += [torch.zeros_like(X[0]) for _ in range(order - 1)]
        h = [torch.full((K, 1), self.T / self.steps, **like)]
        for _ in range(self.steps):
            X = _erk_jet(fj, X, h, self.tableau)
        nu = self.normal
        for _ in range(self.newton_steps):
            s = [(X[0] - x0) @ nu] + [x @ nu for x in X[1:]]
            ds = [f @ nu for f in fj(X)]
            dt = [-q[:, None] for q in _jdiv(s, ds)]
            X = _erk_jet(fj, X, dt, self.tableau)
        return [(X[0] - x0) @ self.B] + [x @ self.B for x in X[1:]]

    # --- derived quantities -------------------------------------------
    def value(self, y, params=None):
        return self.jets(y, torch.zeros((1, y.shape[0]), dtype=y.dtype,
                                        device=y.device), 0, params)[0][0]

    def jacobian(self, y, params=None):
        m = y.shape[0]
        eye = torch.eye(m, dtype=y.dtype, device=y.device)
        return self.jets(y, eye, 1, params)[1].T

    def forms_rows(self, order, y, params, rows):
        """The real `order`-linear form (2 or 3) of P at y on each tuple of
        real directions in `rows`, by polarization of univariate jets, all
        jets in one pass.  Returns (len(rows), m)."""
        dirs, plan = [], []
        for r in rows:
            start = len(dirs)
            if order == 2:
                a, b = r
                if a is b or torch.equal(a, b):
                    dirs.append(a)
                    plan.append((start, [1.0]))
                else:
                    dirs += [a + b, a - b]
                    plan.append((start, [0.25, -0.25]))
            else:
                a, b, c = r
                if (a is b or torch.equal(a, b)) and \
                        (b is c or torch.equal(b, c)):
                    dirs.append(a)
                    plan.append((start, [1.0]))
                else:
                    for e2, e3 in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
                        dirs.append(a + e2 * b + e3 * c)
                    plan.append((start, [w / 24.0 for w in
                                         (1.0, -1.0, -1.0, 1.0)]))
        Q = self.jets(y, torch.stack(dirs), order, params)[order]
        return torch.stack([sum(w * Q[s + i] for i, w in enumerate(ws))
                            for s, ws in plan])

    def param_derivatives(self, lens_set, p):
        """Exact parameter derivatives of P at y: the parameter rides the
        jets as one more direction (the anchor x0 and the section stay)."""
        return _ParamJets(self, lens_set, float(p))


class _ParamJets:
    """dP/dp, d2P/dp2 and d/dp (DP v) at the point from one pass of jets
    in (y + eps d, p + eps), order 2, on the rows d = 0, +-e_i: the row
    d = 0 gives the first two, the rows +-e_i the mixed matrix
    M = d2P/dy dp by polarization, (Q(e_i) - Q(-e_i)) / 4, and
    d/dp (DP v) = M v."""

    def __init__(self, jets, lens_set, p):
        self.jets = jets
        self.pjet = (lens_set, p, 1.0)
        self._at = None

    def _pass(self, y):
        if self._at is not None and torch.equal(self._at[0], y):
            return self._at
        eye = torch.eye(y.shape[0], dtype=y.dtype, device=y.device)
        dirs = torch.cat([torch.zeros_like(y)[None], eye, -eye])
        D = self.jets.jets(y, dirs, 2, pjet=self.pjet)
        m = y.shape[0]
        M = (D[2][1:m + 1] - D[2][m + 1:]).T / 4.0
        self._at = (y.clone(), D[1][0], D[2][0], M)
        return self._at

    def dFdp(self, y):
        return self._pass(y)[1]

    def d2Fdp2(self, y):
        return self._pass(y)[2]

    def dFdp_dir(self, y, v):
        return self._pass(y)[3] @ v


def poincare_return_map(prob_vf, x0, params, T, steps: int = 200,
                        newton_steps: int = 3):
    """Return (map_prob, y0): P as a BifurcationProblem over hyperplane
    coordinates y (n-1), anchored at x0 with normal F(x0) (ref
    PoincareMap solve/extend, PoincareRM.jl:32-190).  Its jacobian (`jac`)
    and forms (`forms_rows`, which `_FlatProblem` uses) are jets through
    the flow; so are its parameter derivatives (`param_derivatives`)."""
    x0 = torch.as_tensor(x0)
    jets = _ReturnMapJets(prob_vf, x0, params, T, steps=steps,
                          newton_steps=newton_steps)
    return _map_problem(prob_vf, jets, params, shift=0.0), \
        torch.zeros(x0.shape[0] - 1, dtype=x0.dtype, device=x0.device)


def _map_problem(prob_vf, jets, params, shift=0.0):
    """P(y) - shift y as a BifurcationProblem with its jet derivatives."""
    def P(y, par):
        return jets.value(y, par) - shift * y

    def jac(y, par):
        J = jets.jacobian(y, par)
        return J - shift * torch.eye(J.shape[0], dtype=J.dtype,
                                     device=J.device)

    prob = BifurcationProblem(P, u0=torch.zeros_like(jets.x0[1:]),
                              params=params, lens=prob_vf.lens, jac=jac)

    memo = {}

    def param_derivatives(par, p):
        """One `_ParamJets` per point (par, p), so its single pass of jets
        serves every parameter derivative a normal form asks there."""
        key = (id(par), float(p))
        if memo.get("key") != key:
            memo.update(key=key, par=par, pj=jets.with_params(
                par).param_derivatives(prob_vf.set_lens_param, p))
        return memo["pj"]

    object.__setattr__(prob, "forms_rows", jets.forms_rows)
    object.__setattr__(prob, "param_derivatives", param_derivatives)
    return prob


def make_prm_coef_kernels(prob_vf, flow_steps: int = 120,
                          newton_steps: int = 3):
    """Poincare-return-map normal-form evaluators with the curve point
    (x0, T, params) as arguments, for per-step codim-3 monitoring along
    PO codim-2 curves (ref test_for_pd_gpd_cp, MinAugPD.jl:393-438;
    test_for_ns_ch, MinAugNS.jl:415-463).  Returns (dP_fn, pd_coef,
    ns_coef):

      dP_fn(x0, T, par)                 -> (n-1, n-1) return-map jacobian
      pd_coef(x0, T, par, q, p)         -> b3 flip coefficient (real q, p)
      ns_coef(x0, T, par, q, p, theta)  -> d NS coefficient (complex q, p)

    Each is one or two passes of the jets through the flow: the
    directions of one order go in one batch."""
    def _jets(x0, T, par):
        return _ReturnMapJets(prob_vf, torch.as_tensor(x0), par, T,
                              steps=flow_steps, newton_steps=newton_steps)

    def dP_fn(x0, T, par):
        jt = _jets(x0, T, par)
        return jt.jacobian(torch.zeros_like(jt.x0[1:]))

    def pd_coef(x0, T, par, q, p):
        """b3 of xi -> -xi + b3 xi^3 (Kuznetsov 5.4)."""
        jt = _jets(x0, T, par)
        y0 = torch.zeros_like(jt.x0[1:])
        q = torch.as_tensor(q, dtype=y0.dtype, device=y0.device)
        p = torch.as_tensor(p, dtype=y0.dtype, device=y0.device)
        m = y0.shape[0]
        eye = torch.eye(m, dtype=y0.dtype, device=y0.device)
        D = jt.jets(y0, torch.cat([eye, q[None]]), 3)
        A = D[1][:m].T
        Bqq, Cqqq = D[2][m], D[3][m]
        h2 = torch.linalg.solve(eye - A, Bqq)
        Bqh = jt.forms_rows(2, y0, par, [(q, h2)])[0]
        return float(torch.dot(p, Cqqq + 3.0 * Bqh)) / 6.0

    def ns_coef(x0, T, par, q, p, theta):
        """NS first Lyapunov coefficient d (Kuznetsov (5.87))."""
        jt = _jets(x0, T, par)
        y0 = torch.zeros_like(jt.x0[1:])
        cd = torch.complex128
        q = torch.as_tensor(q).to(device=y0.device, dtype=cd)
        p = torch.as_tensor(p).to(device=y0.device, dtype=cd)
        m = y0.shape[0]
        eye = torch.eye(m, dtype=y0.dtype, device=y0.device)
        r, s = q.real.to(y0.dtype), q.imag.to(y0.dtype)
        D = jt.jets(y0, torch.cat([eye, torch.stack([r, s, r + s, r - s])]),
                    3)
        A = D[1][:m].T.to(cd)
        Q2, Q3 = D[2][m:], D[3][m:]
        Brr, Bss = Q2[0], Q2[1]
        Brs = (Q2[2] - Q2[3]) / 4.0
        Bqq = torch.complex(Brr - Bss, 2.0 * Brs)
        Bqqb = (Brr + Bss).to(cd)
        Crrr, Csss = Q3[0], Q3[1]
        Crrs = (Q3[2] - Q3[3] - 2.0 * Csss) / 6.0
        Crss = (Q3[2] + Q3[3] - 2.0 * Crrr) / 6.0
        Cqqqb = torch.complex(Crrr + Crss, Crrs + Csss)
        ec = torch.eye(m, dtype=cd, device=y0.device)
        h20 = torch.linalg.solve(complex(np.exp(2j * theta)) * ec - A, Bqq)
        h11 = torch.linalg.solve(ec - A, Bqqb)
        qb = torch.conj(q)
        rows, weights, owner = [], [], []
        for t, (a, b) in enumerate(((q, h11), (qb, h20))):
            rr, ww = re_im_rows([a, b])
            rows += rr
            weights += ww
            owner += [t] * len(rr)
        terms = jt.forms_rows(2, y0, par, [tuple(x.to(y0.dtype) for x in rr)
                                           for rr in rows])
        Bq_h11 = weighted_sum(terms[[i for i, o in enumerate(owner)
                                     if o == 0]],
                              [w for w, o in zip(weights, owner) if o == 0])
        Bqb_h20 = weighted_sum(terms[[i for i, o in enumerate(owner)
                                      if o == 1]],
                               [w for w, o in zip(weights, owner) if o == 1])
        gv = Cqqqb + 2.0 * Bq_h11 + Bqb_h20
        g21 = torch.sum(torch.conj(p) * gv) / 2.0
        return float(torch.real(complex(np.exp(-1j * theta)) * g21))

    return dP_fn, pd_coef, ns_coef


def get_normal_form_po(br_po, ind_bif: int, verbose: bool = False,
                       flow_steps: int = 300, method: str = "prm"):
    """Normal form of a PD / NS / BP point on a periodic-orbit branch.

    method='prm': the Poincare return map's normal form (any
    discretization; ref periodicorbit/NormalForms.jl:325,807).
    method='iooss' (PD and NS, Collocation): periodic normalization in the
    collocation basis (ref :574)."""
    gamma, sp, po_prob = _po_point(br_po, ind_bif)
    if method == "iooss":
        if sp.type == "pd":
            return period_doubling_iooss(br_po, ind_bif, verbose=verbose)
        if sp.type == "ns":
            return neimark_sacker_iooss(br_po, ind_bif, verbose=verbose)
        raise NotImplementedError("the iooss route implements PD and NS")
    if sp.type not in ("pd", "ns", "bp"):
        raise ValueError(f"point {ind_bif} has type {sp.type!r}; expected "
                         "pd/ns/bp on a periodic-orbit branch")
    prob_vf = po_prob.prob_vf
    n = po_prob.n_vf
    X = torch.as_tensor(sp.x)
    T = float(X[-1])
    x0 = X[:-1].reshape(-1, n)[0]
    params = prob_vf.set_lens_param(prob_vf.params, sp.param)
    map_prob, y0 = poincare_return_map(prob_vf, x0, params, T,
                                       steps=flow_steps)
    if sp.type in ("pd", "ns"):
        nf = period_doubling_nf if sp.type == "pd" else neimark_sacker_nf
        pt = nf(map_prob, y0, params, verbose=verbose)
        pt.p = sp.param
        pt.period = T
        return pt
    # bp of PO: Lyapunov-Schmidt on the fixed-point problem of the return
    # map, Phi(y, p) = P(y, p) - y (ref branch_normal_form,
    # periodicorbit/NormalForms.jl:60-92)
    from ..detection.points import SpecialPoint
    from ..normal_forms.codim1 import get_normal_form1d

    jets = _ReturnMapJets(prob_vf, x0, params, T, steps=flow_steps)
    phi_prob = _map_problem(prob_vf, jets, params, shift=1.0)
    L = phi_prob.jacobian(y0, params)
    vals, vecs = np.linalg.eig(L.detach().cpu().numpy())
    ind = int(np.argmin(np.abs(vals)))
    sp2 = SpecialPoint(type="bp", param=sp.param, x=y0, ind_ev=ind + 1,
                       eigenvals=vals, eigenvecs=vecs)
    pt = get_normal_form1d(phi_prob, SimpleNamespace(specialpoint=[sp2],
                                                     prob=None),
                           0, verbose=verbose)
    pt.period = T
    return pt
