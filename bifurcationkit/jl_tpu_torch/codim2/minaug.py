"""Codim-2 minimally augmented continuation, dense route — the port of
`jl_tpu/codim2/minaug.py` (ref src/codim2/MinAugFold.jl, MinAugHopf.jl).

Fold curve: unknown X = (x, p1), functional G = (F(x, p1), sigma(x, p1))
where sigma comes from the bordered solve [J a; b' 0][v; sigma] = [0; 1].
Hopf curve: unknown X = (x, p1, omega), the complex-shifted bordered
system [J - i omega I, a; b^H 0] and G = (F, Re sigma, Im sigma).

G is a plain torch function of X (the sigma solve is a dense (n+1) solve),
so the augmented problem is an ordinary `BifurcationProblem` whose
jacobian comes from `torch.func.jacfwd`, and the whole PALC and detection
stack applies unchanged.  The complex shifted solve runs in complex128;
the JAX package's real 2(n+1) embedding is a TPU workaround.  The border
vectors (a, b) live in the parameters, so the re-anchoring `update` hook
never rebuilds the problem.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..continuation.algorithms import PALC
from ..continuation.driver import continuation
from ..continuation.results import Branch, ContResult
from ..core.lens import Lens, as_lens
from ..core.params import ContinuationPar, NewtonPar
from ..core.problem import BifurcationProblem
from ..core.state import ravel
from ..detection.events import ContinuousEvent, DiscreteEvent, PairOfEvents
from ..linalg.eig import dense_eig
from ..newton import newton

COMPLEX_DTYPE = torch.complex128


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _is_complex(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_complex()
    return isinstance(x, complex)


def _border_solve(J, a, b, shift=None):
    """Solve [J + shift*I, a; b^H, 0][v; sigma] = [0; 1]; returns (v, sigma)
    (ref _compute_bordered_vectors, src/codim2/MinAugFold.jl:44-80).  A
    complex shift or border solves in complex128.  Built without in-place
    writes, so `torch.func.jacfwd` differentiates through it."""
    n = J.shape[0]
    cplx = _is_complex(J) or _is_complex(a) or _is_complex(b) \
        or _is_complex(shift)
    dtype = COMPLEX_DTYPE if cplx else J.dtype
    Js = J.to(dtype)
    if shift is not None:
        Js = Js + shift * torch.eye(n, dtype=dtype, device=J.device)
    zero = torch.zeros((1, 1), dtype=dtype, device=J.device)
    A = torch.cat([torch.cat([Js, a.to(dtype)[:, None]], dim=1),
                   torch.cat([torch.conj(b).to(dtype)[None, :], zero], dim=1)])
    rhs = torch.cat([torch.zeros((n,), dtype=dtype, device=J.device),
                     torch.ones((1,), dtype=dtype, device=J.device)])
    sol = torch.linalg.solve(A, rhs)
    return sol[:n], sol[n]


def _adjoint_border_solve(J, a, b, shift=None):
    """Same for the adjoint system: [J^H b; a^H 0][w; sigma*] = [0; 1]."""
    Jt = torch.conj(J).T if J.is_complex() else J.T
    sh = None if shift is None else (
        torch.conj(shift) if isinstance(shift, torch.Tensor)
        else np.conj(shift))
    return _border_solve(Jt, b, a, sh)


def _ma_lens(outer_lens, name):
    return Lens(
        get=lambda par: outer_lens.get(par["_inner"]),
        set=lambda par, v: {**par, "_inner": outer_lens.set(par["_inner"], v)},
        name=f"{name}/{outer_lens.name}")


def _set_ma_attrs(maprob, prob, inner_lens, outer_lens, n, unravel, kind,
                  eig_jacobian, **extra):
    """The MA problem's attributes beside its fields: the inner problem and
    lenses, the inner size, the spectrum operator and, for the
    matrix-free problems, `extra`."""
    attrs = dict(eig_jacobian=eig_jacobian, inner_prob=prob,
                 inner_lens=inner_lens, n_inner=n, unravel_inner=unravel,
                 ma_kind=kind, outer_lens=outer_lens, **extra)
    for name, val in attrs.items():
        object.__setattr__(maprob, name, val)
    return maprob


# ---------------------------------------------------------------------------
# Fold and Hopf MA problems
# ---------------------------------------------------------------------------


def fold_ma_problem(prob: BifurcationProblem, lens1, lens2,
                    a0, b0) -> BifurcationProblem:
    inner_lens = as_lens(lens1)
    outer_lens = as_lens(lens2)
    flat0, unravel = ravel(prob.u0)
    n = flat0.shape[0]

    def G(X, par):
        x, p1 = X[:n], X[n]
        params = inner_lens.set(par["_inner"], p1)
        F = ravel(prob.F(unravel(x), params))[0]
        J = prob.jacobian(unravel(x), params)
        _, sigma = _border_solve(J, par["_a"], par["_b"])
        return torch.cat([F, torch.real(sigma).reshape(1)])

    def record(X, p2, **k):
        return {"param": p2, "p1": X[n],
                "norm": torch.linalg.vector_norm(X[:n])}

    def eig_jacobian(X, par):
        params = inner_lens.set(par["_inner"], X[n])
        return prob.jacobian(unravel(X[:n]), params)

    maprob = BifurcationProblem(
        G, u0=None,
        params={"_inner": prob.params, "_a": torch.ones_like(flat0),
                "_b": torch.ones_like(flat0)},
        lens=_ma_lens(outer_lens, "fold-ma"), record_from_solution=record,
        update=_make_minaug_update(prob, inner_lens, n, unravel,
                                   is_hopf=False))
    return _set_ma_attrs(maprob, prob, inner_lens, outer_lens, n, unravel,
                         "fold", eig_jacobian)


def hopf_ma_problem(prob: BifurcationProblem, lens1, lens2,
                    a0, b0) -> BifurcationProblem:
    inner_lens = as_lens(lens1)
    outer_lens = as_lens(lens2)
    flat0, unravel = ravel(prob.u0)
    n = flat0.shape[0]

    def G(X, par):
        x, p1, omega = X[:n], X[n], X[n + 1]
        params = inner_lens.set(par["_inner"], p1)
        F = ravel(prob.F(unravel(x), params))[0]
        J = prob.jacobian(unravel(x), params)
        # lambda = +i omega: J - i omega I is the singular operator with
        # right null vector zeta (ref MinAugHopf.jl:19-80, conjugate
        # convention there)
        _, sigma = _border_solve(J, par["_a"], par["_b"], -1j * omega)
        return torch.cat([F, torch.real(sigma).reshape(1),
                          torch.imag(sigma).reshape(1)])

    def record(X, p2, **k):
        return {"param": p2, "p1": X[n], "omega": X[n + 1],
                "norm": torch.linalg.vector_norm(X[:n])}

    def eig_jacobian(X, par):
        params = inner_lens.set(par["_inner"], X[n])
        return prob.jacobian(unravel(X[:n]), params)

    one = torch.ones_like(flat0).to(COMPLEX_DTYPE)
    maprob = BifurcationProblem(
        G, u0=None, params={"_inner": prob.params, "_a": one, "_b": one},
        lens=_ma_lens(outer_lens, "hopf-ma"), record_from_solution=record,
        update=_make_minaug_update(prob, inner_lens, n, unravel,
                                   is_hopf=True))
    return _set_ma_attrs(maprob, prob, inner_lens, outer_lens, n, unravel,
                         "hopf", eig_jacobian)


def _make_minaug_update(prob, inner_lens, n, unravel, is_hopf: bool,
                        every: int = 1):
    """Re-anchor the border vectors to the current null vectors
    (ref update a, b every update_minaug_every_step, MinAugFold.jl:280-314)."""

    def update(it, state):
        if every <= 0 or state.step % every != 0:
            return None
        par = it.current_params
        X = state.z.u
        params = inner_lens.set(par["_inner"], X[n])
        J = prob.jacobian(unravel(X[:n]), params)
        shift = -1j * X[n + 1] if is_hopf else None
        v, _ = _border_solve(J, par["_a"], par["_b"], shift)
        w, _ = _adjoint_border_solve(J, par["_a"], par["_b"], shift)
        new = dict(par)
        new["_b"] = (v / torch.linalg.vector_norm(v)).to(par["_b"].dtype)
        new["_a"] = (w / torch.linalg.vector_norm(w)).to(par["_a"].dtype)
        if is_hopf and float(X[n + 1]) < 0:
            # pin omega > 0: (x, p1, -omega) is the conjugate solution; flip
            # it back so the BT test (omega -> 0) fires at genuine BTs only
            Xf = X.clone()
            Xf[n + 1] = -X[n + 1]
            state.z = dataclasses.replace(state.z, u=Xf)
            new["_a"] = torch.conj(new["_a"])
            new["_b"] = torch.conj(new["_b"])
        return new

    return update


# ---------------------------------------------------------------------------
# starting data from a codim-1 point (host eig of the dense jacobian)
# ---------------------------------------------------------------------------


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _fold_start(br, ind_bif):
    sp = br.specialpoint[ind_bif]
    if sp.type not in ("fold", "bp"):
        raise ValueError(f"point {ind_bif} is a {sp.type!r}, not fold/bp")
    prob = br.prob
    p1 = float(sp.param)
    params = prob.set_lens_param(prob.params, p1)
    x_flat, _ = ravel(sp.x)
    J = prob.jacobian(sp.x, params)
    vals, vecs = (_host(t) for t in dense_eig(J))
    zeta = np.real(vecs[:, int(np.argmin(np.abs(vals.real)))])
    valsT, vecsT = (_host(t) for t in dense_eig(J.T))
    zeta_ad = np.real(vecsT[:, int(np.argmin(np.abs(valsT.real)))])
    like = dict(dtype=x_flat.dtype, device=x_flat.device)
    return (x_flat, p1, torch.as_tensor(zeta / np.linalg.norm(zeta), **like),
            torch.as_tensor(zeta_ad / np.linalg.norm(zeta_ad), **like))


def _hopf_start(br, ind_bif):
    sp = br.specialpoint[ind_bif]
    if sp.type != "hopf":
        raise ValueError(f"point {ind_bif} is a {sp.type!r}, not hopf")
    prob = br.prob
    p1 = float(sp.param)
    params = prob.set_lens_param(prob.params, p1)
    x_flat, _ = ravel(sp.x)
    J = prob.jacobian(sp.x, params)
    vals, vecs = (_host(t) for t in dense_eig(J))
    cand = np.where(vals.imag > 1e-10)[0]
    if len(cand) == 0:
        raise RuntimeError("no complex eigenvalue found at the Hopf point")
    i0 = cand[np.argmin(np.abs(vals.real[cand]))]
    lam = vals[i0]
    zeta = vecs[:, i0] / np.linalg.norm(vecs[:, i0])
    valsT, vecsT = (_host(t) for t in dense_eig(J.T))
    zeta_ad = vecsT[:, int(np.argmin(np.abs(valsT - np.conj(lam))))]
    zeta_ad = zeta_ad / np.linalg.norm(zeta_ad)
    dev = x_flat.device
    return (x_flat, p1, float(lam.imag),
            torch.as_tensor(zeta, dtype=COMPLEX_DTYPE, device=dev),
            torch.as_tensor(zeta_ad, dtype=COMPLEX_DTYPE, device=dev))


# ---------------------------------------------------------------------------
# codim-2 test functions as events (BT/cusp/ZH on fold; BT/GH on Hopf)
# ---------------------------------------------------------------------------


def _fold_codim2_event(maprob):
    n = maprob.n_inner
    inner = maprob.inner_prob
    inner_lens = maprob.inner_lens
    unravel = maprob.unravel_inner

    def cond(it, state):
        # the CURRENT curve parameter p2: current_params holds the base
        # parameters only (the engine sets the lens value when it
        # evaluates F)
        par = it.prob.set_lens_param(it.current_params, float(state.p))
        X = state.z.u
        params = inner_lens.set(par["_inner"], X[n])
        J = inner.jacobian(unravel(X[:n]), params)
        v, _ = _border_solve(J, par["_a"], par["_b"])
        w, _ = _adjoint_border_solve(J, par["_a"], par["_b"])
        v = v / torch.linalg.vector_norm(v)
        w = w / torch.linalg.vector_norm(w)
        bt = float(torch.real(torch.sum(torch.conj(w) * v)))
        # cusp = fold of the fold curve in the continuation parameter
        # (ref CP = getp(state.tau), MinAugFold.jl:574)
        return (bt, float(state.tau.p))

    cont = ContinuousEvent(nb=2, condition=cond, labels=["bt", "cusp"])

    def zh_cond(it, state):
        """ZH: eigenvalues right of the fold eigenvalue with a nonzero
        imaginary part (ref test_zh, MinAugFold.jl:539-549)."""
        if state.eigvals is None:
            return (0,)
        eps = it.contparams.tol_stability
        rho = np.min(np.abs(state.eigvals.real))
        return (int(np.sum((state.eigvals.real > rho)
                           & (state.eigvals.imag > eps))),)

    disc = DiscreteEvent(nb=1, condition=zh_cond, labels=["zh"])
    return PairOfEvents(cont, disc)


def _hopf_codim2_event(maprob, with_gh: bool = True):
    n = maprob.n_inner
    l1_fn = _make_l1_kernel(maprob) if with_gh else None

    def cond(it, state):
        X = state.z.u
        vals = [float(X[n + 1])]
        if with_gh:
            par = it.prob.set_lens_param(it.current_params, float(state.p))
            vals.append(float(l1_fn(X, par["_inner"])))
        return tuple(vals)

    labels = ["bt"] + (["gh"] if with_gh else [])
    return ContinuousEvent(nb=1 + int(with_gh), condition=cond,
                           labels=labels)


def _l1_at(fp, J, omega, zeta, zeta_ad):
    """First Lyapunov coefficient from the critical pair (zeta, zeta_ad),
    <zeta, zeta_ad> = 1, by dense complex solves.  F is real, so the
    complex forms split into real ones, each stage's in one batched call:

        2 R2(z, z) = (d2[zr,zr] - d2[zi,zi]) + 2i d2[zr,zi],
        2 R2(z, conj z) = d2[zr,zr] + d2[zi,zi],
        6 R3(z, z, conj z) = d3[zr,zr,zr] + d3[zi,zi,zr]
                             + i (d3[zr,zr,zi] + d3[zi,zi,zi])."""
    n = J.shape[0]
    zr, zi = torch.real(zeta), torch.imag(zeta)
    d_rr, d_ii, d_ri = fp.forms_batch(fp.prob.d2F, torch.stack([zr, zi, zr]),
                                      torch.stack([zr, zi, zi]))
    Jc = J.to(COMPLEX_DTYPE)
    eye = torch.eye(n, dtype=COMPLEX_DTYPE, device=J.device)
    Psi200 = torch.linalg.solve(2j * omega * eye - Jc,
                                torch.complex(0.5 * (d_rr - d_ii), d_ri))
    Psi110 = torch.linalg.solve(-Jc, (d_rr + d_ii).to(COMPLEX_DTYPE))
    # bv = 2 R2(z, Psi110) + 2 R2(conj z, Psi200) + 3 R3(z, z, conj z)
    pr, pi = torch.real(Psi110), torch.imag(Psi110)
    qr, qi = torch.real(Psi200), torch.imag(Psi200)
    t = fp.forms_batch(fp.prob.d2F,
                       torch.stack([zr, zi, zr, zi, zr, zi, zr, zi]),
                       torch.stack([pr, pi, pi, pr, qr, qi, qi, qr]))
    c = fp.forms_batch(fp.prob.d3F, torch.stack([zr, zi, zr, zi]),
                       torch.stack([zr, zi, zr, zi]),
                       torch.stack([zr, zr, zi, zi]))
    bv = torch.complex(t[0] - t[1] + t[4] + t[5] + 0.5 * (c[0] + c[1]),
                       t[2] + t[3] + t[6] - t[7] + 0.5 * (c[2] + c[3]))
    return float(torch.real(torch.sum(torch.conj(bv) * zeta_ad)))


def _make_l1_kernel(maprob):
    """First Lyapunov coefficient along the Hopf MA curve (the per-step GH
    test), from a host eig of the dense inner jacobian."""
    from ..normal_forms.codim1 import _FlatProblem

    inner = maprob.inner_prob
    inner_lens = maprob.inner_lens
    n = maprob.n_inner
    unravel = maprob.unravel_inner

    def l1_fn(X, par_inner):
        omega = float(X[n + 1])
        fp = _FlatProblem(inner, unravel(X[:n]),
                          inner_lens.set(par_inner, X[n]))
        J = fp.jacobian()
        vals, vecs = dense_eig(J)
        lam_t = 1j * omega
        # right eigenvector closest to i omega, left one to its conjugate
        zeta = vecs[:, int(torch.argmin(torch.abs(vals - lam_t)))]
        zeta = zeta / torch.linalg.vector_norm(zeta)
        valsT, vecsT = dense_eig(J.T)
        iT = int(torch.argmin(torch.abs(valsT - np.conj(lam_t))))
        zeta_ad = vecsT[:, iT]
        zeta_ad = zeta_ad / torch.sum(torch.conj(zeta) * zeta_ad)
        return _l1_at(fp, J, omega, zeta, zeta_ad)

    return l1_fn


def _hopf_l1(maprob, it, state):
    """First Lyapunov coefficient along the Hopf curve (GH test,
    ref MinAugHopf.jl:598-635), from the complex eigenvalue nearest
    i omega of the dense inner jacobian; nan where there is none."""
    from ..normal_forms.codim1 import _FlatProblem, _inner

    n = maprob.n_inner
    X = state.z.u
    omega = float(X[n + 1])
    params = maprob.inner_lens.set(it.current_params["_inner"], X[n])
    fp = _FlatProblem(maprob.inner_prob, maprob.unravel_inner(X[:n]), params)
    J = fp.jacobian()
    vals, vecs = dense_eig(J)
    vals_np = _host(vals)
    cand = np.where(vals_np.imag > 1e-12)[0]
    if len(cand) == 0:
        return np.nan
    i0 = cand[np.argmin(np.abs(vals_np[cand] - 1j * omega))]
    zeta = vecs[:, int(i0)]
    zeta = zeta / torch.linalg.vector_norm(zeta)
    valsT, vecsT = dense_eig(J.T)
    iT = int(np.argmin(np.abs(_host(valsT) - np.conj(vals_np[i0]))))
    zeta_ad = vecsT[:, iT]
    zeta_ad = zeta_ad / _inner(zeta, zeta_ad)
    return _l1_at(fp, J, omega, zeta, zeta_ad)


# ---------------------------------------------------------------------------
# entry points (ref continuation_fold :369 / continuation_hopf :425)
# ---------------------------------------------------------------------------


def _codim2_contparams(cp, detect_codim2_bifurcation):
    """Events on with bisection; detect_bifurcation > 1 stays on, since
    crossings of the INNER spectrum along the curve are codim-2 points
    themselves (ref conversion, src/codim2/codim2.jl:566-568)."""
    if cp.detect_event != 0:
        return cp
    return cp.replace(detect_event=min(detect_codim2_bifurcation, 2),
                      detect_bifurcation=cp.detect_bifurcation
                      if cp.detect_bifurcation > 1 else 0)


def _start_problem(maprob, X0, a, b):
    params = dict(maprob.params)
    params["_a"], params["_b"] = a, b
    return maprob.re_make(u0=X0, params=params)


def _scalar(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).reshape(1)


def continuation_fold(br, ind_bif: int, lens2,
                      contparams: ContinuationPar,
                      alg=None, detect_codim2_bifurcation: int = 2,
                      update_minaug_every_step: int = 1,
                      jacobian_ma: str = "dense",
                      **kwargs) -> Branch:
    """Fold curve in (p1, lens2) from the fold (or bp) point `ind_bif` of
    `br`.  `jacobian_ma="minaug"` (or "mf", "iterative") takes the
    matrix-free route (`minaug_mf.continuation_fold_mf`)."""
    if jacobian_ma in ("minaug", "mf", "iterative"):
        from .minaug_mf import continuation_fold_mf

        return continuation_fold_mf(
            br, ind_bif, lens2, contparams, alg=alg,
            detect_codim2_bifurcation=detect_codim2_bifurcation,
            update_minaug_every_step=update_minaug_every_step, **kwargs)
    prob = br.prob
    x_flat, p1, zeta, zeta_ad = _fold_start(br, ind_bif)
    maprob = _start_problem(
        fold_ma_problem(prob, prob.lens, lens2, zeta_ad, zeta),
        torch.cat([x_flat, _scalar(p1, x_flat)]), zeta_ad, zeta)
    event = (_fold_codim2_event(maprob)
             if detect_codim2_bifurcation > 0 else None)
    cp = contparams if event is None else _codim2_contparams(
        contparams, detect_codim2_bifurcation)
    gamma = continuation(maprob, alg or PALC(), cp, kind="FoldCont",
                         event=event, **kwargs)
    _relabel_codim2(gamma, maprob)
    return Branch(gamma=gamma, bp=br.specialpoint[ind_bif])


def continuation_hopf(br, ind_bif: int, lens2,
                      contparams: ContinuationPar,
                      alg=None, detect_codim2_bifurcation: int = 2,
                      update_minaug_every_step: int = 1,
                      compute_lyapunov: bool = True,
                      jacobian_ma: str = "dense",
                      **kwargs) -> Branch:
    """Hopf curve in (p1, lens2) from the Hopf point `ind_bif` of `br`,
    with BT and GH monitoring; `jacobian_ma="minaug"` takes the
    matrix-free route (`minaug_mf.continuation_hopf_mf`)."""
    if jacobian_ma in ("minaug", "mf", "iterative"):
        from .minaug_mf import continuation_hopf_mf

        return continuation_hopf_mf(
            br, ind_bif, lens2, contparams, alg=alg,
            detect_codim2_bifurcation=detect_codim2_bifurcation,
            update_minaug_every_step=update_minaug_every_step,
            compute_lyapunov=compute_lyapunov, **kwargs)
    prob = br.prob
    x_flat, p1, omega, zeta, zeta_ad = _hopf_start(br, ind_bif)
    # the left null vector of (J - i omega I) is zeta_ad itself: a = zeta_ad
    maprob = _start_problem(
        hopf_ma_problem(prob, prob.lens, lens2, zeta_ad, zeta),
        torch.cat([x_flat, _scalar(p1, x_flat), _scalar(omega, x_flat)]),
        zeta_ad, zeta)
    event = (_hopf_codim2_event(maprob, with_gh=compute_lyapunov)
             if detect_codim2_bifurcation > 0 else None)
    cp = contparams if event is None else _codim2_contparams(
        contparams, detect_codim2_bifurcation)
    gamma = continuation(maprob, alg or PALC(), cp, kind="HopfCont",
                         event=event, **kwargs)
    _relabel_codim2(gamma, maprob)
    return Branch(gamma=gamma, bp=br.specialpoint[ind_bif])


def _real_zero(vals) -> bool:
    vals = np.asarray(vals)
    return bool(np.any((np.abs(vals.imag) < 1e-6)
                       & (np.abs(vals.real) < 1e-2)))


def _relabel_codim2(gamma: ContResult, maprob=None):
    """Map event labels to canonical codim-2 point types.

    A 'gh' label on a Hopf curve is demoted to 'zh' when the inner
    jacobian carries a real eigenvalue at zero: the first-Lyapunov test
    function has a POLE there (h11 = -J^{-1}B blows up), so its sign
    change marks a zero-Hopf point, not a Bautin point."""
    kind = getattr(maprob, "ma_kind", None) if maprob is not None else None
    # inner-spectrum crossings along the curve (ref conversion dicts,
    # src/codim2/codim2.jl:566-568)
    conv = {"fold": {"bp": "bt", "hopf": "zh", "fold": "cusp"},
            "hopf": {"bp": "zh", "hopf": "hh", "fold": "nd"}}.get(kind, {})
    for sp in gamma.specialpoint:
        if sp.type == "gh" and maprob is not None:
            vals = _gh_inner_spectrum(gamma, maprob, sp)
            if vals is None:
                warnings.warn(
                    "gh label on a matrix-free Hopf curve could not be "
                    "verified against the inner spectrum (no saved "
                    "eigenvalues and the iterative recompute failed); a "
                    "zero-Hopf point would carry the same sign change",
                    RuntimeWarning)
            elif _real_zero(vals):
                sp.type = "zh"
        elif sp.type in ("userC", "userD"):
            sp.type = "codim2"
        elif sp.type not in ("bt", "cusp", "zh", "gh") and sp.type in conv:
            sp.type = conv[sp.type]


def _gh_inner_spectrum(gamma, maprob, sp):
    """The inner spectrum at a 'gh' point: dense on a dense curve; on a
    matrix-free one the saved iterative spectrum, else a few rightmost
    eigenvalues recomputed by Arnoldi on `eig_jacobian` (None when that
    fails)."""
    X = torch.as_tensor(sp.x)
    if not getattr(maprob, "ma_mf", False):
        n = maprob.n_inner
        par = maprob.inner_lens.set(
            maprob.outer_lens.set(gamma.prob.params["_inner"], sp.param),
            X[n])
        J = maprob.inner_prob.jacobian(maprob.unravel_inner(X[:n]), par)
        return np.linalg.eigvals(_host(J))
    if sp.eigenvals is not None:
        return np.asarray(sp.eigenvals)
    try:
        from ..linalg.eig import ArnoldiEig

        par = maprob.set_lens_param(dict(gamma.prob.params), float(sp.param))
        w, _, cv, _ = ArnoldiEig(krylov_dim=40, restarts=3, which="LR")(
            maprob.eig_jacobian(X, par), 8)
        return _host(w) if bool(cv) else None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Newton refinement of fold / Hopf / GH points
# ---------------------------------------------------------------------------


def newton_fold(br, ind_bif: int, options: Optional[NewtonPar] = None,
                **kwargs):
    """Refine a fold point at fixed p2 by Newton on the MA functional
    (ref newton_fold, src/codim2/MinAugFold.jl:211)."""
    prob = br.prob
    x_flat, p1, zeta, zeta_ad = _fold_start(br, ind_bif)
    maprob = _start_problem(
        fold_ma_problem(prob, prob.lens, prob.lens, zeta_ad, zeta),
        torch.cat([x_flat, _scalar(p1, x_flat)]), zeta_ad, zeta)
    return newton(maprob, options or br.contparams.newton_options, **kwargs)


def newton_hopf(br, ind_bif: int, options: Optional[NewtonPar] = None,
                **kwargs):
    """ref newton_hopf, src/codim2/MinAugHopf.jl:256."""
    prob = br.prob
    x_flat, p1, omega, zeta, zeta_ad = _hopf_start(br, ind_bif)
    maprob = _start_problem(
        hopf_ma_problem(prob, prob.lens, prob.lens, zeta_ad, zeta),
        torch.cat([x_flat, _scalar(p1, x_flat), _scalar(omega, x_flat)]),
        zeta_ad, zeta)
    return newton(maprob, options or br.contparams.newton_options, **kwargs)


def refine_gh(br_hopf, ind_sp: int, tol_l1: float = 1e-8,
              max_steps: int = 60, verbose: bool = False):
    """Refine a GH guess on a Hopf MA curve: bisect the first Lyapunov
    coefficient in the curve's continuation parameter p2, re-solving the
    MA Newton at each trial p2.  The l1 kernel sees the TRIAL p2.
    Returns (X, p2) at the refined point."""
    from ..continuation.engine import ContIterable

    gamma = br_hopf.gamma if hasattr(br_hopf, "gamma") else br_hopf
    maprob = gamma.prob
    sp = gamma.specialpoint[ind_sp]
    if sp.type not in ("gh", "zh"):
        raise ValueError(f"point {ind_sp} has type {sp.type!r}")
    if getattr(maprob, "ma_mf", False):
        from .minaug_mf import make_l1_kernel_mf

        l1_raw = make_l1_kernel_mf(maprob)

        def l1_of(X, p2):
            return float(l1_raw(X, maprob.set_lens_param(maprob.params,
                                                         float(p2))))
    else:
        l1_raw = _make_l1_kernel(maprob)

        def l1_of(X, p2):
            par = maprob.set_lens_param(maprob.params, float(p2))
            return float(l1_raw(X, par["_inner"]))

    it = ContIterable(maprob, PALC(), gamma.contparams)
    it.current_params = gamma.prob.params
    X0 = torch.as_tensor(sp.x)

    def solve_at(p2, Xg):
        u, cv, _, _, _ = it.kernels.newton_fixed(Xg, it.kernels.as_p(p2),
                                                 maprob.params)
        return u, bool(cv)

    pa, pb = sp.interval
    if pa == pb:
        pa, pb = sp.param - 5e-3, sp.param + 5e-3
    Xa, cva = solve_at(pa, X0)
    Xb, cvb = solve_at(pb, X0)
    if not (cva and cvb):
        return X0, sp.param
    la, lb = l1_of(Xa, pa), l1_of(Xb, pb)
    if la * lb > 0:
        # widen once
        pa, pb = pa - (pb - pa), pb + (pb - pa)
        Xa, cva = solve_at(pa, X0)
        Xb, cvb = solve_at(pb, X0)
        la, lb = l1_of(Xa, pa), l1_of(Xb, pb)
        if la * lb > 0:
            return X0, sp.param
    X = X0
    for _ in range(max_steps):
        pm = 0.5 * (pa + pb)
        X, cv = solve_at(pm, X)
        if not cv:
            break
        lm = l1_of(X, pm)
        if verbose:
            print(f"  [refine_gh] p2={pm:.10f} l1={lm:+.3e}")
        if abs(lm) < tol_l1 or (pb - pa) < 1e-12:
            return X, pm
        if la * lm <= 0:
            pb, lb = pm, lm
        else:
            pa, la = pm, lm
    return X, 0.5 * (pa + pb)


# ---------------------------------------------------------------------------
# codim-2 -> codim-2 switching (ref the `continuation(br_codim2, ind, opts)`
# dispatch, src/codim2/codim2.jl:400-560)
# ---------------------------------------------------------------------------


def _switch_target(sp, kind, to):
    if to is None:
        to = {"zh": "hopf" if kind == "fold" else "fold",
              "hh": "hopf",
              "bt": "fold" if kind == "hopf" else "hopf"}.get(sp.type)
    if to is None:
        raise ValueError(f"no switch target for a {sp.type!r} point on a "
                         f"{kind} curve")
    return to


def _point_shim(prob, kind, param, x, **eig):
    """A one-point branch (`prob`, `specialpoint`) that the codim-2
    starters take: the point of type `kind` at `param`, with its eigen
    data where given."""
    from types import SimpleNamespace

    from ..detection.points import SpecialPoint

    return SimpleNamespace(prob=prob, specialpoint=[
        SpecialPoint(type=kind, param=param, x=x, **eig)])


def _collapsed(out):
    """A Hopf curve that fell onto the omega = 0 family (the fold curve the
    switch came from)."""
    om = np.asarray(out.gamma._table()["omega"], dtype=float)
    return float(np.max(np.abs(om))) < 1e-6


def switch_codim2(br_c2, ind: int, contparams: ContinuationPar,
                  to: Optional[str] = None, **kwargs) -> Branch:
    """Start the OTHER codim-2 curve from a codim-2 point detected along a
    minimally augmented curve (ref the `continuation(br_codim2, ind,
    opts)` dispatch, src/codim2/codim2.jl:400-560; the lorenz84 flows
    `hp_from_zh` / `hp_from_hh`, test/hopf_codim_2/lorenz84.jl:350-371):

      zh on a fold curve  -> the Hopf curve through the same point
      zh/bt on a Hopf curve -> the fold curve through the point
      hh on a Hopf curve  -> the OTHER Hopf curve (second frequency)
      bt on a fold curve  -> the Hopf curve, by a two-sided probe

    Both curves pass through the point, so the new MA problem starts
    there with the eigen data of the target pair.  A matrix-free curve
    hands over to `minaug_mf.switch_codim2_mf`."""
    gamma = br_c2.gamma if isinstance(br_c2, Branch) else br_c2
    sp = gamma.specialpoint[ind]
    maprob = gamma.prob
    if getattr(maprob, "ma_mf", False):
        from .minaug_mf import switch_codim2_mf

        return switch_codim2_mf(br_c2, ind, contparams, to=to, **kwargs)
    inner = maprob.inner_prob
    n = maprob.n_inner
    X = torch.as_tensor(sp.x)
    p1, p2 = float(X[n]), float(sp.param)
    omega_cur = float(X[n + 1]) if maprob.ma_kind == "hopf" else None
    to = _switch_target(sp, maprob.ma_kind, to)

    # the inner problem anchored at the point (p2 frozen into params)
    par_full = maprob.lens.set(dict(maprob.params), p2)
    par_inner = maprob.inner_lens.set(par_full["_inner"], p1)
    x_in = maprob.unravel_inner(X[:n])
    prob2 = inner.re_make(u0=x_in, params=par_inner)
    lens2 = maprob.outer_lens

    if to == "fold":
        return continuation_fold(_point_shim(prob2, "fold", p1, x_in), 0,
                                 lens2, contparams, **kwargs)
    if sp.type == "bt":
        return _bt_to_hopf_probe(maprob, x_in, p1, p2, contparams, lens2,
                                 **kwargs)

    # Hopf target: at an HH the pair FARTHEST in frequency from the
    # current curve's omega, else the complex pair nearest the axis
    J = prob2.jacobian(x_in, par_inner)
    vals, vecs = dense_eig(J)
    vals_np = _host(vals)
    cand = np.where(vals_np.imag > 1e-10)[0]
    if len(cand) == 0:
        raise RuntimeError("no complex pair at the switch point")
    if sp.type == "hh" and omega_cur is not None:
        i0 = cand[np.argmax(np.abs(vals_np[cand].imag - abs(omega_cur)))]
    else:
        i0 = cand[np.argmin(np.abs(vals_np.real[cand]))]
    lam = vals_np[i0]
    zeta = vecs[:, int(i0)].to(COMPLEX_DTYPE)
    zeta = zeta / torch.linalg.vector_norm(zeta)
    valsT, vecsT = dense_eig(J.T)
    zeta_ad = vecsT[:, int(np.argmin(np.abs(_host(valsT) - np.conj(lam))))]
    zeta_ad = (zeta_ad / torch.linalg.vector_norm(zeta_ad)).to(COMPLEX_DTYPE)
    # the chosen pair is passed to the MA problem directly: at an HH the
    # starter's own eigen pick would be ambiguous
    x_flat = ravel(x_in)[0]
    maprob2 = _start_problem(
        hopf_ma_problem(prob2, prob2.lens, lens2, zeta_ad, zeta),
        torch.cat([x_flat, _scalar(p1, x_flat),
                   _scalar(float(lam.imag), x_flat)]), zeta_ad, zeta)
    dc2 = kwargs.pop("detect_codim2_bifurcation", 2)
    event = _hopf_codim2_event(maprob2, with_gh=True) if dc2 > 0 else None
    cp = contparams
    if event is not None and cp.detect_event == 0:
        cp = cp.replace(detect_event=1,
                        detect_bifurcation=min(cp.detect_bifurcation, 1))
    alg = kwargs.pop("alg", None) or PALC()
    gamma2 = continuation(maprob2, alg, cp, kind="HopfCont", event=event,
                          **kwargs)
    _relabel_codim2(gamma2, maprob2)
    return Branch(gamma=gamma2, bp=sp)


_BT_PROBE_FRACS = (1e-2, 5e-2, 2e-1)
_BT_PROBE_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1),
                  (1, 1), (-1, -1), (1, -1), (-1, 1))


def _bt_probes(maprob, p1, p2):
    """The probe points around a BT: (p1, p2, inner params) at growing
    distance, in the eight directions of the (p1, p2) plane."""
    scale = max(abs(p2), abs(p1), 1e-2)
    for frac in _BT_PROBE_FRACS:
        for d1, d2 in _BT_PROBE_DIRS:
            p1_t, p2_t = p1 + d1 * frac * scale, p2 + d2 * frac * scale
            par = maprob.lens.set(dict(maprob.params), p2_t)
            yield p1_t, p2_t, maprob.inner_lens.set(par["_inner"], p1_t)


def _probe_newton(inner, x_in, par, contparams):
    """The equilibrium at a probe's parameters from the BT state, or None
    where Newton does not converge (a probe may start on a singular
    jacobian: the BT state is a double-zero point for a whole line of
    parameters)."""
    try:
        sol = newton(inner.re_make(u0=x_in, params=par),
                     contparams.newton_options)
    except RuntimeError as err:
        # a singular dense factorisation only (torch raises it as a plain
        # RuntimeError from lu_factor); anything else propagates
        if not (isinstance(err, torch.linalg.LinAlgError)
                or "lu_factor" in str(err)):
            raise
        return None
    return sol if bool(sol.converged) else None


def _bt_to_hopf_probe(maprob, x_in, p1, p2, contparams, lens2, **kwargs):
    """bt -> hopf on a dense fold curve: the Hopf curve leaves the BT
    tangentially to the fold curve and the eigenvalue pair complexifies
    on ONE side only, so probe (p1, p2) around the point, reconverge the
    equilibrium and hand a complexified pair near the axis to the Hopf
    MA (its own Newton refines (x, p1, omega))."""
    inner = maprob.inner_prob
    last_err = None
    for p1_t, _, par_t in _bt_probes(maprob, p1, p2):
        sol = _probe_newton(inner, x_in, par_t, contparams)
        if sol is None:
            continue
        vp = _host(dense_eig(inner.jacobian(sol.u, par_t),
                             with_vectors=False)[0])
        pair = vp[np.abs(vp.imag) > 1e-8]
        if len(pair) == 0:
            continue
        lam = pair[np.argmin(np.abs(pair.real))]
        if abs(lam.real) > 0.5 * abs(lam.imag):
            continue                 # not near a Hopf yet
        shim = _point_shim(inner.re_make(u0=sol.u, params=par_t), "hopf",
                           p1_t, sol.u)
        try:
            out = continuation_hopf(shim, 0, lens2, contparams, **kwargs)
        except RuntimeError as err:
            last_err = err
            continue
        if _collapsed(out):
            last_err = RuntimeError("collapsed onto omega = 0")
            continue
        return out
    raise RuntimeError(f"bt -> hopf probing failed around (p1, p2) = "
                       f"({p1}, {p2})"
                       + (f" (last: {last_err})" if last_err else ""))
