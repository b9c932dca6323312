"""PO codim-2 minimally augmented problems (`periodic/codim2.py`) at the
Lur'e PD (Collocation(25, 4), 304 + 1 unknowns), continued in beta: the
functional formulation (sigma on the Floquet-closed collocation
operator), its structured jacobian `POMAJac` and its closed-form sigma
gradient, against the JAX package's functional (jitted) at the port's
start point and borders; the monodromy formulation's G and jacobian; the
fold kind's gradient (the generic fold MA, here at the same orbit with
random borders); the port's PD curve against the JAX package's defining
equations; the codim-3 test values; the secondary Floquet labels.

The JAX package compiles each MA flow for seconds, so its side is single
applications at the port's points (through `interop.po_ma_point_*`).
Tolerances: G to 1e-10; the POMAJac's p1 column and blocks' matvec to
1e-10; the sigma gradient rows against `jax.jacrev` and against the
port's own `torch.func` reference (`po_sigma_autodiff`) to 1e-8 relative
to their largest entry; the curve's points satisfy the JAX package's
collocation rows and the -1 multiplier of its monodromy to 1e-7; the
(cusp, R2) test values to 1e-10; secondary labels among
{foldFlip, pdNS, R2, nd, endpoint} (test_po_codim2.py:189-206)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.periodic import codim2 as jc2
from bifurcationkit.jl_tpu.periodic.orbits import (
    periodic_orbit_problem as j_po_problem)
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.periodic import codim2 as pc2
from tests._codim2_models import one_thread  # noqa: F401
from tests._po_models import lure_po_branch

CP2 = dict(ds=0.02, dsmax=0.05, dsmin=1e-6, p_min=0.8, p_max=1.4,
           detect_fold=False)


@pytest.fixture(scope="module")
def lure():
    _, _, br_po, ipd = lure_po_branch()
    cp2 = bt.ContinuationPar(max_steps=3, detect_bifurcation=0,
                             save_sol_every_step=1,
                             newton_options=bt.NewtonPar(
                                 tol=1e-9, max_iterations=15), **CP2)
    brc = bt.continuation_pd(br_po, ipd, "beta", cp2, detect_codim3=0)
    po = br_po.gamma.prob
    jpo = j_po_problem(jm.lure(alpha=1.2, beta=1.0),
                       bj.Collocation(Ntst=po.disc.Ntst, m=po.disc.m),
                       jnp.asarray(po.u0.numpy()), use_cop=True)
    return br_po, ipd, brc, jpo


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_functional_G_jac_and_gradient_match_jax(lure):
    br_po, ipd, brc, jpo = lure
    maprob = brc.gamma.prob
    Y, par = maprob.u0, maprob.params
    Yj, parj = interop.po_ma_point_to_numpy(Y, par)
    jmp, _ = jc2._po_ma_problem_functional(jpo, "beta", "pd")
    Gj = np.asarray(jax.jit(jmp.F)(jnp.asarray(Yj), parj))
    np.testing.assert_allclose(maprob.F(Y, par).numpy(), Gj, rtol=0,
                               atol=1e-10)
    # the converter's round trip gives the same point and borders
    Y2, par2 = interop.po_ma_point_from_numpy(Yj, parj, "cpu")
    np.testing.assert_array_equal(maprob.F(Y2, par2).numpy(),
                                  maprob.F(Y, par).numpy())
    Jj = jax.jit(jmp.jac)(jnp.asarray(Yj), parj)
    J = maprob.jac(Y, par)
    np.testing.assert_allclose(J.dRdp1.numpy(), np.asarray(Jj.dRdp1),
                               rtol=0, atol=1e-10)
    assert _rel(J.sig_X.numpy(), Jj.sig_X) <= 1e-8
    assert _rel(J.sig_p1.numpy(), Jj.sig_p1) <= 1e-8
    dY = torch.tensor(np.random.default_rng(3).standard_normal(Y.shape[0]))
    np.testing.assert_allclose(J(dY).numpy(), np.asarray(Jj(jnp.asarray(
        dY.numpy()))), rtol=0, atol=1e-10 * float(J(dY).abs().max()))
    ref = pc2.po_sigma_autodiff(maprob, Y, par)
    assert _rel(J.sig_X.numpy(), ref[0].numpy()) <= 1e-8
    assert _rel(J.sig_p1.numpy(), ref[1].numpy()) <= 1e-8


def test_fold_kind_gradient(lure):
    """The fold MA's closed-form gradient (its adjoint by the transposed
    COP solve) against jax.jacrev and the torch.func reference at the same
    orbit with random borders."""
    br_po, ipd, brc, jpo = lure
    po = br_po.gamma.prob
    sp = br_po.gamma.specialpoint[ipd]
    maprob, _ = pc2._po_ma_problem_functional(po, "beta", "fold")
    rng = np.random.default_rng(4)
    nX = po.u0.shape[0]
    par = dict(po.set_lens_param(po.params, sp.param))
    par["_a"] = torch.tensor(rng.standard_normal(nX))
    par["_b"] = torch.tensor(rng.standard_normal(nX))
    Y = torch.cat([torch.as_tensor(sp.x), torch.tensor([sp.param])])
    J = maprob.jac(Y, par)
    ref = pc2.po_sigma_autodiff(maprob, Y, par)
    assert _rel(J.sig_X.numpy(), ref[0].numpy()) <= 1e-8
    assert _rel(J.sig_p1.numpy(), ref[1].numpy()) <= 1e-8
    jmp, _ = jc2._po_ma_problem_functional(jpo, "beta", "fold")
    Yj, parj = interop.po_ma_point_to_numpy(Y, par)
    Jj = jax.jit(jmp.jac)(jnp.asarray(Yj), parj)
    assert _rel(J.sig_X.numpy(), Jj.sig_X) <= 1e-8
    assert _rel(J.sig_p1.numpy(), Jj.sig_p1) <= 1e-8


def test_monodromy_formulation_matches_jax(lure):
    br_po, ipd, brc, jpo = lure
    po = br_po.gamma.prob
    start = pc2._start_data(br_po, ipd, "pd")
    X, p1, _, zeta, zeta_ad, par = start
    maprob, _ = pc2._po_ma_problem(po, "beta", "pd")
    par = dict(par)
    par["_a"] = torch.real(zeta_ad).to(X.dtype)
    par["_b"] = torch.real(zeta).to(X.dtype)
    Y = torch.cat([X, torch.tensor([p1])])
    Yj, parj = interop.po_ma_point_to_numpy(Y, par)
    jmp, _ = jc2._po_ma_problem(jpo, "beta", "pd")
    Gj = np.asarray(jax.jit(jmp.F)(jnp.asarray(Yj), parj))
    np.testing.assert_allclose(maprob.F(Y, par).numpy(), Gj, rtol=0,
                               atol=1e-10)
    Jj = np.asarray(jax.jit(jax.jacfwd(jmp.F))(jnp.asarray(Yj), parj))
    J = maprob.jacobian(Y, par).numpy()
    assert _rel(J[-1], Jj[-1]) <= 1e-8          # the sigma row
    np.testing.assert_allclose(J[:-1], Jj[:-1], rtol=0, atol=1e-10)


def test_pd_curve_satisfies_jax_equations(lure):
    br_po, ipd, brc, jpo = lure
    po = br_po.gamma.prob
    assert len(brc) >= 3
    nX = po.u0.shape[0]
    pj = jm.lure(alpha=1.2, beta=1.0)
    disc = bj.Collocation(Ntst=po.disc.Ntst, m=po.disc.m)
    n = po.n_vf
    resid = jax.jit(lambda X, par: disc.residual(pj, X, par))
    mono = jax.jit(lambda X, par: disc.monodromy(pj, X, par))
    for sol in brc.gamma.sol[:3]:
        Y = sol["x"].numpy()
        par = {"_inner": {"alpha": float(Y[nX]), "beta": float(sol["p"])},
               "_mesh": jnp.linspace(0.0, 1.0, disc.Ntst + 1),
               "_uref": jnp.asarray(Y[:nX - 1].reshape(-1, n)),
               "_phi": jnp.zeros((disc.Ntst, disc.m, n))}
        R = np.asarray(resid(jnp.asarray(Y[:nX]), par))
        assert np.abs(R[:-1]).max() <= 1e-7
        mult = np.linalg.eigvals(np.asarray(mono(jnp.asarray(Y[:nX]),
                                                 par)))
        assert np.min(np.abs(mult + 1.0)) <= 1e-7


def test_codim3_values_and_labels(lure):
    """(cusp, R2) of the PD curve's codim-3 monitor against the JAX
    package's at the curve's last point; gpd (the Iooss b3 on
    collocation) against the port's own core there; and the secondary
    Floquet labels of a short curve with detection on."""
    from types import SimpleNamespace

    from bifurcationkit.jl_tpu_torch.periodic.normal_forms import (
        _pd_iooss_core)

    br_po, ipd, brc, jpo = lure
    po = br_po.gamma.prob
    maprob = brc.gamma.prob
    state = SimpleNamespace(z=SimpleNamespace(u=brc.gamma.sol[-1]["x"]),
                            p=float(brc.gamma.sol[-1]["p"]),
                            tau=SimpleNamespace(p=torch.tensor(
                                0.3, dtype=torch.float64)))
    it = SimpleNamespace(prob=maprob, current_params=maprob.params)
    ev = pc2._po_codim3_event(po, lambda Y: (Y[:-1], Y[-1], None), "pd",
                              flow_steps=60, compute_nf=True)
    gpd, cusp, r2 = ev.condition(it, state)
    Yj, parj = interop.po_ma_point_to_numpy(state.z.u, maprob.params)
    jmp, jsplit = jc2._po_ma_problem_functional(jpo, "beta", "pd")
    jmp = jmp.re_make(u0=jnp.asarray(Yj), params=parj)
    jev = jc2._po_codim3_event(jpo, jsplit, "pd", flow_steps=60,
                               compute_nf=False)
    jst = SimpleNamespace(z=SimpleNamespace(u=jnp.asarray(Yj)),
                          p=state.p, tau=SimpleNamespace(p=0.3))
    _, jcusp, jr2 = jev.condition(SimpleNamespace(prob=jmp,
                                                  current_params=parj), jst)
    assert abs(cusp - jcusp) <= 1e-10 and abs(r2 - jr2) <= 1e-10
    X = state.z.u[:-1]
    par = maprob.set_lens_param(maprob.params, state.p)
    par = dict(par, _inner=bt.as_lens("alpha").set(par["_inner"],
                                                    float(state.z.u[-1])))
    b3 = _pd_iooss_core(po.disc, po.prob_vf, po.n_vf, X, par["_inner"],
                        par["_mesh"])["b3"]
    assert gpd == pytest.approx(b3, rel=1e-12)

    cp2 = bt.ContinuationPar(max_steps=4, detect_bifurcation=2, nev=3,
                             tol_stability=1e-3,
                             newton_options=bt.NewtonPar(
                                 tol=1e-7, max_iterations=15), **CP2)
    br_pd = bt.continuation_pd(br_po, ipd, "beta", cp2, detect_codim3=0)
    assert len(br_pd) >= 4
    for sp in br_pd.gamma.specialpoint:
        assert sp.type in {"foldFlip", "pdNS", "R2", "nd", "endpoint"}
    assert pc2._SECONDARY_LABELS == jc2._SECONDARY_LABELS
