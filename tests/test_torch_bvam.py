"""The BVAM period-doubling PDE (`models.bvam_1d`, examples/pd_1d.py) in
the port: its F, J.v (the 1D Neumann Laplacian as one `DIAMatrix`, both
fields in one product, D applied afterwards), dense jacobian, d2F and d3F
against the JAX package's F and its jets; then the slice's flow at a cut
size (N = 10, 20 unknowns; the card runs N = 100): Newton, the
equilibrium branch to its Hopf, the collocation PO branch (Collocation(30,
4) with COP and FloquetColl: 2,421 unknowns) to its first PD, and a
2-step functional PD curve in D, each held to the JAX package's
equations by single applications at the port's points.

Tolerances: the model's F, J.v, jacobian, d2F and d3F to 1e-12 relative
to their largest entry; at the port's Hopf the JAX F to 1e-9 and the JAX
jacobian's critical pair on the imaginary axis to 1e-5 (the bisection's
resolution in C); the JAX collocation rows at the
port's PD orbit to 1e-8 and its monodromy's -1 multiplier to 1e-2
(test_pd1d.py:53-69); along the PD curve the JAX package's functional G
(sigma with the port's borders) to 1e-7 and the -1 multiplier to 1e-6;
the fold-of-PO gradient (its adjoint by the transposed COP solve) at the
PD orbit with random borders against the port's `torch.func` reference
through the plain jacobian to 1e-8 relative.
At N = 10 the Hopf is at C = -1.048 and the PDs at -1.204 and -1.420
(at N = 50, the JAX test's size, -0.867 and -1.327)."""
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
from bifurcationkit.jl_tpu_torch.ops.dia_spmv import dia_spmv_plain
from tests._codim2_models import one_thread  # noqa: F401

N = 10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_model_matches_jax():
    rng = np.random.default_rng(7)
    pj = jm.bvam_1d(N=N)
    pt = bt.models.bvam_1d(N=N, device="cpu")
    par = {k: float(v) for k, v in pt.params.items()}
    u, a, b, c = (rng.standard_normal((2, N)) for _ in range(4))
    f = lambda x: pj.F(x, par)
    ju, ja, jb, jc = (jnp.asarray(z) for z in (u, a, b, c))
    T = lambda z: torch.tensor(z)
    assert _rel(pt.F(T(u), pt.params).numpy(), f(ju)) <= 1e-12
    jv = jax.jvp(f, (ju,), (ja,))[1]
    J = pt.jac_op(T(u), pt.params)
    assert _rel(J(T(a)).numpy(), jv) <= 1e-12
    both = J(torch.stack([T(b), T(a)]))           # a batch: one product
    assert _rel(both[1].numpy(), jv) <= 1e-12
    Jd = jax.jacfwd(lambda x: f(x.reshape(2, N)).ravel())(ju.ravel())
    assert _rel(pt.jacobian(T(u), pt.params).numpy(), Jd) <= 1e-12
    d2 = jax.jvp(lambda x: jax.jvp(f, (x,), (ja,))[1], (ju,), (jb,))[1]
    assert _rel(pt.d2F(T(u), pt.params, T(a), T(b)).numpy(), d2) <= 1e-12
    d3 = jax.jvp(lambda y: jax.jvp(lambda x: jax.jvp(f, (x,), (ja,))[1],
                                   (y,), (jb,))[1], (ju,), (jc,))[1]
    assert _rel(pt.d3F(T(u), pt.params, T(a), T(b), T(c)).numpy(),
                d3) <= 1e-12
    # the plain DIA product gives the same J.v
    pp = bt.models.bvam_1d(N=N, device="cpu", spmv=dia_spmv_plain)
    assert _rel(pp.jac_op(T(u), pp.params)(T(a)).numpy(), jv) <= 1e-12


@pytest.fixture(scope="module")
def flow():
    prob = bt.models.bvam_1d(N=N, device="cpu")
    sol = bt.newton(prob, bt.NewtonPar(tol=1e-9, max_iterations=100))
    assert bool(sol.converged)
    cp = bt.ContinuationPar(ds=-0.001, dsmax=0.051, dsmin=1e-5, p_min=-1.8,
                            p_max=0.0, max_steps=40, detect_bifurcation=3,
                            nev=20, n_inversion=10,
                            newton_options=bt.NewtonPar(tol=1e-9,
                                                        max_iterations=25))
    br = bt.continuation(prob.re_make(u0=sol.u), bt.PALC(), cp)
    ih = next(i for i, sp in enumerate(br.specialpoint) if sp.type == "hopf")
    # the PO branch cut just past its first PD
    cpo = bt.ContinuationPar(ds=0.01, dsmax=0.015, dsmin=1e-4, p_min=-1.25,
                             p_max=0.0, max_steps=40, detect_bifurcation=3,
                             n_inversion=6, tol_stability=1e-4,
                             newton_options=bt.NewtonPar(
                                 tol=1e-8, max_iterations=20,
                                 eigsolver=bt.FloquetColl()))
    brpo = bt.continuation_hopf_po(br, ih, cpo, bt.Collocation(Ntst=30, m=4),
                                   use_cop=True)
    ipd = next(i for i, sp in enumerate(brpo.gamma.specialpoint)
               if sp.type == "pd")
    cp2 = bt.ContinuationPar(
        ds=2e-3, dsmax=5e-3, dsmin=1e-7, p_min=0.05, p_max=0.12,
        max_steps=2, detect_bifurcation=0, detect_event=0,
        save_sol_every_step=1,
        newton_options=bt.NewtonPar(tol=1e-7, max_iterations=30))
    brc = bt.continuation_pd(brpo, ipd, "D", cp2, detect_codim3=0)
    return br, ih, brpo, ipd, brc


def test_hopf_and_pd_satisfy_jax_equations(flow):
    br, ih, brpo, ipd, _ = flow
    pj = jm.bvam_1d(N=N)
    sp = br.specialpoint[ih]
    assert sp.param == pytest.approx(-1.048, abs=5e-3)
    par = {k: float(v) for k, v in br.prob.params.items()}
    par["C"] = float(sp.param)
    J = jax.jacfwd(lambda x: pj.F(x.reshape(2, N), par).ravel())(
        jnp.asarray(sp.x.numpy().ravel()))
    vals = np.linalg.eigvals(np.asarray(J))
    i = np.argmin(np.abs(vals.real))
    assert abs(vals[i].real) < 1e-5 and abs(vals[i].imag) > 0.1
    Fj = pj.F(jnp.asarray(sp.x.numpy()), par)
    assert float(jnp.abs(Fj).max()) <= 1e-9

    po = brpo.gamma.prob
    psp = brpo.gamma.specialpoint[ipd]
    assert psp.param == pytest.approx(-1.204, abs=2e-2)
    pjf = j_po_problem(pj, bj.Collocation(Ntst=30, m=4),
                       jnp.asarray(po.u0.numpy())).prob_vf
    disc = bj.Collocation(Ntst=30, m=4)
    jpar = {"_inner": {**par, "C": float(psp.param)},
            "_mesh": jnp.linspace(0.0, 1.0, 31),
            "_uref": jnp.asarray(psp.x.numpy()[:-1].reshape(-1, 2 * N)),
            "_phi": jnp.zeros((30, 4, 2 * N))}
    X = jnp.asarray(psp.x.numpy())
    R = np.asarray(jax.jit(lambda X_, p_: disc.residual(pjf, X_, p_))(
        X, jpar))
    assert np.abs(R[:-1]).max() <= 1e-8
    M = np.asarray(jax.jit(lambda X_, p_: disc.monodromy(pjf, X_, p_))(
        X, jpar))
    assert np.min(np.abs(np.linalg.eigvals(M) + 1.0)) < 1e-2


def test_pd_curve_satisfies_jax_functional(flow):
    _, _, brpo, ipd, brc = flow
    po = brpo.gamma.prob
    maprob = brc.gamma.prob
    tab = brc.gamma._table()
    assert len(tab["param"]) >= 3 and np.ptp(tab["param"]) > 5e-4
    jpo = j_po_problem(jm.bvam_1d(N=N), bj.Collocation(Ntst=30, m=4),
                       jnp.asarray(po.u0.numpy()), use_cop=True)
    jmp, _ = jc2._po_ma_problem_functional(jpo, "D", "pd")
    G = jax.jit(jmp.F)
    for sol in brc.gamma.sol:
        par = maprob.set_lens_param(maprob.params, float(sol["p"]))
        Yj, parj = interop.po_ma_point_to_numpy(sol["x"], par)
        # the phase row is the curve's own (its reference orbit moves
        # with the update hook): the collocation rows and sigma are held
        g = np.asarray(G(jnp.asarray(Yj), parj))
        nX = po.u0.shape[0]
        assert np.abs(g[:nX - 1]).max() <= 1e-7
        assert abs(g[-1]) <= 1e-7
    vals = bt.po_codim2_test_values(brc, -1)
    assert vals["R2"] < 1e-6


def test_fold_po_gradient_at_bvam_orbit(flow):
    _, _, brpo, ipd, _ = flow
    po = brpo.gamma.prob
    sp = brpo.gamma.specialpoint[ipd]
    maprob, _ = bt.periodic.codim2._po_ma_problem_functional(po, "D",
                                                             "fold")
    rng = np.random.default_rng(5)
    nX = po.u0.shape[0]
    par = dict(po.set_lens_param(po.params, sp.param))
    par["_a"] = torch.tensor(rng.standard_normal(nX))
    par["_b"] = torch.tensor(rng.standard_normal(nX))
    Y = torch.cat([torch.as_tensor(sp.x), torch.tensor([sp.param])])
    J = maprob.jac(Y, par)
    ref = bt.periodic.codim2.po_sigma_autodiff(maprob, Y, par)
    assert _rel(J.sig_X.numpy(), ref[0].numpy()) <= 1e-8
    assert _rel(J.sig_p1.numpy(), ref[1].numpy()) <= 1e-8
