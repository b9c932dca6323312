"""Parity of the port's deflation (`deflation.py`: `DeflationOperator`,
`deflated_problem`, `deflated_newton`) and deflated continuation
(`continuation/deflated.py`: `DefCont`, `deflated_continuation`) with the
JAX package's: the cases of `test_deflation.py` on the cubic
F = p u - u^3, and the Carrier problem's deflated continuation
(`examples/carrier.py`, `test_carrier.py:56`) at a cut size.  Where the
seek for new branches draws random perturbations, both packages get the
same `perturb_solution` (numpy draws from one seed each), so they follow
the same branches; the port's own `tree_randn_like` draws are held to the
JAX test's properties instead.

Tolerances, and why: roots and branch points to 1e-9 of the JAX
package's (the same Newton from the same start, to tol 1e-10 or 1e-11;
they differ by rounding); the deflation factor exactly as the closed
form (0.75); the cubic's nontrivial branches at |u| = sqrt(p) to 1e-4, as
the JAX test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.continuation.deflated import (
    DefCont as JDefCont, deflated_continuation as jdeflated_continuation)
from bifurcationkit.jl_tpu.deflation import (
    DeflationOperator as JDefl, deflated_newton as jdeflated_newton)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.core.state import tree_randn_like

DT = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(pkg, x):
    return jnp.asarray(x) if pkg is bj else torch.as_tensor(x, dtype=DT)


def _cubic(pkg, p):
    """F = p u - u^3: roots 0 and +-sqrt(p) for p > 0."""
    par = {"p": p} if pkg is bj else {"p": torch.tensor(p, dtype=DT)}
    return pkg.BifurcationProblem(lambda u, par: par["p"] * u - u ** 3,
                                  u0=_arr(pkg, [0.1]), params=par, lens="p")


def test_deflated_newton_matches_jax():
    roots = {}
    for pkg, Defl, dnewton in ((bj, JDefl, jdeflated_newton),
                               (bt, bt.DeflationOperator, bt.deflated_newton)):
        prob = _cubic(pkg, 1.0)
        defl = Defl(power=2.0, alpha=1.0, max_roots=8)
        opts = pkg.NewtonPar(tol=1e-11, max_iterations=60)
        s1 = pkg.newton(prob, opts)
        assert bool(s1.converged)
        defl.push(s1.u)
        s2 = dnewton(prob, defl, opts, x0=_arr(pkg, [0.2]))
        assert bool(s2.converged)
        defl.push(s2.u)
        s3 = dnewton(prob, defl, opts, x0=_arr(pkg, [-0.3]))
        assert bool(s3.converged)
        roots[pkg] = [float(s.u[0]) for s in (s1, s2, s3)]
    np.testing.assert_allclose(roots[bt], roots[bj], rtol=0, atol=1e-9)
    np.testing.assert_allclose(sorted(roots[bt]), [-1.0, 0.0, 1.0],
                               atol=1e-8)


def test_deflation_operator_value():
    defl = bt.DeflationOperator(power=1.0, alpha=0.5, max_roots=4)
    defl.push(torch.tensor([0.0], dtype=DT))
    # M = 1/|u - 0|^2 + 0.5 = 0.25 + 0.5
    assert float(defl.M(torch.tensor([2.0], dtype=DT))) == pytest.approx(0.75)
    dp = bt.deflated_problem(_cubic(bt, 1.0), defl)
    u = torch.tensor([2.0], dtype=DT)
    assert float(dp.F(u, dp.params)[0]) == pytest.approx(0.75 * (2 - 8))
    with pytest.raises(RuntimeError, match="capacity"):
        for _ in range(4):
            defl.push(u)


def _cubic_cp(pkg, max_steps, detect_bifurcation=1):
    return pkg.ContinuationPar(ds=0.02, dsmax=0.05, dsmin=1e-4, p_min=-0.6,
                               p_max=1.0, max_steps=max_steps,
                               detect_bifurcation=detect_bifurcation, nev=1,
                               newton_options=pkg.NewtonPar(
                                   tol=1e-10, max_iterations=40))


def _finals(dc, key="norm"):
    """(last param, last norm, points) of each branch, in an order that
    rounding cannot change (branches of equal norm sort by length)."""
    rows = [(float(b.param[-1]), float(b[key][-1]), len(b))
            for b in dc.branches]
    return sorted(rows, key=lambda r: (round(r[0], 9), round(r[1], 8), r[2]))


def test_deflated_continuation_cubic_matches_jax():
    """The same perturbations on both sides: the same branches."""
    out = {}
    for pkg, DefCont, dcont in ((bj, JDefCont, jdeflated_continuation),
                                (bt, bt.DefCont, bt.deflated_continuation)):
        rng = np.random.default_rng(4)

        def perturb(sol, p, i, pkg=pkg, rng=rng):
            return _arr(pkg, np.asarray(sol) + 0.1 * rng.standard_normal(1))

        alg = DefCont(max_branches=8, seek_every_step=2,
                      perturb_solution=perturb)
        out[pkg] = _finals(dcont(_cubic(pkg, -0.5), alg, _cubic_cp(pkg, 35)))
    assert len(out[bt]) == len(out[bj]) >= 3
    for a, b in zip(out[bt], out[bj]):
        assert a[2] == b[2]
        np.testing.assert_allclose(a[:2], b[:2], rtol=0, atol=1e-9)
    for p, nrm, k in out[bt]:
        if nrm > 0.3:
            assert nrm == pytest.approx(np.sqrt(p), abs=1e-4)


def test_deflated_continuation_cubic_own_draws():
    """The port's own perturbations (`tree_randn_like` on a seeded
    `torch.Generator`) find both nontrivial branches (the JAX test's
    properties), and the draw is reproducible."""
    u = torch.zeros(3, dtype=DT)
    a = tree_randn_like(torch.Generator().manual_seed(42), {"u": u, "v": u})
    b = tree_randn_like(torch.Generator().manual_seed(42), {"u": u, "v": u})
    assert torch.equal(a["u"], b["u"]) and not torch.equal(a["u"], a["v"])
    alg = bt.DefCont(max_branches=8, seek_every_step=2, perturb_factor=0.1)
    dc = bt.deflated_continuation(_cubic(bt, -0.5), alg,
                                  _cubic_cp(bt, 45, detect_bifurcation=0))
    assert len(dc) >= 3
    assert max(len(b) for b in dc.branches) > 40
    nontrivial = [(p, n) for p, n, k in _finals(dc) if k > 3 and n > 0.3]
    assert len(nontrivial) >= 2
    for p, n in nontrivial:
        assert n == pytest.approx(np.sqrt(p), abs=1e-4)


N_CARRIER = 30      # the example runs N = 100 (the reference N = 200)


def test_carrier_deflated_continuation_matches_jax():
    """`examples/carrier.py:90-102` at N = 30 and 5 steps from eps = 0.6,
    with the example's boundary-vanishing perturbation on both sides."""
    X = np.linspace(-1, 1, N_CARRIER)
    env = np.exp(-0.01 / np.maximum(1 - X ** 2, 1e-12) ** 2)
    out = {}
    for pkg, Defl, DefCont, dcont in (
            (bj, JDefl, JDefCont, jdeflated_continuation),
            (bt, bt.DeflationOperator, bt.DefCont,
             bt.deflated_continuation)):
        kw = {} if pkg is bj else {"device": "cpu"}
        prob = pkg.models.carrier(N=N_CARRIER, **kw)
        prob = prob.re_make(params=prob.set_lens_param(prob.params, 0.6))
        sol = pkg.newton(prob, pkg.NewtonPar(tol=1e-9, max_iterations=30))
        assert bool(sol.converged)
        rng = np.random.default_rng(7)

        def perturb(solu, p, i, pkg=pkg, rng=rng):
            return _arr(pkg, np.asarray(solu)
                        + 0.5 * rng.random(N_CARRIER) * env)

        cp = pkg.ContinuationPar(ds=-0.01, dsmax=0.01, dsmin=1e-5,
                                 p_min=0.3, p_max=0.7, max_steps=5,
                                 detect_bifurcation=0,
                                 newton_options=pkg.NewtonPar(
                                     tol=1e-9, max_iterations=100))
        alg = DefCont(deflation_operator=Defl(max_roots=24),
                      max_branches=12, perturb_solution=perturb,
                      max_new_branches=4)
        out[pkg] = _finals(dcont(prob.re_make(u0=sol.u), alg, cp), "s")
    assert len(out[bt]) == len(out[bj]) >= 2
    for a, b in zip(out[bt], out[bj]):
        assert a[2] == b[2]
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-9, atol=1e-9)
