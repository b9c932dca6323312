"""Parity of the continuation surface that no other test holds against
the JAX package (mirrors `test_continuation.py:191-271`):
`init_state`/`iterate` driven by hand, the Newton callback, a dict
(pytree) state and the Chebyshev-collocation Chan model `chan_spectral`.

Tolerances, and why: the hand-driven branch and the pytree branch agree
point by point to 1e-9 and their special points' parameters to 1e-9 (the
same corrector from the same start; they differ by rounding); the
spectral Chan folds agree to 1e-8 between the packages (both bisect the
fold to the same Newton tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt

DT = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(br):
    return [(sp.type, float(sp.param)) for sp in br.specialpoint
            if sp.type != "endpoint"]


def _same_points(a, b, tol=1e-9):
    assert [t for t, _ in a] == [t for t, _ in b]
    np.testing.assert_allclose([p for _, p in a], [p for _, p in b],
                               rtol=0, atol=tol)


def test_manual_iteration_matches_jax():
    """`init_state` then `iterate` by hand, resumed from the same state
    (ref iterate_from_two_points, src/Continuation.jl:408)."""
    from bifurcationkit.jl_tpu.continuation.engine import ContIterable as JIt

    ps = {}
    for pkg, It, kw in ((bj, JIt, {}), (bt, bt.ContIterable,
                                        {"device": "cpu"})):
        prob = pkg.models.pitchfork_1d(p=-0.5, **kw)
        cp = pkg.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-6, p_min=-1.0,
                                 p_max=1.0, max_steps=100,
                                 detect_bifurcation=0,
                                 newton_options=pkg.NewtonPar(tol=1e-10))
        it = It(prob, pkg.PALC(), cp)
        state = it.init_state()
        ps[pkg] = [state.p]
        for _ in range(12):
            it.iterate(state)
            assert state.converged
            ps[pkg].append(state.p)
    np.testing.assert_allclose(ps[bt], ps[bj], rtol=0, atol=1e-9)
    assert ps[bt][-1] > ps[bt][0]


def test_newton_callback_rejects_first_solve():
    """A callback that always rejects is threaded into every Newton solve:
    `init_state` fails, as in the JAX package."""
    prob = bt.BifurcationProblem(
        lambda u, par: u ** 3 - u - par["p"],
        u0=torch.tensor([-1.1], dtype=DT),
        params={"p": torch.tensor(-0.3, dtype=DT)}, lens="p")
    cp = bt.ContinuationPar(ds=0.001, dsmax=0.1, p_min=-3.0, p_max=1.5,
                            detect_bifurcation=0,
                            newton_options=bt.NewtonPar(tol=1e-10))
    it = bt.ContIterable(prob, bt.PALC(), cp,
                         callback_newton=lambda d, **k: False)
    with pytest.raises(RuntimeError, match="Newton failed"):
        it.init_state()
    seen = []
    it = bt.ContIterable(prob, bt.PALC(), cp,
                         callback_newton=lambda d, **k: seen.append(
                             d["residual_norm"]) or True)
    it.init_state()
    assert seen and seen[-1] < 1e-10


def test_pytree_state_matches_jax():
    """A dict state through continuation and fold detection
    (ref test/continuation/test-cont-non-vector.jl)."""
    out = {}
    for pkg in (bj, bt):
        if pkg is bj:
            arr = jnp.array
            par = {"p": -0.3}
        else:
            def arr(x):
                return torch.tensor(x, dtype=DT)
            par = {"p": arr(-0.3)}

        def F(u, p):
            x, y = u["x"], u["y"]
            return {"x": x ** 3 - x - p["p"] + 0.1 * y, "y": y - x * x}

        prob = pkg.BifurcationProblem(
            F, u0={"x": arr([-1.1]), "y": arr([1.2])}, params=par, lens="p")
        cp = pkg.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-6, p_min=-1,
                                 p_max=1, max_steps=150,
                                 detect_bifurcation=3, nev=2, n_inversion=4,
                                 newton_options=pkg.NewtonPar(tol=1e-10))
        br = pkg.continuation(prob, pkg.PALC(), cp)
        out[pkg] = (np.asarray(br.param), _points(br), br.sol[0]["x"])
    np.testing.assert_allclose(out[bt][0], out[bj][0], rtol=0, atol=1e-9)
    _same_points(out[bj][1], out[bt][1])
    assert [t for t, _ in out[bt][1]].count("fold") == 2
    assert set(out[bt][2].keys()) == {"x", "y"}


def _chan_folds(pkg, prob):
    sol = pkg.newton(prob, pkg.NewtonPar(tol=1e-11, max_iterations=30))
    assert bool(sol.converged)
    cp = pkg.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-4, p_min=0.0,
                             p_max=4.2, max_steps=200, detect_bifurcation=0,
                             nev=6, newton_options=pkg.NewtonPar(tol=1e-10))
    br = pkg.continuation(prob.re_make(u0=sol.u), pkg.PALC(), cp)
    return sorted(float(sp.param) for sp in br.specialpoint
                  if sp.type == "fold")


def test_chan_spectral_folds_match_jax():
    """Chebyshev-collocation Chan (the chan-af.jl analog) against the JAX
    package's; `test_continuation.py:252` holds the JAX package's against
    the finite-difference Chan."""
    fj = _chan_folds(bj, bj.models.chan_spectral(N=31))
    ft = _chan_folds(bt, bt.models.chan_spectral(N=31, device="cpu"))
    assert len(ft) == len(fj) == 2
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-8)
