"""Parity of the port's freezing method (`jl_tpu_torch/wave/freezing.py`)
with the JAX package's (`jl_tpu/wave/freezing.py`) on the two wave tests
of `test_wave_bvp.py`: the Nagumo front (one generator) and the rotating
pulse of the periodic cubic-quintic cGL (translation and gauge rotation).

Tolerances: the Newton roots of both packages agree to 1e-9 (both stop
at 1e-8 / 1e-10 on iterates of the same dense Newton); the gold values
are the JAX test's: the front speed within 2e-4 of the exact -c with its
far-field values held to 1e-2, the cGL pulse's exact mu = 0 speeds
(0, -nu) to 1e-10, and exactly two zero modes of the co-moving operator
(below 1e-8, the next above 0.05).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.wave import EigenWave

from _bvp_wave_models import cgl_pulse, nagumo


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_nagumo_front_matches_jax():
    Fj, ddx_j, u_exact, c = nagumo(jnp)
    Ft, ddx_t, _, _ = nagumo(torch)
    pj = bj.BifurcationProblem(Fj, u0=jnp.asarray(u_exact),
                               params={"a": 0.25}, lens="a")
    pt = bt.BifurcationProblem(Ft, u0=_t(u_exact),
                               params={"a": _t(0.25)}, lens="a")
    twj = bj.travelling_wave_problem(pj, ddx_j, speeds0=jnp.array([-c]))
    twt = bt.travelling_wave_problem(pt, ddx_t, speeds0=[-c])
    opts = dict(tol=1e-8, max_iterations=30)
    sj = bj.newton(twj, bj.NewtonPar(**opts))
    st = bt.newton(twt, bt.NewtonPar(**opts))
    assert bool(sj.converged) and st.converged
    np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                               atol=1e-9)
    u, s = interop.wave_state_to_numpy(st.u, twt.n_inner)
    assert s[0] == pytest.approx(-c, abs=2e-4)
    assert u[0] == pytest.approx(0.0, abs=1e-2)
    assert u[-1] == pytest.approx(1.0, abs=1e-2)
    rec = twt.record_from_solution(st.u, 0.25)
    assert float(rec["speed"]) == pytest.approx(s[0], abs=1e-15)
    assert twt.lens.name == "tw/a"


def test_cgl_two_generators_match_jax():
    """mu = 0: the exact pulse with speeds (0, -nu); mu = 0.2 (continued
    through 0.1 as in the JAX test): s1 = 0 by reflection symmetry, the
    gauge speed in (-nu, -0.9), and exactly two zero modes of the
    co-moving operator `eig_jacobian` (torch.func.jacfwd)."""
    Fj, T1j, T2j, a = cgl_pulse(jnp, jnp.roll)
    Ft, T1t, T2t, _ = cgl_pulse(torch, torch.roll)
    n = a.shape[0]
    uk = np.stack([a, np.zeros(n)])
    sk = np.array([0.0, -1.0])
    out = {}
    for mu in (0.0, 0.1, 0.2):
        par = {"r": -0.1, "nu": 1.0, "mu": mu}
        pj = bj.BifurcationProblem(Fj, u0=jnp.zeros((2, n)), params=par,
                                   lens="r")
        pt = bt.BifurcationProblem(
            Ft, u0=torch.zeros((2, n), dtype=torch.float64),
            params={k: _t(v) for k, v in par.items()}, lens="r")
        twj = bj.travelling_wave_problem(pj, (T1j, T2j), u0=jnp.asarray(uk),
                                         speeds0=jnp.asarray(sk), params=par)
        twt = bt.travelling_wave_problem(pt, (T1t, T2t), u0=_t(uk),
                                         speeds0=_t(sk))
        opts = dict(tol=1e-10, max_iterations=50)
        sj = bj.newton(twj, bj.NewtonPar(**opts))
        st = bt.newton(twt, bt.NewtonPar(**opts))
        assert bool(sj.converged) and st.converged, mu
        np.testing.assert_allclose(st.u.numpy(), np.asarray(sj.u), rtol=0,
                                   atol=1e-9)
        out[mu] = (st.u, twt)
        X = st.u.numpy()
        uk, sk = X[:2 * n].reshape(2, n), X[-2:]
    X0 = out[0.0][0].numpy()
    assert abs(X0[-2]) < 1e-10 and abs(X0[-1] + 1.0) < 1e-10
    assert abs(np.abs(X0[:n]).max() - a.max()) < 1e-3
    X2, tw2 = out[0.2]
    assert abs(float(X2[-2])) < 1e-10 and -1.0 < float(X2[-1]) < -0.9
    op = tw2.eig_jacobian(X2, tw2.params)
    assert op.shape == (2 * n, 2 * n)
    w = np.sort(np.abs(np.linalg.eigvals(op.numpy())))
    assert w[0] < 1e-8 and w[1] < 1e-8 and w[2] > 0.05
    assert EigenWave().eigsolver is None


def test_update_ref_every_step():
    """The phase condition re-anchors on the current profile when asked
    (the JAX `update` hook)."""
    Ft, ddx_t, u_exact, c = nagumo(torch)
    pt = bt.BifurcationProblem(Ft, u0=_t(u_exact), params={"a": _t(0.25)},
                               lens="a")
    tw = bt.travelling_wave_problem(pt, ddx_t, speeds0=[-c],
                                    update_ref_every_step=2)
    cp = bt.ContinuationPar(ds=0.01, dsmax=0.02, max_steps=3,
                            detect_bifurcation=0,
                            newton_options=bt.NewtonPar(tol=1e-8))
    br = bt.continuation(tw, bt.PALC(), cp)
    assert len(br) == 4
    speeds = np.asarray(br["speed"])
    # the exact speed follows the continued a: -(1 - 2 a) / sqrt(2)
    np.testing.assert_allclose(speeds, -(1 - 2 * br.param) / np.sqrt(2),
                               atol=2e-4)
