"""Parity of the port's user events (`detection/events.py`) and nev
auto-raise with the JAX package's: the events on the reference's Feve
field (mirrors `test_events.py`, on fewer runs) and the auto-raise of
`test_autonev.py`.  Both packages run the same problem and options; the
JAX package's engine jits its own kernels.

Tolerances, and why: every special point's type is the same in both
packages and its parameter agrees to 1e-9 (both bisect to
`tol_param_bisection_event` or tighter from the same branch; they differ
by rounding), and the located events sit where the closed forms put them
to 1e-6, as the JAX tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.detection import events as jev
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.detection import events as tev

CPU = torch.device("cpu")
DT = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feve(pkg):
    """ref Feve, event.jl:64-71 (k = 3)."""
    if pkg is bj:
        def F(X, par):
            x, y = X[0], X[1]
            p1 = par["p1"]
            return jnp.array([p1 + x - y - x ** 3 / 3,
                              p1 + y + x - 2 * y ** 3 / 3])

        return bj.BifurcationProblem(F, u0=-2 * jnp.ones(2),
                                     params={"p1": -3.0, "p2": -3.0},
                                     lens="p1")

    def F(X, par):
        x, y = X[0], X[1]
        p1 = par["p1"]
        return torch.stack([p1 + x - y - x ** 3 / 3,
                            p1 + y + x - 2 * y ** 3 / 3])

    return bt.BifurcationProblem(
        F, u0=-2 * torch.ones(2, dtype=DT),
        params={"p1": torch.tensor(-3.0, dtype=DT),
                "p2": torch.tensor(-3.0, dtype=DT)}, lens="p1")


def _cp(pkg, **kw):
    # the events all lie in [-3, 1.5]: the branch stops there (p_max 4.0
    # in the JAX tests)
    base = dict(ds=0.001, dsmax=0.1, dsmin=1e-8, p_min=-3.0, p_max=1.5,
                max_steps=1000, detect_bifurcation=0, detect_fold=False,
                detect_event=2,
                newton_options=pkg.NewtonPar(tol=1e-10, max_iterations=8))
    base.update(kw)
    return pkg.ContinuationPar(**base)


def _points(br):
    return [(sp.type, float(sp.param)) for sp in br.specialpoint
            if sp.type != "endpoint"]


def _same_points(a, b, tol=1e-9):
    assert [t for t, _ in a] == [t for t, _ in b]
    np.testing.assert_allclose([p for _, p in a], [p for _, p in b],
                               rtol=0, atol=tol)


def _both(make_event, **kw):
    out = {}
    for pkg, ev in ((bj, jev), (bt, tev)):
        out[pkg] = _points(pkg.continuation(_feve(pkg), pkg.PALC(),
                                            _cp(pkg, **kw),
                                            event=make_event(ev)))
    _same_points(out[bj], out[bt])
    return out[bt]


def test_pair_of_events_matches_jax():
    """Continuous (p = 0) + discrete (p > -2) composite
    (ref event.jl:176-184): `ContinuousEvent`, `DiscreteEvent` and
    `PairOfEvents`."""
    pts = _both(lambda ev: ev.PairOfEvents(
        ev.ContinuousEvent(nb=1, condition=lambda it, st: (st.p,),
                           labels=["pzero"]),
        ev.DiscreteEvent(nb=1, condition=lambda it, st: (
            float(st.p > -2.0),), labels=["pgt"])))
    types = [t for t, _ in pts]
    assert "pzero" in types and "pgt" in types
    assert abs(dict(pts)["pzero"]) < 1e-6


def test_set_of_events_with_save_at_matches_jax():
    """Two labelled continuous components and `save_at_event` in one
    `SetOfEvents` (ref event.jl:105-130); a set labels its points
    `userC` in both packages."""
    pts = _both(lambda ev: ev.SetOfEvents((
        ev.ContinuousEvent(nb=2, condition=lambda it, st: (
            st.p + 2.0, float(st.z.u[0]) - 1.0),
            labels=["User-2.0", "User1.0"]),
        ev.save_at_event((0.0, 1.0)))))
    ps = [p for t, p in pts if t == "userC"]
    assert len(ps) == len(pts) >= 3
    for where in (-2.0, 0.0, 1.0):
        assert min(abs(p - where) for p in ps) < 1e-6


def test_bif_detect_event_matches_jax():
    """`bif_detect_event` beside the standard detection (ref
    event.jl:166-173)."""
    pts = _both(lambda ev: ev.bif_detect_event(), detect_bifurcation=1,
                nev=2)
    assert len(pts) >= 1


def _many_crossings(pkg, k=12, extra=4):
    """F_i(u, p) = (p - d_i) u_i - u_i^3: one more unstable direction at
    each p = d_i (`test_autonev.py`)."""
    d = np.concatenate([0.1 * (1.0 + np.arange(k)), 10.0 + np.arange(extra)])
    if pkg is bj:
        dj = jnp.asarray(d)
        return bj.BifurcationProblem(
            lambda u, par: (par["p"] - dj) * u - u ** 3,
            u0=jnp.zeros(k + extra), params={"p": 0.0}, lens="p")
    dt_ = torch.as_tensor(d, dtype=DT)
    return bt.BifurcationProblem(
        lambda u, par: (par["p"] - dt_) * u - u ** 3,
        u0=torch.zeros(k + extra, dtype=DT),
        params={"p": torch.tensor(0.0, dtype=DT)}, lens="p")


def test_nev_auto_raise_matches_jax():
    """nev = 5 grows to 16 in both packages, every crossing classified."""
    from bifurcationkit.jl_tpu.continuation.driver import (
        _continuation_loop as jloop)
    from bifurcationkit.jl_tpu.continuation.engine import ContIterable as JIt
    from bifurcationkit.jl_tpu_torch.continuation.driver import (
        _continuation_loop as tloop)

    out = {}
    for pkg, It, loop in ((bj, JIt, jloop), (bt, bt.ContIterable, tloop)):
        cp = pkg.ContinuationPar(ds=0.02, dsmax=0.04, dsmin=1e-6,
                                 p_min=-0.1, p_max=1.45, max_steps=200,
                                 nev=5, detect_bifurcation=3, n_inversion=2,
                                 newton_options=pkg.NewtonPar(tol=1e-10))
        it = It(_many_crossings(pkg), pkg.PALC(), cp)
        assert it.kernels.nev == 5
        res = loop(it)
        out[pkg] = (it.kernels.nev, _points(res))
    assert out[bt][0] == out[bj][0] == 16
    _same_points(out[bj][1], out[bt][1])
    mult = sum(2 if t == "nd" else 1 for t, _ in out[bt][1] if t != "fold")
    assert mult >= 12
