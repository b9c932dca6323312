"""The state verbs of `jl_tpu_torch/core/state.py` that the port lacked
before (`tree_conj`, `tree_real`, `tree_dot`, `tree_norm_inf`,
`arc_length_eq`) against their JAX counterparts (`jl_tpu/core/state.py`),
in f64 to 1e-14 on the same seeded inputs, pytrees and bordered states
included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu.core import state as js
from bifurcationkit.jl_tpu_torch.core import state as ts


def _tree(seed, complex_=False):
    rng = np.random.default_rng(seed)

    def arr(shape):
        a = rng.standard_normal(shape)
        return a + 1j * rng.standard_normal(shape) if complex_ else a

    return {"a": arr((5,)), "b": arr((3, 2)), "c": (arr((4,)), arr(()))}


def _to(tree, mod):
    conv = jnp.asarray if mod is js else torch.tensor
    if isinstance(tree, dict):
        return {k: _to(v, mod) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, mod) for v in tree)
    return conv(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.resolve_conj().numpy()]
    return [np.asarray(tree)]


def test_tree_dots_as_test_core_uses_them():
    """`test_core.py::test_tree_dots` on the port."""
    x = {"a": torch.tensor([1.0, 2.0], dtype=torch.float64),
         "b": torch.tensor([[3.0]], dtype=torch.float64)}
    y = {"a": torch.tensor([4.0, 5.0], dtype=torch.float64),
         "b": torch.tensor([[6.0]], dtype=torch.float64)}
    assert float(ts.tree_dot(x, y)) == pytest.approx(1 * 4 + 2 * 5 + 3 * 6)
    z = torch.tensor([1.0 + 1j, 2.0], dtype=torch.complex128)
    assert complex(ts.tree_vdot(z, z)).real == pytest.approx(6.0)
    assert float(ts.tree_norm(x)) == pytest.approx(np.sqrt(1 + 4 + 9))


@pytest.mark.parametrize("complex_", [False, True])
def test_tree_dot_and_norm_inf_match_jax(complex_):
    a, b = _tree(1, complex_), _tree(2, complex_)
    for f in ("tree_dot", "tree_vdot"):
        got = complex(getattr(ts, f)(_to(a, ts), _to(b, ts)))
        ref = complex(getattr(js, f)(_to(a, js), _to(b, js)))
        assert abs(got - ref) <= 1e-14 * max(abs(ref), 1.0)
    got = float(ts.tree_norm_inf(_to(a, ts)))
    assert got == pytest.approx(float(js.tree_norm_inf(_to(a, js))),
                                rel=1e-14)


def test_tree_conj_and_real_match_jax():
    a = _tree(3, complex_=True)
    for f in ("tree_conj", "tree_real"):
        got = _leaves(getattr(ts, f)(_to(a, ts)))
        ref = _leaves(getattr(js, f)(_to(a, js)))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=1e-14, atol=0)


def test_bordered_state_reductions_match_jax():
    rng = np.random.default_rng(4)
    u1, u2 = rng.standard_normal(7), rng.standard_normal(7)
    p1, p2 = -0.3, 1.7
    f64 = torch.float64
    t = ts.BorderedState(u=torch.tensor(u1), p=torch.tensor(p1, dtype=f64))
    s = ts.BorderedState(u=torch.tensor(u2), p=torch.tensor(p2, dtype=f64))
    jt = js.BorderedState(u=jnp.asarray(u1), p=jnp.asarray(p1))
    jsb = js.BorderedState(u=jnp.asarray(u2), p=jnp.asarray(p2))
    assert float(ts.tree_dot(t, s)) == pytest.approx(
        float(js.tree_dot(jt, jsb)), rel=1e-14)
    assert float(ts.tree_norm_inf(t)) == float(js.tree_norm_inf(jt))
    assert ts.tree_size(t) == js.tree_size(jt) == 8


@pytest.mark.parametrize("theta,n", [(0.5, 7), (0.01, 13)])
def test_arc_length_eq_matches_jax(theta, n):
    rng = np.random.default_rng(5)
    u, du = rng.standard_normal(n), rng.standard_normal(n)
    p, dp, ds = 0.4, -0.9, 0.03
    f64 = torch.float64
    got = float(ts.arc_length_eq(ts.DotTheta(), torch.tensor(u),
                                 torch.tensor(p, dtype=f64), torch.tensor(du),
                                 torch.tensor(dp, dtype=f64), theta, ds, n))
    ref = float(js.arc_length_eq(js.DotTheta(), jnp.asarray(u),
                                 jnp.asarray(p), jnp.asarray(du),
                                 jnp.asarray(dp), theta, ds, n))
    assert abs(got - ref) <= 1e-14 * max(abs(ref), 1.0)
