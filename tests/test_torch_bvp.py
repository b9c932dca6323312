"""Parity of the port's generic BVPs (`jl_tpu_torch/bvp/bvp.py`) with the
JAX package's (`jl_tpu/bvp/bvp.py`) on the fixtures of `test_wave_bvp.py`,
`test_bvp_cop_adapt.py` and `test_bvp_oscillator.py`: Bratu by
collocation and trapezoid, the analytic block jacobian and the
condensed (COP) solve (shooting and the Duffing resonance curve:
`test_torch_bvp_shooting.py`).

Tolerances: Newton roots of the two packages 1e-9 (both at tol 1e-10 on
the same discretization); the block jacobian against the dense forward-AD
jacobian 1e-12 relative; the COP solve against a dense solve 1e-10
relative (condensation reorders the elimination); the Bratu midpoint
within 2e-3 of 0.14050 (the JAX test's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.bvp import bvp as jbvp
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.bvp import (BVPCOPLS, bvp_block_jacobian,
                                             bvp_cop_solve)

from _bvp_wave_models import bratu


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _guess(t):
    return np.array([0.3 * t * (1 - t), 0.3 * (1 - 2 * t)])


DISCS = {"collocation": lambda pkg: pkg.BVPCollocation(Ntst=15, m=4),
         "trapezoid": lambda pkg: pkg.BVPTrapezoid(M=60),
         "shooting": lambda pkg: pkg.BVPShooting(M=6, steps_per_segment=80)}


@pytest.mark.parametrize("kind", ["collocation", "trapezoid"])
def test_bratu_newton_matches_jax(kind):
    bratu_newton_pair(kind)


def bratu_newton_pair(kind):
    """Newton on Bratu at lam = 1 in both packages, from the same guess."""
    sols = {}
    for pkg, xp in ((bj, jnp), (bt, torch)):
        model, disc = bratu(pkg, xp), DISCS[kind](pkg)
        on = {"device": "cpu"} if pkg is bt else {}
        X0 = pkg.discretize(model, disc, _guess, 2, **on)
        lam = 1.0 if pkg is bj else torch.tensor(1.0, dtype=torch.float64)
        prob = pkg.bvp_problem(model, disc, X0, {"lam": lam}, "lam", n=2)
        sol = pkg.newton(prob, pkg.NewtonPar(tol=1e-10))
        assert bool(sol.converged)
        sols[pkg.__name__] = np.asarray(sol.u)
        if pkg is bt:
            assert X0.shape == (disc.unknown_size(2),)
            u = interop.bvp_nodes_to_numpy(sol.u, 2)
            mid = np.interp(0.5, disc.times(), u[:, 0])
            assert mid == pytest.approx(0.14050, abs=2e-3)
    np.testing.assert_allclose(sols[bt.__name__], sols[bj.__name__],
                               rtol=0, atol=1e-9)


def _coll_pair():
    model = bratu(bt, torch)
    disc = bt.BVPCollocation(Ntst=12, m=4)
    X0 = bt.discretize(model, disc,
                       lambda t: np.array([0.3 * np.sin(np.pi * t), 0.0]), 2,
                       device="cpu")
    return model, disc, X0, {"lam": torch.tensor(1.0, dtype=torch.float64)}


def test_block_jacobian_matches_ad_and_jax():
    model, disc, X0, par = _coll_pair()
    blocks = bvp_block_jacobian(disc, model, X0, par, 2)
    J_ad = jacfwd(lambda X: disc.residual(model, X, par, 2))(X0)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(
        X0.shape[0]))
    ref = J_ad @ v
    assert float((blocks(v) - ref).abs().max() / ref.abs().max()) < 1e-12
    # the JAX package's blocks on the same point
    jmodel = bratu(bj, jnp)
    jdisc = bj.BVPCollocation(Ntst=12, m=4)
    jb = jbvp.bvp_block_jacobian(jdisc, jmodel, jnp.asarray(X0.numpy()),
                                 {"lam": 1.0}, 2)
    for name in ("Aint", "B0", "G0", "G1"):
        np.testing.assert_allclose(getattr(blocks, name).numpy(),
                                   np.asarray(getattr(jb, name)), rtol=0,
                                   atol=1e-12)


def test_cop_solve_matches_dense_and_newton():
    model, disc, X0, par = _coll_pair()
    blocks = bvp_block_jacobian(disc, model, X0, par, 2)
    J_ad = jacfwd(lambda X: disc.residual(model, X, par, 2))(X0)
    rhs = torch.as_tensor(np.random.default_rng(1).standard_normal(
        X0.shape[0]))
    x = bvp_cop_solve(blocks, rhs)
    ref = torch.linalg.solve(J_ad, rhs)
    assert float((x - ref).abs().max() / ref.abs().max()) < 1e-10
    prob = bt.bvp_problem(model, disc, X0, par, "lam", n=2, use_cop=True)
    sol = bt.newton(prob, bt.NewtonPar(tol=1e-11, max_iterations=20,
                                       linsolver=BVPCOPLS()))
    assert sol.converged
    u = sol.u.reshape(-1, 2).numpy()
    tmid = np.argmin(np.abs(disc.times() - 0.5))
    assert abs(u[tmid, 0] - 0.1405392) < 1e-4



@pytest.mark.parametrize("kind", sorted(DISCS))
def test_discretize_needs_the_card_unless_told(kind, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, disc = bratu(bt, torch), DISCS[kind](bt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bt.discretize(model, disc, _guess, 2)
    X0 = bt.discretize(model, disc, _guess, 2, device="cpu")
    assert X0.device.type == "cpu" and X0.dtype == torch.float64
    assert X0.shape == (disc.unknown_size(2),)
