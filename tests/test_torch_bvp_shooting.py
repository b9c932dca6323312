"""Parity of the port's generic BVPs (`jl_tpu_torch/bvp/bvp.py`) with the
JAX package's: Bratu by multiple shooting (`BVPShooting` on the port's
`Flow`), and the first steps of the Duffing resonance curve of
`test_bvp_oscillator.py` (examples/bvp_nl_oscillator.jl) by collocation.

Tolerances: Newton roots 1e-9 (both at tol 1e-10); the branch's lam to
1e-8 (both correctors stop at 1e-10); t(1) = 1 to 1e-8 (the JAX test's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop

from _bvp_wave_models import duffing
from test_torch_bvp import bratu_newton_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bratu_shooting_matches_jax():
    bratu_newton_pair("shooting")


def test_duffing_first_steps_match_jax():
    """The resonance curve's first PALC steps (Ntst = 40, m = 5, the JAX
    test's discretization), dense Newton in both packages."""
    brs = {}
    for pkg, xp in ((bj, jnp), (bt, torch)):
        model = duffing(pkg, xp)
        disc = pkg.BVPCollocation(Ntst=40, m=5)
        on = {"device": "cpu"} if pkg is bt else {}
        X0 = pkg.discretize(model, disc, lambda t: np.array([0.0, 0.0, t]),
                            3, **on)
        lam = 3.0 if pkg is bj else torch.tensor(3.0, dtype=torch.float64)
        prob = pkg.bvp_problem(model, disc, X0, {"lam": lam}, "lam", n=3)
        sol = pkg.newton(prob, pkg.NewtonPar(tol=1e-10, max_iterations=30))
        assert bool(sol.converged)
        cp = pkg.ContinuationPar(
            ds=-0.01, dsmax=0.05, dsmin=1e-5, p_min=0.5, p_max=10.05,
            max_steps=4, detect_bifurcation=0, detect_fold=True,
            newton_options=pkg.NewtonPar(tol=1e-10, max_iterations=20))
        brs[pkg.__name__] = pkg.continuation(prob.re_make(u0=sol.u),
                                             pkg.PALC(), cp)
    a = interop.branch_to_numpy(brs[bj.__name__])
    b = interop.branch_to_numpy(brs[bt.__name__])
    assert len(b["p"]) == len(a["p"]) == 5
    np.testing.assert_allclose(b["p"], a["p"], rtol=0, atol=1e-8)
    u = interop.bvp_nodes_to_numpy(brs[bt.__name__].get_solx(0), 3)
    assert abs(u[-1, 2] - 1.0) < 1e-8
