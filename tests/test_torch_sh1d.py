"""Parity of the port's quintic 1D Swift-Hohenberg
(`jl_tpu_torch/models/equilibria.py::swift_hohenberg_1d`, ref
examples/SHpde_snaking.jl) with the JAX package's: the model, and the
first 30 steps of the flat branch of `test_sh1d_snaking.py` (dense
eigensolves, bifurcation detection and bisection), compared row by row.
In those steps the branch meets the first two of the five discrete
thresholds (1 + mu_k)^2 of `test_sh1d_snaking.py`, which the port holds
to that test's 2e-3.

Tolerances: F 1e-13 relative; `p` per step and at the special points
1e-8 (both correctors stop at 1e-8 on the same dense Newton); equal
stability counts and special-point types.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def thresholds(n=200, l_dom=6.0):
    h = 2 * l_dom / n
    k = np.arange(1, n + 1)
    mu = -(4 / h ** 2) * np.sin(k * np.pi / (2 * (n + 1))) ** 2
    lam = np.sort((1 + mu) ** 2)
    return lam[lam < 1.0]


def test_model_matches_jax():
    jp, tp = jmodels.swift_hohenberg_1d(), tmodels.swift_hohenberg_1d(
        device="cpu")
    u = np.random.default_rng(0).standard_normal(200)
    Fj = jax.jit(jp.F)(jnp.asarray(u), jp.params)
    Ft = tp.F(torch.as_tensor(u), tp.params).numpy()
    assert np.abs(Ft - np.asarray(Fj)).max() / np.abs(Fj).max() < 1e-13
    rj = jp.record_from_solution(jnp.asarray(u), -0.1)
    rt = tp.record_from_solution(torch.as_tensor(u), -0.1)
    for key in ("norm", "nw", "s", "s2", "s4"):
        assert float(rt[key]) == pytest.approx(float(rj[key]), rel=1e-13)


def test_flat_branch_first_steps_match_jax():
    brs = {}
    for pkg, mod in ((bj, jmodels), (bt, tmodels)):
        prob = mod.swift_hohenberg_1d(**({} if pkg is bj
                                         else {"device": "cpu"}))
        cp = pkg.ContinuationPar(
            ds=0.01, dsmax=0.01, dsmin=1e-4, p_min=-1.0, p_max=1.0,
            max_steps=30, detect_bifurcation=3, nev=20, n_inversion=4,
            newton_options=pkg.NewtonPar(tol=1e-8, max_iterations=30))
        brs[pkg] = pkg.continuation(prob, pkg.PALC(), cp)
    a, b = (interop.branch_to_numpy(brs[k]) for k in (bj, bt))
    assert len(b["p"]) == len(a["p"])
    np.testing.assert_allclose(b["p"], a["p"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(b["n_unstable"], a["n_unstable"])
    np.testing.assert_array_equal(b["sp_type"], a["sp_type"])
    np.testing.assert_allclose(b["sp_p"], a["sp_p"], rtol=0, atol=1e-8)
    bps = [sp.param for sp in brs[bt].specialpoint if sp.type == "bp"]
    assert len(bps) == 2
    np.testing.assert_allclose(bps, thresholds()[:2], atol=2e-3)
