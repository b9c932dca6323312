"""The rest of the equilibrium continuation surface: `MoorePenrose` (direct
and pInv), `AutoSwitch`, `Multiple`, the `Polynomial` tangent and two-sided
(`bothside`) continuation, run by the JAX package and by the port from the
same problem and options, held branch against branch (mirrors
`test_continuation.py::test_moore_penrose`, `::test_moore_penrose_pinv`,
`::test_autoswitch`, `::test_bothside` and the Polynomial and Multiple
cases of `test_misc_solvers.py`).

The problem is the cubic F(u, p) = u^3 - u - p from u = -1.1, p = -0.3,
with folds at p = +-2/sqrt(27); `bothside` runs the pitchfork p u - u^3.

Tolerances, and why:
* `p` per step: 1e-8 absolute — both correctors stop at residual 1e-10
  on the same scalar problem, and the step-size control replays the same
  Newton counts, so the branches visit the same parameters;
* special points: the same types in the same order, `p` within 1e-8;
* the first fold at 2/sqrt(27) to 1e-3, as the JAX tests hold it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu.continuation.algorithms import (
    MoorePenroseLS as JMPLS)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.continuation.algorithms import (
    MoorePenroseLS as TMPLS)

FOLD = 2 / np.sqrt(27)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cp(pkg, **kw):
    base = dict(ds=0.01, dsmax=0.05, dsmin=1e-4, p_min=-1.0, p_max=1.0,
                max_steps=200, detect_bifurcation=0, nev=2, n_inversion=6,
                max_bisection_steps=30,
                newton_options=pkg.NewtonPar(tol=1e-10))
    base.update(kw)
    return pkg.ContinuationPar(**base)


def _cubic(pkg):
    if pkg is bj:
        return bj.BifurcationProblem(lambda u, par: u ** 3 - u - par["p"],
                                     u0=jnp.array([-1.1]),
                                     params={"p": -0.3}, lens="p")
    return bt.BifurcationProblem(
        lambda u, par: u ** 3 - u - par["p"],
        u0=torch.tensor([-1.1], dtype=torch.float64),
        params={"p": torch.tensor(-0.3, dtype=torch.float64)}, lens="p")


# name -> (algorithm of a package, extra ContinuationPar fields), the
# options of the mirrored JAX tests
CASES = {
    "moore_penrose": (lambda pkg: pkg.MoorePenrose(), {}),
    "moore_penrose_pinv": (
        lambda pkg: pkg.MoorePenrose(
            method=(JMPLS if pkg is bj else TMPLS).pInv), {}),
    "autoswitch": (lambda pkg: pkg.AutoSwitch(tol_param=0.5), {}),
    "polynomial": (lambda pkg: pkg.PALC(tangent=pkg.Polynomial(n=2, k=6)),
                   dict(max_steps=150)),
    "multiple": (lambda pkg: pkg.Multiple(nb=3),
                 dict(ds=0.005, dsmax=0.02, dsmin=1e-5)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_algorithm_matches_jax(name):
    make_alg, extra = CASES[name]
    rows = {}
    for pkg in (bj, bt):
        br = pkg.continuation(_cubic(pkg), make_alg(pkg), _cp(pkg, **extra))
        rows[pkg.__name__] = interop.branch_to_numpy(br)
    j, t = rows[bj.__name__], rows[bt.__name__]
    assert len(t["p"]) == len(j["p"])
    np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-8)
    assert list(t["sp_type"]) == list(j["sp_type"])
    np.testing.assert_allclose(t["sp_p"], j["sp_p"], rtol=0, atol=1e-8)
    folds = t["sp_p"][t["sp_type"] == "fold"]
    assert len(folds) >= 1
    assert abs(folds[0]) == pytest.approx(FOLD, abs=1e-3)


def test_bothside_matches_jax():
    """`bothside=True`: the backward run reversed and prepended, steps
    relabelled monotonically (ref `_merge`, src/Results.jl:398-498)."""
    rows, steps = {}, {}
    for pkg, models, dev in ((bj, jmodels, {}), (bt, tmodels,
                                                 {"device": "cpu"})):
        br = pkg.continuation(models.pitchfork_1d(p=-0.5, **dev), pkg.PALC(),
                              _cp(pkg, detect_bifurcation=3), bothside=True)
        rows[pkg.__name__] = interop.branch_to_numpy(br)
        steps[pkg.__name__] = np.asarray(br["step"])
    j, t = rows[bj.__name__], rows[bt.__name__]
    assert t["p"].min() < -0.9 and t["p"].max() > 0.5
    assert (np.diff(steps[bt.__name__]) >= 0).all()
    np.testing.assert_array_equal(steps[bt.__name__], steps[bj.__name__])
    np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-8)
    assert list(t["sp_type"]) == list(j["sp_type"]) and "bp" in t["sp_type"]
    np.testing.assert_allclose(t["sp_p"], j["sp_p"], rtol=0, atol=1e-8)
