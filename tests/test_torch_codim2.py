"""Codim-2 minimally augmented curves, dense route, run by the JAX package
and by the port from the same problems and options (mirrors
`test_codim2.py`: the cusp fold curve with cusp detection, the Hopf curve,
`newton_fold`/`newton_hopf`, and the zero-Hopf point that the GH test
finds on a Lorenz-84 Hopf curve; BT detection is held on the matrix-free
route, in `test_torch_minaug_mf.py`).

Tolerances, and why:
* closed forms: the cusp fold curve 4 p1^3 + 27 p2^2 = 0 to 1e-8 (1e-6
  in the JAX test), the Hopf curve p1 = -q and omega = 1 to 1e-8, the
  exact fold of u^3 - u + p2 to 1e-8;
* curves against the JAX package's, column by column (`param`, `p1`,
  and `omega` on a Hopf curve): 1e-8 — the same Newton on the same
  functional, converged to 1e-9 or better; Newton's refined fold point
  to 1e-9;
* detected codim-2 points: the same types in the same order, located by
  bisection to 1e-6 of the JAX package's, both computed in the test from
  the same inputs;
* the zero-Hopf point, independently: where `refine_gh` bisects the sign
  change of l1, the jacobian has a real eigenvalue at 0 and the Hopf pair
  at +-i omega, both to 1e-6.

Depth is cut to what each case needs: the port's codim-1 branches stop
just past their first special point, and both packages' curves start from
that point, the cusp's just past the cusp; the Lorenz-84 case starts near
the Hopf point at G = 1.6, and its event bisection takes 4 steps.  The JAX
package's models run under `jax.jit`.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels

DTYPE = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(pkg, values):
    if pkg is bj:
        return jnp.asarray(values, dtype=jnp.float64)
    return torch.tensor(values, dtype=DTYPE)


def _par(pkg, **kw):
    return {k: (v if pkg is bj else torch.tensor(v, dtype=DTYPE))
            for k, v in kw.items()}


def _stack(pkg, rows):
    return jnp.array(rows) if pkg is bj else torch.stack(rows)


def _jit(pkg, F):
    """The JAX package's F under `jax.jit`: the same function, compiled
    once rather than op by op at every eager call."""
    return jax.jit(F) if pkg is bj else F


def cusp_model(pkg, p1=-1.0, p2=0.0):
    """u^3 + p1 u + p2: fold curve 4 p1^3 + 27 p2^2 = 0, cusp at (0, 0)."""
    def F(u, par):
        return u ** 3 + par["p1"] * u + par["p2"]

    return pkg.BifurcationProblem(_jit(pkg, F), u0=_arr(pkg, [1.0]),
                                  params=_par(pkg, p1=p1, p2=p2), lens="p2")


def hopf_model(pkg):
    """z' = (p + q + i) z - z|z|^2: Hopf curve p = -q, omega = 1."""
    def F(u, par):
        x, y = u[0], u[1]
        mu = par["p"] + par["q"]
        r2 = x * x + y * y
        return _stack(pkg, [mu * x - y - x * r2, x + mu * y - y * r2])

    return pkg.BifurcationProblem(_jit(pkg, F), u0=_arr(pkg, [0.0, 0.0]),
                                  params=_par(pkg, p=-0.5, q=0.0), lens="p")


def _cp(pkg, **kw):
    base = dict(ds=0.01, dsmax=0.05, dsmin=1e-5, p_min=-1.0, p_max=1.0,
                max_steps=150, detect_bifurcation=3, nev=2, n_inversion=4,
                newton_options=pkg.NewtonPar(tol=1e-10, max_iterations=30))
    base.update(kw)
    return pkg.ContinuationPar(**base)


def _both(fn):
    return {"jax": fn(bj), "torch": fn(bt)}


def _first(br, *types):
    sp = next(sp for sp in br.specialpoint if sp.type in types)
    return br.specialpoint.index(sp)


def _branches(model, *types, **cp):
    """The port's codim-1 branch of `model` to just past its first point
    of `types`, and that point for the JAX package as a one-point branch
    (`prob`, `specialpoint`) on the JAX model: both codim-2 curves start
    from the same point (the JAX codim-1 branch would compile for seconds
    to reproduce it)."""
    from bifurcationkit.jl_tpu.detection.points import SpecialPoint

    br = bt.continuation(model(bt), bt.PALC(), _cp(bt, **cp))
    sp = br.specialpoint[_first(br, *types)]
    jsp = SpecialPoint(type=sp.type, param=float(sp.param),
                       x=jnp.asarray(sp.x.numpy()))
    return {"torch": br,
            "jax": SimpleNamespace(prob=model(bj), specialpoint=[jsp])}


@pytest.fixture(scope="module")
def cusp_branches():
    """The cusp model's branch in p2 to just past its first fold."""
    return _branches(cusp_model, "fold", detect_bifurcation=0,
                     detect_fold=True, max_steps=20)


def _same_curves(curves, keys, atol=1e-8):
    t = interop.codim2_branch_to_numpy(curves["torch"])
    j = interop.codim2_branch_to_numpy(curves["jax"])
    assert len(t["param"]) == len(j["param"])
    for k in keys:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=atol, err_msg=k)
    assert list(t["sp_type"]) == list(j["sp_type"])
    np.testing.assert_allclose(t["sp_param"], j["sp_param"], rtol=0,
                               atol=1e-6)
    return t


def test_fold_curve_cusp_model(cusp_branches):
    """The cusp model's fold curve in p1 through the cusp at
    (p1, p2) = (0, 0): it satisfies 4 p1^3 + 27 p2^2 = 0 ('p1' holds the
    state's fold parameter, the model's p2), the cusp is detected and
    bisected, and all of it matches the JAX package."""
    def run(pkg):
        br = cusp_branches["jax" if pkg is bj else "torch"]
        cp2 = _cp(pkg, ds=0.06, dsmax=0.08, p_min=-1.2, p_max=0.3,
                  max_steps=13, detect_bifurcation=0, detect_fold=False)
        return pkg.continuation_fold(br, _first(br, "fold"), "p1", cp2,
                                     detect_codim2_bifurcation=2)

    t = _same_curves(_both(run), ("param", "p1"))
    assert len(t["param"]) > 10
    assert np.max(np.abs(4 * t["param"] ** 3 + 27 * t["p1"] ** 2)) < 1e-8
    cusps = [p for k, p in zip(t["sp_type"], t["sp_param"]) if k == "cusp"]
    assert cusps and abs(cusps[0]) < 5e-2


@pytest.fixture(scope="module")
def hopf_branches():
    return _branches(hopf_model, "hopf", max_steps=15)


def test_hopf_curve(hopf_branches):
    """The Hopf curve p1 = -q with omega = 1 (the dense Hopf functional is
    held against the JAX package's on the Lorenz-84 curve below)."""
    br = hopf_branches["torch"]
    cp2 = _cp(bt, ds=0.02, dsmax=0.05, p_min=-0.8, p_max=0.8,
              max_steps=100, detect_bifurcation=0, detect_fold=False)
    t = interop.codim2_branch_to_numpy(bt.continuation_hopf(
        br, _first(br, "hopf"), "q", cp2, detect_codim2_bifurcation=0))
    assert len(t["param"]) > 10
    np.testing.assert_allclose(t["p1"], -t["param"], atol=1e-8)
    np.testing.assert_allclose(t["omega"], 1.0, atol=1e-8)


def test_newton_fold_and_hopf(cusp_branches, hopf_branches):
    """Newton on the MA functionals refines the fold of u^3 - u + p2 to
    u = 1/sqrt(3), p2 = 2/(3 sqrt 3), as the JAX package does, and the
    Hopf point to p = 0, omega = 1."""
    def host(u):
        return np.asarray(u.detach().numpy() if isinstance(u, torch.Tensor)
                          else u)

    folds = {}
    for name, pkg in (("jax", bj), ("torch", bt)):
        bf = cusp_branches[name]
        sf = pkg.newton_fold(bf, _first(bf, "fold"),
                             pkg.NewtonPar(tol=1e-10, max_iterations=30))
        assert bool(sf.converged)
        folds[name] = host(sf.u)
    bh = hopf_branches["torch"]
    sh = bt.newton_hopf(bh, _first(bh, "hopf"),
                        bt.NewtonPar(tol=1e-10, max_iterations=30))
    assert bool(sh.converged)
    uf, uh = folds["torch"], host(sh.u)
    assert abs(abs(uf[0]) - 1 / np.sqrt(3)) < 1e-8
    assert abs(abs(uf[1]) - 2 / (3 * np.sqrt(3))) < 1e-8
    np.testing.assert_allclose(uh[2:], [0.0, 1.0], atol=1e-8)
    np.testing.assert_allclose(uf, folds["jax"], rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def lorenz84_curves():
    """The Lorenz-84 Hopf curve in G with the GH test on, run by the port
    and by the JAX package from the port's Hopf point on the codim-1
    branch in F, which starts at G = 1.6 near that point (the JAX test
    starts at G = 0.25 and walks the Hopf curve 40 steps to another
    zero-Hopf point)."""
    from bifurcationkit.jl_tpu import models as jmodels
    from bifurcationkit.jl_tpu.detection.points import SpecialPoint

    params = {"a": 0.25, "b": 4.0, "G": 1.6, "F": 1.64}
    prob = tmodels.lorenz84(params=params, device="cpu")
    prob = prob.re_make(u0=_arr(bt, [1.18467, -0.013138, 0.337135, 0.0]))
    cp = bt.ContinuationPar(
        ds=-0.005, dsmax=0.01, dsmin=1e-6, p_min=-1.0, p_max=5.0,
        max_steps=4, detect_bifurcation=3, nev=4, n_inversion=6,
        newton_options=bt.NewtonPar(tol=1e-10, max_iterations=30))
    br = bt.continuation(prob, bt.PALC(), cp)
    sp = br.specialpoint[_first(br, "hopf")]
    jprob = jmodels.lorenz84(params=params)
    jbr = SimpleNamespace(
        prob=jprob.re_make(F=_jit(bj, jprob.F)),
        specialpoint=[SpecialPoint(type="hopf", param=float(sp.param),
                                   x=jnp.asarray(sp.x.numpy()))])

    def run(pkg, b, i):
        cp2 = pkg.ContinuationPar(
            ds=0.01, dsmax=0.03, dsmin=1e-6, p_min=0.0001, p_max=1.75,
            max_steps=4, detect_bifurcation=0, detect_fold=False,
            max_bisection_steps=4,
            newton_options=pkg.NewtonPar(tol=1e-9, max_iterations=30))
        return pkg.continuation_hopf(b, i, "G", cp2,
                                     detect_codim2_bifurcation=2)

    return prob, {"torch": run(bt, br, _first(br, "hopf")),
                  "jax": run(bj, jbr, 0)}


def test_gh_test_finds_zh_on_lorenz84(lorenz84_curves):
    """The first-Lyapunov (GH) test along a Lorenz-84 Hopf curve in G
    changes sign through its pole at a real eigenvalue zero, so the point
    is relabelled zero-Hopf, where the JAX package puts it (to 1e-6).
    Both packages place the label at the bisection iterate of least |l1|,
    which by a pole is the bracket's far end, not the zero-Hopf point;
    `refine_gh` bisects the sign of l1 in that bracket to the pole, where
    the jacobian has a real eigenvalue at 0 and the Hopf pair at +-i omega
    to 1e-6."""
    prob, curves = lorenz84_curves
    t = _same_curves(curves, ("param", "p1", "omega"))
    zh = [i for i, k in enumerate(t["sp_type"]) if k == "zh"]
    assert zh, list(t["sp_type"])
    assert t["sp_status"][zh[0]] == "converged"

    def spectrum(X, G):
        X = X.numpy()
        par = {**prob.params, "G": torch.tensor(float(G), dtype=DTYPE),
               "F": torch.tensor(float(X[4]), dtype=DTYPE)}
        return np.linalg.eigvals(
            prob.jacobian(torch.as_tensor(X[:4]), par).numpy()), X[5]

    brh = curves["torch"]
    sp = brh.specialpoint[zh[0]]
    vals, _ = spectrum(sp.x, sp.param)
    assert np.min(np.abs(vals[np.abs(vals.imag) < 1e-6].real)) < 2e-2
    X, G = bt.refine_gh(brh, zh[0], max_steps=16)
    lo, hi = sp.interval
    assert lo < G < hi
    vals, omega = spectrum(X, G)
    real = vals[np.abs(vals.imag) < 1e-6]
    assert np.min(np.abs(real.real)) < 1e-6, vals
    assert np.min(np.abs(vals - 1j * omega)) < 1e-6, (vals, omega)
