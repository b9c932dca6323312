"""The matrix-free fold curve of the constructed fold-Hopf PDE at 10 x 10
(300 unknowns) reports no `bt`: along a minimally augmented fold curve the
engine leaves the fold's own zero eigenvalue out of its inner-spectrum
count (the problem's `eig_tracked_zero`), whose roundoff sign used to read
as a real crossing (`bp`, relabelled `bt`, at a = -0.129).

The run with the count left as it was (the attribute dropped) is the
reference for what must not move: the curve's rows (a, p1) and the
zero-Hopf label of the event to 1e-10.

The JAX package is held against the port at the port's own curve points,
by single applications (its MF flow compiles for about 40 s on the CPU,
so the whole flow runs only in the test marked slow): its model's
jacobian at each point, the dense spectrum of that jacobian, its engine's
count classification (`get_bifurcation_type`), its codim-2 relabelling
(`_relabel_codim2`), its zero-Hopf event condition and its
Bogdanov-Takens test function <w, v> of the bordered null vectors.  On
the dense spectrum the fold's zero eigenvalue reads -2.6e-10, 1.5e-10,
7.3e-10 and 6.5e-15 at the four points, against a stability tolerance of
1e-10: the same roundoff that the repair leaves out.  Counted with that
zero, the JAX package's classification gives exactly the unrepaired
port's labels (zh, bt, nd); counted without it, as its own zero-Hopf
condition counts, exactly the repaired port's (zh, zh).  Its BT test
function keeps one sign, |<w, v>| = 1 to 1e-6, so it places no BT point
on the curve.  The crossing that the zero's flip made an `nd` is now a
second `zh`, on the step that carries a past the exact zero-Hopf point
a = 0, as in the JAX package's own flow (zh, zh, endpoint).  Both runs of
the port take about 4 s each on one thread."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bifurcationkit.jl_tpu as bk
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu.codim2.minaug import (
    _adjoint_border_solve, _border_solve, _relabel_codim2)
from bifurcationkit.jl_tpu.codim2.minaug_mf import fold_codim2_event_mf
from bifurcationkit.jl_tpu.detection.bifurcation import get_bifurcation_type
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.codim2 import minaug_mf
from tests._codim2_models import one_thread  # noqa: F401

N = 10
START = dict(p1=-0.05, a=-0.2)
CODIM1 = dict(ds=0.02, dsmax=0.03, dsmin=1e-6, p_min=-0.3, p_max=0.3,
              max_steps=10, detect_bifurcation=0, detect_fold=True)
CURVE = dict(ds=0.05, dsmax=0.1, dsmin=1e-6, p_min=-0.8, p_max=0.8,
             max_steps=3, detect_bifurcation=2, nev=6, n_inversion=4)
ARNOLDI = dict(which="LR", krylov_dim=128, restarts=8, tol=1e-6)


def _fold_curve(pkg, eig):
    """The codim-1 branch from the upper state s = sqrt(-p1), its fold,
    and the MF fold curve in a, with the same options in either package."""
    base = pkg.models.fold_hopf_interaction_2d(
        Nx=N, Ny=N, **START, **({"device": "cpu"} if pkg is bt else {}))
    if pkg is bt:
        u0 = base.u0.clone()
        u0[0] = np.sqrt(-START["p1"])
    else:
        u0 = base.u0.at[0].set(np.sqrt(-START["p1"]))
    base = base.re_make(u0=u0)
    ls = pkg.GMRES(restart=40, maxiter=300, rtol=1e-10,
                   precond=base.spectral_precond)
    nopt = dict(tol=1e-9, max_iterations=25, linsolver=ls)
    br = pkg.continuation(base, pkg.PALC(), pkg.ContinuationPar(
        **CODIM1, newton_options=pkg.NewtonPar(**nopt)))
    folds = [sp for sp in br.specialpoint if sp.type == "fold"]
    cp2 = pkg.ContinuationPar(**CURVE, newton_options=pkg.NewtonPar(
        **nopt, eigsolver=eig(**ARNOLDI)))
    return pkg.continuation_fold(br, br.specialpoint.index(folds[0]), "a",
                                 cp2, detect_codim2_bifurcation=2,
                                 jacobian_ma="minaug")


def _port_curve():
    brf = _fold_curve(bt, bt.ArnoldiEig)
    return brf, interop.codim2_branch_to_numpy(brf)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def curves(monkeypatch_module):
    brf, fixed = _port_curve()
    orig = minaug_mf._set_ma_attrs

    def unrepaired(*a, **k):
        k.pop("eig_tracked_zero", None)
        return orig(*a, **k)

    monkeypatch_module.setattr(minaug_mf, "_set_ma_attrs", unrepaired)
    brf_old, old = _port_curve()
    return brf, fixed, brf_old, old


def _step_labels(brf):
    """(label, k) for each special point of a curve but the endpoint: k is
    the step whose arrival closes the point's interval (a grows along the
    curve)."""
    param = np.asarray(brf.gamma._table()["param"])
    assert np.all(np.diff(param) > 0)
    out = []
    for sp in brf.gamma.specialpoint:
        if sp.type == "endpoint":
            continue
        k = int(np.argmax(param >= max(sp.interval) - 1e-12))
        out.append((sp.type, k))
    return sorted(out)


def _jax_labels_at(brf, leave_out_zero):
    """The JAX package's labels at the port's curve points (see the module
    docstring), with the fold's zero eigenvalue in the engine's count or
    left out of it."""
    g = brf.gamma
    tol = g.contparams.tol_stability
    pj = bk.models.fold_hopf_interaction_2d(Nx=N, Ny=N)
    jac = jax.jit(lambda u, p1, a: pj.jacobian(
        u, dict(pj.params, p1=p1, a=a)))
    n = int(np.prod(pj.u0.shape))
    # the fold's null vector on p1 = 0 is the constant s field
    e = np.zeros(n)
    e[:N * N] = 1.0 / N
    e = jnp.asarray(e)
    zh_cond = fold_codim2_event_mf(types.SimpleNamespace(
        anchors_kernel=None)).eventD.condition
    it = types.SimpleNamespace(contparams=g.contparams,
                               norm=lambda u: float(jnp.linalg.norm(u)))
    labels, bt_vals, zh_counts = [], [], []
    counts = None
    for k, s in enumerate(g.sol):
        X = np.asarray(s["x"])
        J = jac(jnp.asarray(X[:n].reshape(pj.u0.shape)), X[n], s["p"])
        v, _ = _border_solve(J, e, e)
        w, _ = _adjoint_border_solve(J, e, e)
        bt_vals.append(float(jnp.vdot(w / jnp.linalg.norm(w),
                                      v / jnp.linalg.norm(v))))
        vals = np.linalg.eigvals(np.asarray(J))
        zh_counts.append(zh_cond(it, types.SimpleNamespace(eigvals=vals))[0])
        counted = vals
        if leave_out_zero:
            realish = np.where(np.abs(vals.imag) <= tol)[0]
            counted = np.delete(vals, realish[np.argmin(
                np.abs(vals[realish]))])
        new = (int(np.sum(counted.real > tol)),
               int(np.sum((np.abs(counted.imag) > tol)
                          & (counted.real > tol))))
        if counts is not None:
            state = types.SimpleNamespace(
                n_unstable=(new[0], counts[0]), n_imag=(new[1], counts[1]),
                step=k - 1, p=s["p"], z=types.SimpleNamespace(u=X),
                tau=None, eigvals=vals, eigvecs=None)
            found, sp = get_bifurcation_type(
                it, state, "guess", (g.sol[k - 1]["p"], s["p"]))
            if found:
                gamma = types.SimpleNamespace(specialpoint=[sp])
                _relabel_codim2(gamma, types.SimpleNamespace(ma_kind="fold"))
                labels.append((sp.type, k))
            if zh_counts[-1] != zh_counts[-2]:
                labels.append(("zh", k))
            if np.sign(bt_vals[-1]) != np.sign(bt_vals[-2]):
                labels.append(("bt", k))
        counts = new
    return sorted(labels), np.asarray(bt_vals)


def test_mf_fold_curve_has_no_bt(curves):
    brf, fixed, _, old = curves
    assert getattr(brf.gamma.prob, "eig_tracked_zero", False)
    assert "bt" not in list(fixed["sp_type"])
    assert "bt" in list(old["sp_type"])          # what the repair removes
    assert list(fixed["sp_type"]) == ["zh", "zh", "endpoint"]


def test_labels_match_jax_at_the_curve_points(curves):
    brf, _, brf_old, _ = curves
    assert len(brf.gamma.sol) == len(brf.gamma._table()["param"])
    jax_new, bt_vals = _jax_labels_at(brf, leave_out_zero=True)
    jax_old, _ = _jax_labels_at(brf, leave_out_zero=False)
    assert jax_new == _step_labels(brf)
    assert jax_old == _step_labels(brf_old)
    assert ("bt", 1) in jax_old and not any(t == "bt" for t, _ in jax_new)
    np.testing.assert_allclose(np.abs(bt_vals), 1.0, rtol=0, atol=1e-6)


def test_curve_and_zh_labels_unchanged(curves):
    _, fixed, _, old = curves
    np.testing.assert_allclose(fixed["param"], old["param"], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(fixed["p1"], old["p1"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(fixed["p1"], 0.0, rtol=0, atol=1e-10)
    zh_old = old["sp_param"][old["sp_type"] == "zh"]
    zh_new = fixed["sp_param"][fixed["sp_type"] == "zh"]
    assert len(zh_old) >= 1
    for z in zh_old:
        assert np.min(np.abs(zh_new - z)) <= 1e-10
    # the crossing the tracked zero hid ('nd') is now the second zh, on
    # the step that carries a past the exact zero-Hopf point a = 0
    extra = [z for z in zh_new if np.min(np.abs(zh_old - z)) > 1e-10]
    assert len(extra) == 1 and extra[0] > 0 > min(zh_new)


@pytest.mark.slow
def test_jax_flow_labels(curves):
    """The JAX package's whole flow from the same start with the same
    options (about 50 s on the CPU): the same labels as the repaired port,
    no `bt`, and its zero-Hopf interval holds the exact point a = 0."""
    brf_jax = _fold_curve(bk, bk.ArnoldiEig)
    _, fixed, _, _ = curves
    jx = interop.codim2_branch_to_numpy(brf_jax)
    assert list(jx["sp_type"]) == list(fixed["sp_type"])
    assert "bt" not in list(jx["sp_type"])
    zh = [sp for sp in brf_jax.gamma.specialpoint if sp.type == "zh"]
    assert all(min(sp.interval) < 0 < max(sp.interval) for sp in zh)
    np.testing.assert_allclose(jx["p1"], 0.0, rtol=0, atol=1e-10)
