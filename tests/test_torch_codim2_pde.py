"""The matrix-free codim-2 flow on the PDE-promoted Bogdanov-Takens model
at a cut size (10 x 10, 200 unknowns; the JAX test and the card run
40 x 40): the branch to its fold, the matrix-free fold curve in b2 with
the BT event, `get_normal_form_codim2` (routed matrix-free), the
matrix-free unfolding and homoclinic predictor at the exact BT, and
`switch_codim2` to the matrix-free Hopf curve by the Jordan-subspace
probe (mirrors `test_minaug_mf.py:670-749`).  Every plain J.v applies the
Neumann Laplacian through `dia_spmv` (its plain version on the CPU).

Tolerances, and why:
* the model's J.v, J^T.v and d2F against the JAX package's jvp, vjp and
  jet of F to 1e-12 relative;
* exact geometry (the mode-0 reduction is the planar BT model scaled by
  the unit-norm constant field s = 1/sqrt(Nx Ny)): the fold curve
  b1 = b2^2/4 to 1e-6 (the JAX bound; here it holds to 1e-8), a BT with
  |b2| < 5e-2, from the curve a b < 0 and ||a| - s| < 0.1 s; at the
  exact BT a = s, b = -s to 1e-10 and K11 = [0, 2] to 1e-8; the switched
  Hopf curve b1 = 0 and omega^2 = -b2 to 1e-6;
* the forms against the JAX package's dense forms at the same point to
  1e-8 * max(|c|, 1) (the BT gauge and a > 0 fix the basis in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu.codim2.normal_forms import (
    bt_normal_form as j_bt_nf)
from bifurcationkit.jl_tpu.codim2.unfolding import bt_unfolding as j_bt_unf
from bifurcationkit.jl_tpu.core.lens import as_lens as j_lens
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.codim2.unfolding import (
    _codim2_point_context)
from bifurcationkit.jl_tpu_torch.models.equilibria import _dct_precond
from tests._codim2_models import DTYPE, close, one_thread

N = 10
S = 1.0 / N          # 1/sqrt(Nx Ny)


def _jax_model():
    pj = jmodels.bogdanov_takens_2d(Nx=N, Ny=N)
    return pj.re_make(F=jax.jit(pj.F))


def test_jac_op_and_forms_match_jax():
    """J.v (one batched DIA launch for both fields), a batch of two J.v,
    J^T.v and d2F against the JAX package's jvp, vjp and jet of F."""
    rng = np.random.default_rng(4)
    pj = jmodels.bogdanov_takens_2d(Nx=N, Ny=N + 3)
    pt = bt.models.bogdanov_takens_2d(Nx=N, Ny=N + 3, device="cpu")
    u, v, w = (rng.standard_normal((2, N, N + 3)) for _ in range(3))
    par = {k: float(x) for k, x in pt.params.items()}
    ref = np.asarray(jax.jvp(lambda x: pj.F(x, par), (jnp.asarray(u),),
                             (jnp.asarray(v),))[1])
    J = pt.jac_op(torch.tensor(u), pt.params)
    got = J(torch.tensor(v)).numpy()
    close(got, ref, 1e-12 * np.max(np.abs(ref)))
    close(J(torch.tensor(np.stack([w, v])))[1].numpy(), got, 0.0)
    _, f = jax.vjp(lambda x: pj.F(x, par), jnp.asarray(u))
    ref_t = np.asarray(f(jnp.asarray(v))[0])
    got_t = pt.jac_adjoint(torch.tensor(u), pt.params)(torch.tensor(v))
    close(got_t.numpy(), ref_t, 1e-12 * np.max(np.abs(ref_t)))
    ref2 = np.asarray(pj.d2F(jnp.asarray(u), par, jnp.asarray(v),
                             jnp.asarray(w)))
    got2 = pt.d2F(torch.tensor(u), pt.params, torch.tensor(v),
                  torch.tensor(w)).numpy()
    close(got2, ref2, 1e-12 * np.max(np.abs(ref2)))


def test_bt_unfolding_at_exact_bt():
    """At the exact BT (x = 0, b1 = b2 = 0), matrix-free with the model's
    f32 spectral preconditioner (the JAX package's): a = s, b = -s to
    1e-10, K11 = [0, 2] to 1e-8, a finite homoclinic predictor.  With the
    preconditioner in f64 every coefficient matches the JAX package's
    dense unfolding to 1e-8 (the f32 one bounds K10 and K2 to about 3e-8
    relative, in both packages: the JAX package's matrix-free K2 is
    1.99999987 here)."""
    x0 = torch.zeros((2, N, N), dtype=DTYPE)
    par = {"b1": torch.tensor(0.0, dtype=DTYPE),
           "b2": torch.tensor(0.0, dtype=DTYPE)}
    ref = interop.unfolding_to_numpy(j_bt_unf(
        _jax_model(), jnp.zeros((2, N, N)), {"b1": 0.0, "b2": 0.0},
        j_lens("b1"), j_lens("b2")))
    pt = bt.models.bogdanov_takens_2d(Nx=N, Ny=N, device="cpu")
    h2 = (2 * (np.pi / 4) / N) ** 2
    f64 = _dct_precond(N, N, h2, h2, torch.device("cpu"), torch.float64)
    for precond in (None, f64):
        nf = bt.bt_unfolding(pt, x0, par, bt.as_lens("b1"),
                             bt.as_lens("b2"), matrix_free=True,
                             precond=precond)
        got = interop.unfolding_to_numpy(nf)
        assert abs(got["a"] - S) < 1e-10 and abs(got["b"] + S) < 1e-10
        np.testing.assert_allclose(got["K11"], [0.0, 2.0], atol=1e-8)
        hom = bt.predictor_homoclinic_bt(nf, 0.05)
        assert bool(torch.all(torch.isfinite(hom["orbit"](0.3))))
    for k in ("a", "b", "K10", "K11", "K2", "d", "e", "a1", "b1"):
        close(got[k], ref[k])


@pytest.fixture(scope="module")
def bt_curve():
    """The branch in b1 from (b1, b2) = (0.05, 0.6) to its fold at
    b1 = 0.09, then the matrix-free fold curve in b2 through the BT."""
    base = bt.models.bogdanov_takens_2d(Nx=N, Ny=N, b1=0.05, b2=0.6,
                                        device="cpu")
    ls = bt.GMRES(restart=40, maxiter=300, rtol=1e-10,
                  precond=base.spectral_precond)
    br = bt.continuation(base, bt.PALC(), bt.ContinuationPar(
        ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.0, p_max=1.5,
        max_steps=12, detect_bifurcation=0, detect_fold=True,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=25,
                                    linsolver=ls)))
    folds = [sp for sp in br.specialpoint if sp.type == "fold"]
    assert folds and abs(folds[0].param - 0.09) < 5e-3
    cp2 = bt.ContinuationPar(
        ds=-0.1, dsmax=0.2, dsmin=1e-6, p_min=-2.5, p_max=2.5, max_steps=6,
        detect_bifurcation=0, detect_fold=False,
        newton_options=bt.NewtonPar(tol=1e-7, max_iterations=30,
                                    linsolver=ls))
    brf = bt.continuation_fold(br, br.specialpoint.index(folds[0]), "b2",
                               cp2, detect_codim2_bifurcation=2,
                               jacobian_ma="minaug")
    return brf, cp2


def test_fold_curve_bt_and_normal_form(bt_curve):
    """The fold curve b1 = b2^2/4; a BT with |b2| < 5e-2, routed
    matrix-free, with a b < 0 and ||a| - s| < 0.1 s, and equal to the JAX
    package's dense form at the same point."""
    brf, _ = bt_curve
    t = interop.codim2_branch_to_numpy(brf)
    np.testing.assert_allclose(t["p1"], t["param"] ** 2 / 4, atol=1e-6)
    bts = [i for i, sp in enumerate(brf.gamma.specialpoint)
           if sp.type == "bt"]
    assert bts, list(t["sp_type"])
    ibt = min(bts, key=lambda i: abs(brf.gamma.specialpoint[i].param))
    assert abs(brf.gamma.specialpoint[ibt].param) < 5e-2
    got = interop.codim2_point_to_numpy(bt.get_normal_form_codim2(brf, ibt))
    assert got["kind"] == "BogdanovTakens"
    a, b = got["nf"]["a"], got["nf"]["b"]
    assert a * b < 0 and abs(abs(a) - S) < 0.1 * S
    _, _, x, params, _, _ = _codim2_point_context(brf, ibt)
    ref = j_bt_nf(_jax_model(), jnp.asarray(x.numpy()),
                  {k: float(v) for k, v in params.items()})
    close(a, ref.nf["a"])
    close(b, ref.nf["b"])


def test_switch_bt_to_mf_hopf(bt_curve):
    """bt -> the matrix-free Hopf curve by the Jordan-subspace probe: at
    least 5 points, least b2 below -0.2, b1 = 0 and omega^2 = -b2."""
    brf, cp2 = bt_curve
    bts = [i for i, sp in enumerate(brf.gamma.specialpoint)
           if sp.type == "bt"]
    ibt = min(bts, key=lambda i: abs(brf.gamma.specialpoint[i].param))
    brh = bt.switch_codim2(brf, ibt, cp2.replace(ds=-0.05, dsmax=0.1,
                                                 max_steps=6),
                           detect_codim2_bifurcation=0)
    assert getattr(brh.gamma.prob, "ma_mf", False)
    t = interop.codim2_branch_to_numpy(brh)
    assert len(t["param"]) >= 5 and np.min(t["param"]) < -0.2
    np.testing.assert_allclose(t["p1"], 0.0, atol=1e-6)
    np.testing.assert_allclose(t["omega"] ** 2, -t["param"], atol=1e-6)
