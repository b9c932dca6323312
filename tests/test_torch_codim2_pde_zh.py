"""The matrix-free codim-2 flow on the constructed fold-Hopf PDE at a cut
size (10 x 10, 300 unknowns; the JAX test runs 32 x 32): the branch to its
fold, the matrix-free fold curve in `a` with the zero-Hopf event,
`get_normal_form_codim2` at the zero-Hopf point (routed matrix-free), and
`switch_codim2` to the matrix-free Hopf curve (mirrors
`test_minaug_mf.py:471-534`).  Every plain J.v applies the Neumann
Laplacian through `dia_spmv` (its plain version on the CPU).

Tolerances, and why:
* the model's J.v (`jac_op`, the DIA Laplacian) and J^T.v against the
  JAX package's jvp and vjp of F, and its d2F against the JAX jet, to
  1e-12 relative;
* exact geometry: the fold curve p1 = 0 to 1e-8 (the JAX test asks
  |p1| < 5e-2), a zero-Hopf point with |a| < 0.12, and there
  G200 = 2/N, G110 = alpha/N, G011 = 0 (the constant-mode reduction) to
  1e-8 after sign alignment; the switched Hopf curve p1 = -a^2 to 1e-8
  and omega = 1 to 1e-9;
* the zero-Hopf form against the JAX package's dense form at the same
  point to 1e-8 * max(|c|, 1), its G's sign-aligned by
  sign(<q0, q0_ref>) (they flip together with q0), and omega to 1e-9.

The branch starts on the upper branch s = +sqrt(-p1) and crosses its fold
at p1 = 0, so the fold point (the first state past the fold) has s < 0
and the fold curve is the constant mode's, p1 = 0.  From the JAX test's
start (the lower branch, p1 = -0.25) the first state past the fold has
s > 0, where the mode-1 s-eigenvalue mu_1 + 2s is the one nearest zero:
both packages then follow the mode-1 fold curve p1 = -(mu_1/2)^2
(-0.0154 here, -0.0156 at 32 x 32), which the JAX test's |p1| < 5e-2
does not tell apart, and whose zero-Hopf labels are not exact points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu.codim2.zh_hh import zh_normal_form as j_zh
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.codim2.unfolding import (
    _codim2_point_context)
from tests._codim2_models import close, one_thread

N = 10


def test_jac_op_and_forms_match_jax():
    """J.v (one batched DIA launch for the 3 fields), a batch of two J.v,
    J^T.v and d2F against the JAX package's jvp, vjp and jet of F."""
    rng = np.random.default_rng(5)
    pj = jmodels.fold_hopf_interaction_2d(Nx=N, Ny=N - 2)
    pt = bt.models.fold_hopf_interaction_2d(Nx=N, Ny=N - 2, device="cpu")
    u, v, w = (rng.standard_normal((3, N, N - 2)) for _ in range(3))
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


@pytest.fixture(scope="module")
def zh_flow():
    """The branch in p1 from the upper branch at p1 = -0.05 to its fold,
    the matrix-free fold curve in a from a = -0.2 (3 steps, the inner
    spectrum by a 128-wide Arnoldi as the JAX test: the default width
    carries about 0.2 of real-part bias here) with its zero-Hopf
    point."""
    base = bt.models.fold_hopf_interaction_2d(Nx=N, Ny=N, p1=-0.05, a=-0.2,
                                              device="cpu")
    u0 = base.u0.clone()
    u0[0] = np.sqrt(0.05)
    base = base.re_make(u0=u0)
    ls = bt.GMRES(restart=40, maxiter=300, rtol=1e-10,
                  precond=base.spectral_precond)
    br = bt.continuation(base, bt.PALC(), bt.ContinuationPar(
        ds=0.02, dsmax=0.03, dsmin=1e-6, p_min=-0.3, p_max=0.3,
        max_steps=10, detect_bifurcation=0, detect_fold=True,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=25,
                                    linsolver=ls)))
    folds = [sp for sp in br.specialpoint if sp.type == "fold"]
    assert folds and abs(folds[0].param) < 2e-2
    cp2 = bt.ContinuationPar(
        ds=0.05, dsmax=0.1, dsmin=1e-6, p_min=-0.8, p_max=0.8, max_steps=3,
        detect_bifurcation=2, nev=6, n_inversion=4,
        newton_options=bt.NewtonPar(
            tol=1e-9, max_iterations=25, linsolver=ls,
            eigsolver=bt.ArnoldiEig(which="LR", krylov_dim=128, restarts=8,
                                    tol=1e-6)))
    brf = bt.continuation_fold(br, br.specialpoint.index(folds[0]), "a",
                               cp2, detect_codim2_bifurcation=2,
                               jacobian_ma="minaug")
    return base, ls, brf


def test_fold_curve_zh_and_normal_form(zh_flow):
    """The fold curve p1 = 0; a zero-Hopf point with |a| < 0.12; its
    normal form is routed matrix-free, exact, and matches the JAX
    package's dense form at the same point."""
    base, _, brf = zh_flow
    t = interop.codim2_branch_to_numpy(brf)
    np.testing.assert_allclose(t["p1"], 0.0, rtol=0, atol=1e-8)
    zhs = [i for i, sp in enumerate(brf.gamma.specialpoint)
           if sp.type == "zh"]
    assert zhs, list(t["sp_type"])
    izh = min(zhs, key=lambda i: abs(brf.gamma.specialpoint[i].param))
    assert abs(brf.gamma.specialpoint[izh].param) < 0.12
    pt = bt.get_normal_form_codim2(brf, izh)
    got = interop.codim2_point_to_numpy(pt)
    assert got["kind"] == "ZeroHopf"
    _, _, x, params, _, _ = _codim2_point_context(brf, izh)
    pj = jmodels.fold_hopf_interaction_2d(Nx=N, Ny=N)
    ref = j_zh(pj.re_make(F=jax.jit(pj.F)), jnp.asarray(x.numpy()),
               {k: float(v) for k, v in params.items()})
    q0r = np.asarray(ref.zeta[0])
    s = float(np.sign(np.dot(got["zeta"][:, 0].real, q0r)))
    for k in ("G200", "G011", "G110"):
        close(s * got["nf"][k], ref.nf[k])
    for k, g in (("G200", 2.0 / N), ("G011", 0.0), ("G110", 1.0 / N)):
        close(abs(got["nf"][k]), g)
    close(got["omega"], ref.omega, 1e-9)


def test_switch_zh_to_mf_hopf(zh_flow):
    """switch_codim2 hands the matrix-free curve to switch_codim2_mf: the
    switched Hopf curve is matrix-free and exact, p1 = -a^2 and
    omega = nu = 1."""
    base, ls, brf = zh_flow
    zhs = [i for i, sp in enumerate(brf.gamma.specialpoint)
           if sp.type == "zh"]
    izh = min(zhs, key=lambda i: abs(brf.gamma.specialpoint[i].param))
    cp3 = bt.ContinuationPar(
        ds=0.05, dsmax=0.1, dsmin=1e-6, p_min=-0.8, p_max=0.8, max_steps=4,
        detect_bifurcation=0, detect_fold=False,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=25,
                                    linsolver=ls))
    brh = bt.switch_codim2(brf, izh, cp3, detect_codim2_bifurcation=0)
    assert getattr(brh.gamma.prob, "ma_mf", False)
    t = interop.codim2_branch_to_numpy(brh)
    assert len(t["param"]) >= 4
    np.testing.assert_allclose(t["p1"] + t["param"] ** 2, 0.0, atol=1e-8)
    np.testing.assert_allclose(t["omega"], 1.0, atol=1e-9)
