"""Parity of the port's BVP mesh adaptation (`BVPCollocation(adapt_mesh=
True)`: the wrapped lens, the mesh carried in the parameters and the
update hook that re-equidistributes it and re-interpolates z, z_old and
tau) with the JAX package's, on `test_bvp_cop_adapt.py`'s Bratu fold.

Tolerances: every adapted mesh, the branch's parameters and the fold
1e-8 between the packages (the same de Boor steps on roots that agree to
Newton's 1e-10); the fold within the JAX test's 8e-3 of the exact
3.513830719.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.bvp import bvp as jbvp
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.bvp import BVPCOPLS

from _bvp_wave_models import BRATU_FOLD, bratu


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adaptive_fold(pkg, xp, on):
    """`test_bvp_cop_adapt.py`'s Bratu fold with de Boor adaptation every
    5 steps (Ntst = 6, m = 3, COP Newton), stopped at the step that
    detects the fold; also returns every mesh the update hook made."""
    model = bratu(pkg, xp)
    disc = pkg.BVPCollocation(Ntst=6, m=3, adapt_mesh=True, adapt_every=5)
    X0 = pkg.discretize(model, disc, lambda t: np.array(
        [0.3 * np.sin(np.pi * t), 0.0]), 2, **on)
    lam = 1.0 if pkg is bj else torch.tensor(1.0, dtype=torch.float64)
    prob = pkg.bvp_problem(model, disc, X0, {"lam": lam}, "lam", n=2,
                           use_cop=True)
    meshes, hook = [], prob.update

    def update(it, state):
        newp = hook(it, state)
        if newp is not None:
            meshes.append(np.asarray(newp["_mesh"]))
        return newp

    cop = jbvp.BVPCOPLS() if pkg is bj else BVPCOPLS()
    nopts = pkg.NewtonPar(tol=1e-10, max_iterations=25, linsolver=cop)
    sol = pkg.newton(prob, nopts)
    assert bool(sol.converged)
    cp = pkg.ContinuationPar(ds=0.05, dsmax=0.1, dsmin=1e-6, p_min=0.1,
                             p_max=4.0, max_steps=120, detect_bifurcation=0,
                             detect_fold=True, newton_options=nopts)

    def until_fold(z, tau, step, res, **kw):
        return not any(sp.type == "fold" for sp in res.specialpoint)

    br = pkg.continuation(prob.re_make(u0=sol.u, update=update), pkg.PALC(),
                          cp, finalise_solution=until_fold)
    folds = [sp.param for sp in br.specialpoint if sp.type == "fold"]
    return br, float(folds[0]), meshes


def test_adaptive_mesh_fold_matches_jax():
    """Mesh adaptation (`adapt_mesh=True`, the wrapped lens and the
    update hook that re-interpolates z, z_old and tau): the fold and
    every adapted mesh as the JAX package's, to 1e-8; the fold within the
    JAX test's 8e-3 of the exact 3.513830719."""
    brj, fj, mj = _adaptive_fold(bj, jnp, {})
    brt, ft, mt = _adaptive_fold(bt, torch, {"device": "cpu"})
    assert len(mt) == len(mj) >= 2
    for a, b in zip(mt, mj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
    a = interop.branch_to_numpy(brj)
    b = interop.branch_to_numpy(brt)
    np.testing.assert_allclose(b["p"], a["p"], rtol=0, atol=1e-8)
    assert abs(ft - fj) < 1e-8
    assert abs(ft - BRATU_FOLD) < 8e-3
