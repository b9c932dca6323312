"""The slice as a whole: the SH2d-fronts PALC continuation with stability
sweeps, bifurcation bisection and fold detection, in the flagship's
accelerator configuration (f32 Krylov + f64 iterative refinement, f32
LOBPCG + f64 refine), run by the JAX package and by the port from the
same numpy `u0` / `params`, compared branch row by branch row.

The grid is cut to 60x40 with the domain cut alongside, so the mesh width
stays the flagship's (the 151x100 fronts are not resolved on a coarser
mesh of the full domain: Newton stalls there).  On this grid the branch
meets two branch points within its first two steps.

Tolerances, and why:
* `p` per step: 1e-8 absolute — both correctors stop at residual 1e-7 on
  iterates that agree to the linear solves' 1e-10 relative accuracy;
* `n_unstable` per step: equal — counts of eigenvalues > 1e-10 from
  eigenvalues that agree to ~1e-5, none of them within that of zero;
* special points: equal types, `p` within 1e-6 — the bisection replays the
  same corrector, so it visits the same parameters to the `p` tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels

NX, NY = 60, 40
DOMAIN = dict(lx=8 * np.pi * NX / 151, ly=4 * np.pi / np.sqrt(3) * NY / 100)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(pkg, prob, f32):
    """The flagship configuration (bench.py's accelerator branch)."""
    ls = pkg.IterativeRefinement(
        inner=pkg.GMRES(restart=40, maxiter=160, rtol=1e-5,
                        precond=prob.spectral_precond),
        refinements=4, rtol=1e-10)
    eig = pkg.LOBPCGEig(maxiter=30, tol=3e-3, extra=8,
                        precond=lambda v: prob.spectral_precond(v, shift=1.0),
                        compute_dtype=f32)
    return pkg.ContinuationPar(
        ds=-0.005, dsmax=0.02, dsmin=1e-6, p_min=-0.8, p_max=0.2,
        max_steps=2, nev=12, detect_bifurcation=3, detect_fold=True,
        save_eigenvectors=False,
        newton_options=pkg.NewtonPar(tol=1e-7, max_iterations=15,
                                     linsolver=ls, eigsolver=eig))


def test_branch_matches_jax_step_for_step():
    pj = jmodels.swift_hohenberg_2d(Nx=NX, Ny=NY, **DOMAIN)
    br_j = bj.continuation(pj, bj.PALC(), _config(bj, pj, jnp.float32))

    pt = tmodels.swift_hohenberg_2d(Nx=NX, Ny=NY, device="cpu", **DOMAIN)
    u0, par0 = interop.state_from_numpy(np.asarray(pj.u0), pj.params, "cpu")
    pt = pt.re_make(u0=u0, params=par0)
    br_t = bt.continuation(pt, bt.PALC(), _config(bt, pt, torch.float32))

    j, t = interop.branch_to_numpy(br_j), interop.branch_to_numpy(br_t)
    assert len(t["p"]) == len(j["p"]) == 3
    np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(t["n_unstable"], j["n_unstable"])
    np.testing.assert_array_equal(t["stable"], j["stable"])
    assert list(t["sp_type"]) == list(j["sp_type"])
    assert "bp" in list(t["sp_type"])
    np.testing.assert_allclose(t["sp_p"], j["sp_p"], rtol=0, atol=1e-6)
    # the branch rows carry the model's record and finite eigenvalues
    assert np.all(np.isfinite(br_t["n8"])) and len(br_t.eig) == 3
    assert all(np.all(np.isfinite(e["eigenvals"])) for e in br_t.eig)
