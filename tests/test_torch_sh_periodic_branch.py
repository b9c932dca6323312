"""The periodic SH2d slice as a whole: PALC with per-step LOBPCG
stability detection in bench.py's `cuda_analog` configuration at test
scale (f32 Krylov + f64 iterative refinement, f32 LOBPCG + f64 refine;
every J.v of the port through `sh_jv`'s periodic closure), run by the JAX
package and by the port from the same Newton point, compared step by
step.  32x32 grid on one hexagon cell (see `test_torch_sh_periodic.py`).

Tolerances: `p` per step 1e-8 absolute (both correctors stop at 1e-7 on
iterates that agree to the linear solves' accuracy); the stability
counts equal; the last spectrum's leading eigenvalues 1e-6 (LOBPCG's f64
Rayleigh-Ritz refine of the same operator; the two translation modes,
near 0, to 1e-9 absolute).
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

CELL = dict(lx=2 * np.pi, ly=2 * np.pi / np.sqrt(3))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _branch(pkg, prob, u0, f32):
    ls = pkg.IterativeRefinement(
        inner=pkg.GMRES(restart=40, maxiter=160, rtol=1e-5,
                        precond=prob.spectral_precond),
        refinements=4, rtol=1e-9)
    eig = pkg.LOBPCGEig(maxiter=30, tol=3e-3, extra=8,
                        precond=lambda v: prob.spectral_precond(v, shift=1.0),
                        compute_dtype=f32)
    cp = pkg.ContinuationPar(
        ds=-0.005, dsmax=0.007, dsmin=1e-6, p_min=-1.0, p_max=0.005,
        max_steps=3, nev=11, detect_bifurcation=3, save_eigenvectors=False,
        newton_options=pkg.NewtonPar(tol=1e-7, max_iterations=15,
                                     linsolver=ls, eigsolver=eig))
    return pkg.continuation(prob.re_make(u0=u0), pkg.PALC(), cp)


def test_palc_with_lobpcg_detection_matches_jax():
    """Both packages start from the port's Newton root (the roots agree to
    1e-9, `test_torch_sh_periodic.py::test_newton_matches_jax`)."""
    tp = tmodels.swift_hohenberg_periodic_2d(Nx=32, Ny=32, device="cpu",
                                             **CELL)
    root = bt.newton(tp, bt.NewtonPar(
        tol=1e-10, max_iterations=30, linsolver=bt.GMRES(
            restart=40, maxiter=300, rtol=1e-11,
            precond=tp.spectral_precond)))
    assert root.converged
    br_j = _branch(bj, jmodels.swift_hohenberg_periodic_2d(
        Nx=32, Ny=32, **CELL), jnp.asarray(root.u.numpy()), np.float32)
    br_t = _branch(bt, tp, root.u, torch.float32)
    a, b = interop.branch_to_numpy(br_j), interop.branch_to_numpy(br_t)
    assert len(b["p"]) == len(a["p"]) == 4
    np.testing.assert_allclose(b["p"], a["p"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(b["n_unstable"], a["n_unstable"])
    np.testing.assert_array_equal(b["sp_type"], a["sp_type"])
    vj = np.sort(np.asarray(br_j.eig[-1]["eigenvals"]).real)[::-1]
    vt = np.sort(np.asarray(br_t.eig[-1]["eigenvals"]).real)[::-1]
    np.testing.assert_allclose(vt[:2], vj[:2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(vt[2:8], vj[2:8], rtol=1e-6)
