"""The cGL2d periodic-orbit branch from its Hopf point, in the port and
in the JAX package (the bench's `po_cgl` leg, `bench.py:620-700`, at 9x5
with M = 11 slices and 2 steps): `continuation_hopf_po` from the exact
Hopf point (r* = -lambda_1(Delta), omega = nu) with the matrix-free Hopf
normal form, `Trapeze`, the f32 space-time spectral preconditioner,
Floquet by `FloquetQaDMF(SubspaceEig)` over the matrix-free monodromy,
and the phase-section update `continuation()` runs after every step.
The JAX side continues the same orbit guess with `continuation_po` for one
step, without Floquet sweeps (each step costs it a compile on the CPU);
the port's multipliers there are held against the JAX package's dense
monodromy (`test_torch_periodic_cgl.py` holds `FloquetQaDMF(SubspaceEig)`
itself against the JAX package's).

Tolerances, and why: (r, T) at the points both packages computed to
1e-9 relative (Newton to 1e-7 on the same iterates; the f32
preconditioner's rounding moves the GMRES solutions by less); the branch's leading Floquet multipliers to
1e-5 of the dense monodromy's, the JAX package's and the port's (the f32
slice preconditioner bounds the inner solves, rtol 1e-6); the trivial
multiplier within 1e-3 of 1 and no unstable multiplier (the orbit born at
a supercritical Hopf point is stable).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.periodic.orbits import (
    continuation_po as jcontinuation_po)
from bifurcationkit.jl_tpu.periodic.trapezoid import (
    slice_spectral_precond as jslice)
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.periodic.trapezoid import (
    slice_spectral_precond as tslice)

DT = torch.float64
NX, NY, M, STEPS, NEV = 9, 5, 11, 2, 4
JAX_STEPS = 1       # each step of the JAX package's costs a compile here
N_VF = 2 * NX * NY


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r_star():
    hx, hy = 2 * np.pi / NX, np.pi / NY
    return -(2 * (np.cos(np.pi / (NX + 1)) - 1) / hx ** 2
             + 2 * (np.cos(np.pi / (NY + 1)) - 1) / hy ** 2)


def _config(pkg, base, disc, T0, r0, detect, kw):
    blocks, to_m, from_m = base.po_spectral_data(r0)
    pre = disc.spectral_precond(N_VF, blocks, to_m, from_m, T0, **kw)
    slice_pre = (jslice if pkg is bj else tslice)(
        blocks, to_m, from_m, T0 / (M - 1) / 2.0, **kw)
    mono_ls = pkg.GMRES(restart=20, maxiter=80, rtol=1e-6, precond=slice_pre)
    cp = pkg.ContinuationPar(
        ds=0.005, dsmax=0.02, dsmin=1e-8, p_min=0.0, p_max=2.5,
        max_steps=STEPS, nev=NEV, detect_bifurcation=detect,
        tol_stability=1e-3, save_eigenvectors=True, save_sol_every_step=1,
        newton_options=pkg.NewtonPar(
            tol=1e-7, max_iterations=20,
            linsolver=pkg.GMRES(restart=30, maxiter=300, rtol=1e-9,
                                precond=pre),
            eigsolver=pkg.FloquetQaDMF(eigsolver=pkg.SubspaceEig(
                sweeps=2, krylov_blocks=3, extra=4, tol=1e-6))))
    return cp, mono_ls


def test_cgl_po_branch_matches_jax():
    r0 = _r_star()
    base = bt.models.cgl2d(Nx=NX, Ny=NY, r=0.1, c3=1.0, device="cpu")
    omega = float(base.params["nu"])
    x0 = torch.zeros((2, NX, NY), dtype=DT)
    # the preconditioners freeze the period at 2 pi / omega (the
    # predictor's period differs from it by 0.2 %)
    T0 = 2 * np.pi / omega
    disc = bt.Trapeze(M=M)
    cp, mono_ls = _config(bt, base, disc, T0, r0, 2, {"device": "cpu"})
    # the Hopf point as a one-point branch (ref continuation(br, ind_hopf))
    sp = bt.SpecialPoint(type="hopf", param=r0, x=x0, ind_ev=1,
                         eigenvals=np.array([1j * omega]))
    br = bt.continuation_hopf_po(
        bt.ContResult(prob=base, specialpoint=[sp]), 0, cp, disc=disc,
        delta_p=0.02, nf_kwargs={"matrix_free": True},
        floquet_linsolver=mono_ls)
    assert br.bp.subtype == "SuperCritical"
    port = interop.po_branch_to_numpy(br)
    assert len(port["param"]) == STEPS + 1
    assert np.all(np.asarray(br.gamma["itnewton"][1:]) > 0)

    # the JAX package from the same orbit guess and parameters (the PO
    # problem's u0 and its vector field's parameters), for its first step
    po_t = br.gamma.prob
    X0 = po_t.u0.numpy()
    p0 = float(po_t.prob_vf.get_lens_param(po_t.params["_inner"]))
    jbase = bj.models.cgl2d(Nx=NX, Ny=NY, r=0.1, c3=1.0)
    jdisc = bj.Trapeze(M=M)
    jcp, jmono = _config(bj, jbase, jdisc, T0, r0, 0, {})
    jbr = jcontinuation_po(jbase, jdisc, jnp.asarray(X0),
                           jcp.replace(max_steps=JAX_STEPS),
                           params=jbase.set_lens_param(jbase.params, p0))
    ref = interop.po_branch_to_numpy(jbr)
    k = JAX_STEPS + 1
    assert len(ref["param"]) == k
    np.testing.assert_allclose(port["param"][:k], ref["param"], rtol=1e-9)
    np.testing.assert_allclose(port["period"][:k], ref["period"], rtol=1e-9)
    assert np.all(np.abs(port["period"] / T0 - 1) < 0.05)

    # the branch's Floquet multipliers at JAX's last point against the
    # JAX package's dense monodromy there, and against the port's
    X_j, po_j = jnp.asarray(jbr.gamma.sol[-1]["x"]), jbr.gamma.prob
    par_j = po_j.set_lens_param(po_j.params, float(ref["param"][-1]))
    dense_j = np.linalg.eigvals(np.asarray(jax.jit(
        lambda X, par: jdisc.monodromy(po_j.prob_vf, X, par))(X_j, par_j)))
    dense_t = bt.floquet_multipliers(
        disc, po_t.prob_vf, br.gamma.sol[k - 1]["x"],
        po_t.set_lens_param(po_t.params, float(port["param"][k - 1])))
    mu_b = np.exp(port["floquet"][k - 1])
    for mu in mu_b[:2]:
        assert np.min(np.abs(dense_j - mu)) < 1e-5
        assert np.min(np.abs(dense_t - mu)) < 1e-5
    assert abs(mu_b[0] - 1) < 1e-3
    assert np.all(port["n_unstable"] == 0)
    traj, T, p = bt.orbit_from_branch(br)
    np.testing.assert_allclose(
        traj, br.gamma.sol[-1]["x"][:-1].reshape(M, N_VF).numpy())
    assert (T, p) == (port["period"][-1], port["param"][-1])
