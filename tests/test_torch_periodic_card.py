"""The periodic-orbit slice on the card against the CPU: the batched GMRES
(`GMRES.solve_block`), `SubspaceEig` over a monodromy-like operator and a
small cGL2d trapezoid periodic-orbit branch with `FloquetQaDMF` over the
matrix-free monodromy.  Every test needs the card, so each is marked
`cuda` and skips where there is none.  The file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_periodic_card.py

Tolerances, and why: the batched GMRES columns to 1e-10 relative of the
CPU's with equal matvec counts (both solve to rtol 1e-11; cuBLAS sums in
another order); `SubspaceEig`'s Ritz values from the same start block to
1e-10; the cGL2d branch's (r, T) to 1e-7 relative and its Floquet
multipliers to 1e-5 (Newton to 1e-7; the f32 preconditioners round in
another order on the card).
"""
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.normal_forms.codim1 import (
    hopf_normal_form_point, hopf_predictor)
from bifurcationkit.jl_tpu_torch.periodic.trapezoid import (
    slice_spectral_precond)

DT = torch.float64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gmres_block_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(2)
    n, k = 200, 12
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    B = rng.standard_normal((k, n))
    B[1] *= 1e-3
    B[3] = 0.0
    d = 1.0 / np.diag(A)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        At, Bt, dt_ = (torch.as_tensor(a, dtype=DT, device=dev)
                       for a in (A, B, d))
        gm = bt.GMRES(restart=10, maxiter=80, rtol=1e-11,
                      precond=lambda v, dt_=dt_: v * dt_)
        X, cv, its = gm.solve_block(lambda V, At=At: V @ At.T, Bt)
        out[dev.type] = (X.cpu().numpy(), cv, its)
    Xc, cvc, itc = out["cpu"]
    Xg, cvg, itg = out["cuda"]
    assert np.array_equal(itc, itg) and np.array_equal(cvc, cvg)
    assert np.abs(Xg - Xc).max() <= 1e-10 * np.abs(Xc).max()


@pytest.mark.cuda
def test_subspace_eig_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(5)
    n = 300
    D = np.diag(np.concatenate([[1.0, 0.97, 0.6],
                                rng.uniform(0.001, 0.1, n - 3)]))
    V = rng.standard_normal((n, n))
    A = np.linalg.solve(V, D @ V)
    v0 = rng.standard_normal((n, 8))
    vals = {}
    for dev in (torch.device("cpu"), cuda_device):
        At = torch.as_tensor(A, dtype=DT, device=dev)
        op = bt.FlatOperator(lambda x, At=At: At @ x, n, DT, dev,
                             block_op=lambda X, At=At: X @ At.T)
        w, _, _, _ = bt.SubspaceEig(sweeps=2, krylov_blocks=3, extra=4,
                                    tol=1e-6)(op, 4, v0=torch.as_tensor(
                                        v0, dtype=DT, device=dev))
        vals[dev.type] = w.cpu().numpy()
    np.testing.assert_allclose(vals["cuda"], vals["cpu"], atol=1e-10)


def _cgl_branch(device, Nx=9, Ny=5, M=11, steps=2):
    hx, hy = 2 * np.pi / Nx, np.pi / Ny
    r0 = -(2 * (np.cos(np.pi / (Nx + 1)) - 1) / hx ** 2
           + 2 * (np.cos(np.pi / (Ny + 1)) - 1) / hy ** 2)
    n = 2 * Nx * Ny
    base = bt.models.cgl2d(Nx=Nx, Ny=Ny, r=0.1, c3=1.0, device=device)
    omega = float(base.params["nu"])
    hp = hopf_normal_form_point(
        base, torch.zeros((2, Nx, Ny), dtype=DT, device=device), r0, omega,
        matrix_free=True)
    pred = hopf_predictor(hp, 0.02)
    T0 = float(pred["period"])
    disc = bt.Trapeze(M=M)
    X0 = disc.generate_solution(pred["orbit"], T0, n)
    blocks, to_m, from_m = base.po_spectral_data(r0)
    pre = disc.spectral_precond(n, blocks, to_m, from_m, T0, device=device)
    mono = bt.GMRES(restart=20, maxiter=80, rtol=1e-6,
                    precond=slice_spectral_precond(
                        blocks, to_m, from_m, T0 / (M - 1) / 2.0,
                        device=device))
    cp = bt.ContinuationPar(
        ds=0.005, dsmax=0.02, dsmin=1e-8, p_min=0.0, p_max=2.5,
        max_steps=steps, nev=4, detect_bifurcation=2, tol_stability=1e-3,
        save_eigenvectors=False,
        newton_options=bt.NewtonPar(
            tol=1e-7, max_iterations=20,
            linsolver=bt.GMRES(restart=30, maxiter=300, rtol=1e-9,
                               precond=pre),
            eigsolver=bt.FloquetQaDMF(eigsolver=bt.SubspaceEig(
                sweeps=2, krylov_blocks=3, extra=4, tol=1e-6))))
    br = bt.continuation_po(
        base, disc, X0, cp, floquet_linsolver=mono,
        params=base.set_lens_param(base.params, float(pred["p"])))
    return interop.po_branch_to_numpy(br)


@pytest.mark.cuda
def test_cgl_po_branch_card_matches_cpu(cuda_device):
    cpu = _cgl_branch(torch.device("cpu"))
    card = _cgl_branch(cuda_device)
    assert len(card["param"]) == len(cpu["param"]) == 3
    np.testing.assert_allclose(card["param"], cpu["param"], rtol=1e-7)
    np.testing.assert_allclose(card["period"], cpu["period"], rtol=1e-7)
    for a, b in zip(card["floquet"], cpu["floquet"]):
        np.testing.assert_allclose(np.exp(a)[:2], np.exp(b)[:2], atol=1e-5)
    assert np.array_equal(card["n_unstable"], cpu["n_unstable"])
