"""The collocation and shooting periodic orbits on the card against the
CPU: the COP solves at 32 sites, a short collocation branch with
FloquetColl, and the matrix-free shooting monodromy with its J.v through
the `dia_spmv` kernel against the plain routes.  Every test needs the
card, so each is marked `cuda` and skips where there is none.  The file
imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_po_card.py

Tolerances, and why: the COP solves to 1e-10 relative of the CPU's
(pivoted LUs of the same blocks in cuSOLVER and LAPACK); the collocation
branch's (l, T) to 1e-9 relative and its multipliers to 1e-8 (Newton to
1e-7 from the same start through the same steps); the monodromy block
through `dia_spmv` to 1e-12 relative of the closed-form J.v's on the
card and of the plain DIA product's on the CPU (the same variational
flow; the kernel sums the five diagonals in another order).
"""
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.continuation.engine import ContIterable
from bifurcationkit.jl_tpu_torch.linalg.bordered import _default_dotp
from bifurcationkit.jl_tpu_torch.normal_forms.codim1 import hopf_predictor
from bifurcationkit.jl_tpu_torch.ops import DIAMatrix, dia_spmv
from bifurcationkit.jl_tpu_torch.periodic import cop
from bifurcationkit.jl_tpu_torch.periodic.orbits import (
    _po_contparams, periodic_orbit_problem)

DT = torch.float64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _hopf(sites):
    prob = bt.models.brusselator_1d(n=sites, device="cpu")
    br = bt.continuation(prob, bt.PALC(), bt.ContinuationPar(
        ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29, p_max=0.8,
        max_steps=120, detect_bifurcation=3, nev=8, n_inversion=4,
        newton_options=bt.NewtonPar(tol=1e-9)))
    idx = next(i for i, sp in enumerate(br.specialpoint)
               if sp.type == "hopf")
    return bt.hopf_normal_form(prob, br, idx)


def _po(dev, sites, hp, Ntst=30):
    prob = bt.models.brusselator_1d(n=sites, device=dev, batched=True)
    disc = bt.Collocation(Ntst=Ntst, m=4)
    pred = hopf_predictor(hp, 0.02)
    X0 = disc.generate_solution(pred["orbit"], float(pred["period"]),
                                2 * sites, device=dev)
    po = periodic_orbit_problem(
        prob, disc, X0, params=prob.set_lens_param(prob.params,
                                                   float(pred["p"])),
        use_cop=True, floquet="coll")
    return po, disc, X0


def brusselator_dia_jac_op(n):
    """The Brusselator jacobian as a five-diagonal `DIAMatrix` (offsets
    -n, -1, 0, 1, n on the stacked (u, v) state)."""
    h = 1.0 / n

    def jac_op(uv, par):
        a, b, l = par["alpha"], par["beta"], par["l"]
        c1 = par["D1"] / (l ** 2 * h ** 2)
        c2 = par["D2"] / (l ** 2 * h ** 2)
        u, v = uv[:n], uv[n:]
        zero = torch.zeros_like(u)
        idx = torch.arange(n, device=uv.device)
        first = (idx != 0).to(uv.dtype)
        last = (idx != n - 1).to(uv.dtype)
        data = torch.stack([
            torch.cat([zero, b - 2 * u * v]),
            torch.cat([c1 * first, c2 * first]),
            torch.cat([-2 * c1 - (b + 1) + 2 * u * v, -2 * c2 - u * u]),
            torch.cat([c1 * last, c2 * last]),
            torch.cat([u * u, zero]),
        ])
        return DIAMatrix(data, (-n, -1, 0, 1, n))

    return jac_op


@pytest.mark.cuda
def test_cop_solves_card_match_cpu(cuda_device):
    """`cop_solve` and the `COPBLS` single pass at 32 sites (7,745
    unknowns) on the Hopf predictor's orbit."""
    hp = _hopf(32)
    rng = np.random.default_rng(5)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        po, disc, X0 = _po(dev, 32, hp)
        blocks = po.jacobian(X0, po.params)
        N = X0.shape[0]
        R, dR, dzu = (torch.as_tensor(rng.standard_normal(N), device=dev)
                      for _ in range(3))
        x = cop.cop_solve(blocks, R)
        dX, dp, _, _ = bt.COPBLS()(blocks, dR, dzu,
                                   torch.tensor(0.7, dtype=DT, device=dev),
                                   R, torch.tensor(0.3, dtype=DT,
                                                   device=dev),
                                   0.5, 0.5, dotp=_default_dotp)
        out[dev.type] = (x.cpu().numpy(), dX.cpu().numpy(), float(dp))
        rng = np.random.default_rng(5)
    (xc, dXc, dpc), (xg, dXg, dpg) = out["cpu"], out["cuda"]
    assert np.abs(xg - xc).max() <= 1e-10 * np.abs(xc).max()
    assert np.abs(dXg - dXc).max() <= 1e-10 * np.abs(dXc).max()
    assert abs(dpg - dpc) <= 1e-10 * max(abs(dpc), 1.0)


@pytest.mark.cuda
def test_collocation_branch_card_matches_cpu(cuda_device):
    """Two PALC steps on COPLS/COPBLS with FloquetColl at 16 sites."""
    hp = _hopf(16)
    rows = {}
    for dev in (torch.device("cpu"), cuda_device):
        po, disc, X0 = _po(dev, 16, hp, Ntst=20)
        cp = _po_contparams(bt.ContinuationPar(
            ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29, p_max=0.75,
            max_steps=3, nev=6, detect_bifurcation=2, tol_stability=1e-3,
            newton_options=bt.NewtonPar(tol=1e-7, max_iterations=20,
                                        linsolver=bt.COPLS(),
                                        eigsolver=bt.FloquetColl())))
        it = ContIterable(po, bt.PALC(bls=bt.COPBLS()), cp,
                          kind="PeriodicOrbitCont")
        state = it.init_state(x0=X0)
        rec = []
        for _ in range(2):
            it.iterate(state)
            assert state.converged
            rec.append((state.p, float(state.z.u[-1]),
                        np.exp(state.eigvals)))
        rows[dev.type] = rec
    for (pc, Tc, mc), (pg, Tg, mg) in zip(rows["cpu"], rows["cuda"]):
        assert abs(pg - pc) <= 1e-9 * abs(pc)
        assert abs(Tg - Tc) <= 1e-9 * abs(Tc)
        assert np.abs(mg - mc).max() <= 1e-8


@pytest.mark.cuda
def test_mf_shooting_monodromy_through_dia_spmv(cuda_device):
    """The variational monodromy block with J.v by the DIA kernel against
    the closed-form J.v on the card and the plain DIA product on the CPU,
    and the kernel launched once per stage of each segment."""
    sites, M, steps = 12, 3, 20
    rng = np.random.default_rng(8)
    X = None
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        base = bt.models.brusselator_1d(n=sites, l=0.5, device=dev)
        if X is None:
            X = (base.u0.cpu().numpy()[None]
                 * (1 + 0.05 * rng.standard_normal((M, 2 * sites))))
            V = rng.standard_normal((6, 2 * sites))
        disc = bt.Shooting(M=M, steps_per_segment=steps)
        Xt = disc.pack(torch.as_tensor(X, device=dev), 2.5)
        dia = base.re_make(jac_op=brusselator_dia_jac_op(sites))
        po = periodic_orbit_problem(dia, disc, Xt)
        Vt = torch.as_tensor(V, device=dev)
        before = dia_spmv.launches
        blk = disc.monodromy_operator(dia, Xt, po.params).block(Vt)
        launches = dia_spmv.launches - before
        closed = bt.models.brusselator_1d(n=sites, l=0.5, device=dev,
                                          batched=True)
        ref = disc.monodromy_operator(closed, Xt, po.params).block(Vt)
        out[dev.type] = (blk.cpu().numpy(), ref.cpu().numpy(), launches)
    blk_c, _, _ = out["cpu"]
    blk_g, ref_g, launches = out["cuda"]
    scale = np.abs(blk_c).max()
    assert np.abs(blk_g - ref_g).max() <= 1e-12 * scale
    assert np.abs(blk_g - blk_c).max() <= 1e-12 * scale
    assert launches == M * steps * 6          # dopri5: 6 stages a step
