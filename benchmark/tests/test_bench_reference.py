"""The plain references against the port at tiny sizes on the CPU, and a
whole run of each cell there (set-up, window, comparison) that comes out
correct."""
import numpy as np
import pytest
import torch

import _tiny
from harness import registry, runner

import bifurcationkit.jl_tpu_torch as bk
from bifurcationkit.jl_tpu_torch import models
from bifurcationkit.jl_tpu_torch.ops.sh_jv import sh_jv_plain

SPEC = registry.load_spec()
SH = registry.Cell(SPEC, "sh512.detect")
PO = registry.Cell(SPEC, "bruss_po.floquet")


def _sh():
    cfg = dict(SH.config(), **_tiny.SH_TINY)
    prob = models.swift_hohenberg_periodic_2d(
        Nx=cfg["Nx"], Ny=cfg["Ny"], lx=cfg["lx"], ly=cfg["ly"], device="cpu")
    return cfg, prob, SH.reference()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_sh_residual_and_jv_match_the_port():
    cfg, prob, ref = _sh()
    g = torch.Generator().manual_seed(0)
    u = torch.randn(32, 32, generator=g, dtype=torch.float64)
    par = dict(prob.params, l=torch.tensor(-0.2, dtype=torch.float64))
    assert _rel(ref.residual(u, -0.2, cfg), prob.F(u, par)) <= 1e-14
    v = torch.randn(3, 32, 32, generator=g, dtype=torch.float64)
    ix2, iy2 = ref.grid(cfg)
    scal = torch.tensor([-0.2, cfg["nu"], ix2, iy2], dtype=torch.float64)
    got = sh_jv_plain(u, v, scal, closure="periodic")
    assert _rel(ref.jv(u, -0.2, v, cfg), got) <= 1e-14


@pytest.mark.parametrize("N", [16, 24])
def test_sh_rightmost_eigenvalues_match_a_dense_eigh(N):
    cfg = dict(SH.config(), Nx=N, Ny=N)
    ref = SH.reference()
    u = 0.5 * torch.randn(N, N, generator=torch.Generator().manual_seed(N),
                          dtype=torch.float64)
    E = torch.eye(N * N, dtype=torch.float64).reshape(-1, N, N)
    J = ref.jv(u, -0.2, E, cfg).reshape(N * N, N * N)
    assert torch.equal(J, J.T)
    want = torch.linalg.eigvalsh(J).flip(0)[:11]
    vals, X, rn = ref.top_eigs(u, -0.2, cfg, 11)
    assert rn <= 1e-7 and float((vals - want).abs().max()) <= 1e-10
    # warm started from its own vectors at a nearby state
    vals2, _, rn2 = ref.top_eigs(u + 1e-3, -0.2, cfg, 11, X0=X)
    want2 = torch.linalg.eigvalsh(
        ref.jv(u + 1e-3, -0.2, E, cfg).reshape(N * N, N * N)).flip(0)[:11]
    assert rn2 <= 1e-7 and float((vals2 - want2).abs().max()) <= 1e-10


def test_sh_count_bounds_follow_interlacing():
    ref = SH.reference()
    m, tol = ref.EIG_MARGIN, 1e-10
    vals = np.array([2 * m, m / 2, 1e-13, -1e-13, -m])
    # two eigenvalues above tol, one of them above tol + EIG_MARGIN; the
    # translation mode at 1e-13 may round either way
    assert ref.count_bounds(vals, 5, tol) == (1, 4)
    assert ref.count_bounds(vals, 1, tol) == (1, 1)
    assert ref.count_bounds(-np.abs(vals) - 1, 5, tol) == (0, 0)


def test_sh_translation_modes_are_found():
    cfg = dict(SH.config(), Nx=32, Ny=24)
    ref = SH.reference()
    x = torch.arange(32, dtype=torch.float64)[:, None] * 2 * np.pi / 32
    y = torch.arange(24, dtype=torch.float64)[None, :] * 2 * np.pi / 24
    u = torch.cos(3 * x) + torch.cos(2 * y) * torch.sin(x)
    dx = -3 * torch.sin(3 * x) + torch.cos(2 * y) * torch.cos(x)
    dy = -2 * torch.sin(2 * y) * torch.sin(x)
    g = torch.Generator().manual_seed(3)
    X = torch.stack([dx, dy, torch.randn(32, 24, generator=g,
                                          dtype=torch.float64), u])
    X = X.reshape(4, -1)
    X = X / X.norm(dim=1, keepdim=True)
    assert ref.neutral(u, cfg, X).tolist() == [True, True, False, False]
    assert not ref.neutral(torch.zeros_like(u), cfg, X).any()


def test_bruss_pieces_match_the_port():
    cfg = dict(PO.config(), sites=8)
    ref = PO.reference()
    prob = models.brusselator_1d(n=8, l=0.6, device="cpu", batched=True)
    x = 1 + torch.rand(16, dtype=torch.float64, generator=torch.Generator()
                       .manual_seed(2))
    assert torch.allclose(ref.vector_field(x, 0.6, cfg),
                          prob.F(x, prob.params), rtol=0, atol=1e-12)
    assert torch.allclose(ref.jacobian(x, 0.6, cfg),
                          prob.jacobian(x, prob.params), rtol=0, atol=1e-12)
    L, dL, wg = ref.legendre(4)
    from bifurcationkit.jl_tpu_torch.periodic.collocation import (
        legendre_matrices)
    Lp, dLp, _, wgp = legendre_matrices(4)
    assert np.array_equal(L, Lp) and np.array_equal(dL, dLp) \
        and np.array_equal(wg, wgp)


def test_bruss_orbit_residual_and_monodromy_match_the_port():
    cfg = dict(PO.config(), sites=8, Ntst=6)
    ref = PO.reference()
    prob = models.brusselator_1d(n=8, l=0.55, device="cpu", batched=True)
    disc = bk.Collocation(Ntst=6, m=4)
    g = torch.Generator().manual_seed(4)
    nodes = 1 + 0.1 * torch.rand(6 * 4 + 1, 16, dtype=torch.float64,
                                 generator=g)
    X = disc.pack(nodes, 3.1)
    prev = disc.pack(nodes + 0.01, 3.0)
    from bifurcationkit.jl_tpu_torch.periodic.orbits import (
        periodic_orbit_problem)
    po = periodic_orbit_problem(prob, disc, prev, params=prob.params)
    par = po.params
    got = po.F(X, par)
    want = ref.Orbit(X, 0.55, cfg).residual(ref.Orbit(prev, 0.55, cfg))
    assert torch.allclose(got, want, rtol=0, atol=1e-11)
    M = disc.monodromy(po.prob_vf, X, par)
    assert torch.allclose(ref.Orbit(X, 0.55, cfg).monodromy(), M, rtol=0,
                          atol=1e-10)


@pytest.mark.parametrize("cell,over", [
    ("sh512.detect", _tiny.SH_TINY),
    ("bruss_po.floquet", None)])
def test_a_tiny_run_is_correct(cell, over):
    reg = registry.Cell(SPEC, cell)
    over = over or _tiny.bruss_tiny(8)
    result, extra = runner.measure(reg, 2 ** 31 + 12345, 60.0, False,
                                   device="cpu", config_over=over,
                                   max_points=14)
    assert result["correct"], extra["numbers"]
    assert result["failed"] == 0 and result["attempted"] == 14
    assert set(result["metrics"]) == {m["name"] for m in reg.metrics(False)}
    for c in extra["numbers"]:
        assert c["value"] <= c["limit"], c
