"""The PO codim-2 slice on the card: the BVAM model's DIA J.v, the
Floquet-closed sigma solve, the Iooss PD core and the functional MA's
sigma gradient.  Every test needs the card, so each is marked `cuda` and
skips where there is none (decided in a fixture).  The file imports no
JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_po_codim2_card.py

Tolerances, and why:
* the BVAM J.v through `dia_spmv` (both fields of every state in one
  launch) against `dia_spmv_plain` on the card and `torch.func.jvp` of F
  at N = 100, to 1e-12 relative to the largest entry;
* `cop_bc_sigma` (real PD and complex NS cases) and the Iooss PD core on
  the card against the CPU from the same inputs, to 1e-10 (the same
  factorizations; cuSOLVER's rounding differs) — the Iooss core on a
  smooth periodic state of the N = 10 model on Collocation(10, 4), with
  the same null-vector borders on both;
* the closed-form sigma gradient of the functional PD problem (through
  the kernel's blocks) against `po_sigma_autodiff` (torch.func through
  the plain jacobian of F) to 1e-8 relative, and that route launches no
  `dia_spmv`: no derivative ever reaches the kernel.
"""
import numpy as np
import pytest
import torch
from torch.func import jvp

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.ops import dia_spmv
from bifurcationkit.jl_tpu_torch.ops.dia_spmv import dia_spmv_plain
from bifurcationkit.jl_tpu_torch.periodic import codim2 as pc2
from bifurcationkit.jl_tpu_torch.periodic import cop as tc
from bifurcationkit.jl_tpu_torch.periodic import normal_forms as pnf

DT = torch.float64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
def test_bvam_jac_op_equals_plain_and_jvp(cuda_device):
    p = bt.models.bvam_1d(N=100, device=cuda_device)
    q = bt.models.bvam_1d(N=100, device=cuda_device, spmv=dia_spmv_plain)
    g = torch.Generator().manual_seed(1)
    u = torch.randn((2, 100), generator=g, dtype=DT).to(cuda_device)
    v = torch.randn((5, 2, 100), generator=g, dtype=DT).to(cuda_device)
    n0 = dia_spmv.launches
    out = p.jac_op(u, p.params)(v)
    assert dia_spmv.launches == n0 + 1
    assert _rel(out, q.jac_op(u, q.params)(v)) <= 1e-12
    ref = torch.stack([jvp(lambda x: p.F(x, p.params), (u,), (vk,))[1]
                       for vk in v])
    assert _rel(out, ref) <= 1e-12


def _random_blocks(device, n=4, m=4, Ntst=6, seed=2):
    rng = np.random.default_rng(seed)
    arr = dict(Aint=rng.standard_normal((Ntst, m * n, m * n))
               + 4 * np.eye(m * n),
               B0=rng.standard_normal((Ntst, m * n, n)),
               cT=rng.standard_normal((Ntst, m * n)),
               phi0=rng.standard_normal((Ntst, n)),
               phiI=rng.standard_normal((Ntst, m * n)))
    return tc.COPBlocks(**{k: torch.tensor(v, device=device)
                           for k, v in arr.items()}, n=n, m=m, Ntst=Ntst)


@pytest.mark.cuda
@pytest.mark.parametrize("cplx", [False, True])
def test_bc_sigma_card_equals_cpu(cuda_device, cplx):
    N = (6 * 4 + 1) * 4
    rng = np.random.default_rng(3)
    a = rng.standard_normal(N) + (1j * rng.standard_normal(N) if cplx else 0)
    b = rng.standard_normal(N) + (1j * rng.standard_normal(N) if cplx else 0)
    s = (np.cos(0.6), np.sin(0.6)) if cplx else (-1.0, 0.0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        res = tc.cop_bc_sigma(_random_blocks(dev), torch.tensor(a).to(dev),
                              torch.tensor(b).to(dev), *s, adjoint=True)
        out[dev.type] = [r.cpu() for r in res]
    for x, y in zip(out["cuda"], out["cpu"]):
        assert float((x - y).abs().max()) <= 1e-10


def _smooth_orbit(N, disc, device):
    """A smooth periodic state of the BVAM model on `disc` (not an orbit:
    the cores are deterministic functions of X and the borders)."""
    prob = bt.models.bvam_1d(N=N, device=device)
    t = torch.as_tensor(disc.node_times(np.linspace(0, 1, disc.Ntst + 1)),
                        dtype=DT, device=device)
    base = prob.u0.reshape(-1)
    wave = torch.sin(2 * np.pi * t)[:, None] * torch.linspace(
        0.2, 0.5, base.shape[0], dtype=DT, device=device)
    nodes = base[None] + wave
    return prob, disc.pack(nodes, 3.1)


@pytest.mark.cuda
def test_iooss_core_card_equals_cpu(cuda_device):
    disc = bt.Collocation(Ntst=10, m=4)
    nj = disc.unknown_size(20) - 1
    borders = tuple(pnf._uniform_borders(nj, k, DT, "cpu") for k in range(3))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        prob, X = _smooth_orbit(10, disc, dev)
        po = bt.periodic_orbit_problem(prob, disc, X, use_cop=True)
        par = po.params
        res = pnf._pd_iooss_core(disc, po.prob_vf, 20, X, par["_inner"],
                                 par["_mesh"],
                                 borders=tuple((a.to(dev), b.to(dev))
                                               for a, b in borders))
        out[dev.type] = (res["a"], res["b3"])
    for x, y in zip(out["cuda"], out["cpu"]):
        assert abs(x - y) <= 1e-10 * max(abs(y), 1.0)


@pytest.mark.cuda
def test_sigma_gradient_launches_no_kernel_under_autodiff(cuda_device):
    disc = bt.Collocation(Ntst=10, m=4)
    prob, X = _smooth_orbit(10, disc, cuda_device)
    po = bt.periodic_orbit_problem(prob, disc, X, use_cop=True)
    maprob, _ = pc2._po_ma_problem_functional(po, "D", "pd")
    g = torch.Generator().manual_seed(4)
    nX = X.shape[0]
    par = dict(po.params)
    par["_a"] = torch.randn(nX - 1, generator=g, dtype=DT).to(cuda_device)
    par["_b"] = torch.randn(nX - 1, generator=g, dtype=DT).to(cuda_device)
    Y = torch.cat([X, torch.tensor([-1.2], dtype=DT, device=cuda_device)])
    n0 = dia_spmv.launches
    J = maprob.jac(Y, par)
    assert dia_spmv.launches > n0          # the blocks take the kernel
    n1 = dia_spmv.launches
    ref = pc2.po_sigma_autodiff(maprob, Y, par)
    assert dia_spmv.launches == n1
    assert _rel(J.sig_X, ref[0]) <= 1e-8
    assert _rel(J.sig_p1, ref[1]) <= 1e-8
