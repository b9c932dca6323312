"""The matrix-free minimally augmented functionals through the kernels on
the card.  Their second derivatives (sigma_x, sigma_p1, d sigma / d p2)
are taken from F, never through a `jac_op` kernel, while every plain
J.v goes through the kernel; a derivative that reached a kernel would
trip the wrappers' refusal.  Every test here needs the card, so each is
marked `cuda` and skips where there is none.  The file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_codim2_card.py

Tolerances: the functional G (sigma), the Govaerts operator (whose last
row is sigma_x . dx + sigma_p1 dp1) and dFdp_user through the kernel
against the same through the plain version, and the 32-site
Brusselator's Hopf operator on the card against the CPU's: 1e-10
relative to the largest entry (the bordered GMRES solves converge to
1e-12 relative from the same start; the kernels sum in another order).
"""
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.codim2 import minaug_mf
from bifurcationkit.jl_tpu_torch.ops import DIAMatrix, dia_spmv
from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod

NX, NY = 60, 40
DOMAIN = dict(lx=8 * np.pi * NX / 151, ly=4 * np.pi / np.sqrt(3) * NY / 100)
GMRES_OPTS = dict(restart=80, maxiter=800, rtol=1e-12, atol=1e-15)
TOL = 1e-10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def _plain_sh(prob):
    """The SH model with J.v through `sh_jv_plain`."""
    hx2 = (2 * DOMAIN["lx"] / NX) ** 2
    hy2 = (2 * DOMAIN["ly"] / NY) ** 2

    def jac_op(u, par):
        scal = torch.stack([torch.as_tensor(par[k], dtype=u.dtype,
                                            device=u.device)
                            for k in ("l", "nu")])
        scal = torch.cat([scal, torch.tensor([1 / hx2, 1 / hy2],
                                             dtype=u.dtype, device=u.device)])
        return lambda v: sh_jv_mod.sh_jv_plain(u, v, scal)

    return prob.re_make(jac_op=jac_op)


def _fold_point(prob, device):
    """(X, params, d): a point near the model's state with borders and a
    direction, all from one seed."""
    rng = np.random.default_rng(11)
    n = NX * NY
    x = prob.u0.reshape(-1) + 0.1 * torch.as_tensor(
        rng.standard_normal(n), device=device)
    X = torch.cat([x, torch.tensor([-0.1], dtype=x.dtype, device=device)])
    a = torch.as_tensor(rng.standard_normal(n), device=device)
    b = torch.as_tensor(rng.standard_normal(n), device=device)
    d = torch.as_tensor(rng.standard_normal(n + 1), device=device)
    return X, a / torch.linalg.vector_norm(a), \
        b / torch.linalg.vector_norm(b), d


@pytest.mark.cuda
def test_fold_functional_through_sh_jv_equals_plain(cuda_device):
    """sigma, the Govaerts operator (sigma_x and sigma_p1 in its last row)
    and dFdp_user of `fold_ma_problem_mf` at 60x40: through the kernel,
    as through the plain version, and the kernel was launched (the second
    derivatives, taken from F, never reach it)."""
    prob = bt.models.swift_hohenberg_2d(Nx=NX, Ny=NY, device=cuda_device,
                                        **DOMAIN)
    X, a, b, d = _fold_point(prob, cuda_device)
    out = {}
    for name, p in (("kernel", prob), ("plain", _plain_sh(prob))):
        mp = minaug_mf.fold_ma_problem_mf(p, "l", "nu", gmres_opts=GMRES_OPTS,
                                          precond=prob.spectral_precond)
        par = {**mp.params, "_a": a, "_b": b}
        sh_jv_mod.sh_jv.launches_by_case.clear()
        out[name] = (mp.F(X, par), mp.jac_op(X, par)(d), mp.dFdp(X, par))
        launched = sh_jv_mod.launch_count()
        assert (launched > 0) == (name == "kernel"), (name, launched)
    for k, (o, r) in enumerate(zip(out["kernel"], out["plain"])):
        assert _rel(o, r) < TOL, (k, _rel(o, r))
    n = NX * NY
    assert abs(float(out["kernel"][0][n] - out["plain"][0][n])) \
        < TOL * max(abs(float(out["plain"][0][n])), 1.0)


def _bruss_dia_jac_op(n):
    """The Brusselator jacobian as a five-diagonal `DIAMatrix` (the user
    code of `chip_smoke.py`)."""
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
def test_hopf_operator_through_dia_spmv_equals_cpu(cuda_device):
    """The Govaerts operator, G and dFdp_user of `hopf_ma_problem_mf` on the
    32-site Brusselator, every J.v a `dia_spmv` launch on the card,
    against the same on the CPU (the plain product); and the l1 kernel
    runs through the kernel without tripping its derivative refusal."""
    n = 32
    rng = np.random.default_rng(3)
    x = np.concatenate([np.full(n, 2.0), np.full(n, 5.45 / 2.0)]) \
        * (1 + 0.05 * rng.standard_normal(2 * n))
    X = np.concatenate([x, [0.5, 2.1]])
    borders = {k: rng.standard_normal(2 * n)
               for k in ("_ar", "_ai", "_br", "_bi")}
    d = rng.standard_normal(2 * n + 2)
    gm = dict(restart=2 * n + 2, maxiter=8 * (2 * n + 2), rtol=1e-12,
              atol=1e-15)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        prob = bt.models.brusselator_1d(n=n, device=dev)
        prob = prob.re_make(jac_op=_bruss_dia_jac_op(n))
        mp = minaug_mf.hopf_ma_problem_mf(prob, "l", "beta", gmres_opts=gm)
        par = {**mp.params, **{k: torch.as_tensor(v, device=dev)
                               for k, v in borders.items()}}
        par = mp.set_lens_param(par, 5.6)
        Xt, dt = (torch.as_tensor(v, device=dev) for v in (X, d))
        dia_spmv.launches = 0
        out[dev.type] = [mp.jac_op(Xt, par)(dt), mp.F(Xt, par),
                         mp.dFdp(Xt, par)]
        l1 = minaug_mf.make_l1_kernel_mf(mp)(Xt, par)
        assert bool(torch.isfinite(l1))
        assert (dia_spmv.launches > 0) == (dev.type == "cuda")
    for k, (o, r) in enumerate(zip(out["cuda"], out["cpu"])):
        assert _rel(o.cpu(), r) < TOL, (k, _rel(o.cpu(), r))
