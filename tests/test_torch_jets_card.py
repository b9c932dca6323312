"""Derivatives and the kernels on the card.  A hand-written kernel computes
values only: the normal forms take d/dp (J v) from F itself, never
through a `jac_op` kernel, and both kernel wrappers refuse a CUDA operand
that carries a derivative (requires grad, is wrapped by a `torch.func`
transform, or has a forward-mode tangent) instead of dropping it.  Every
test here needs the card, so each is marked `cuda` and skips where there
is none.  The file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_jets_card.py

Tolerances: the mixed derivative and J.v through the kernel against the
plain route, 1e-12 relative to max |plain| (the kernel sums in another
order); the normal-form coefficients on the card against the CPU's,
1e-8 relative to max(|c|, 1), as `chip_smoke.py` holds them.
"""
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.func import jvp

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.continuation.results import ContResult
from bifurcationkit.jl_tpu_torch.detection.points import SpecialPoint
from bifurcationkit.jl_tpu_torch.normal_forms.codim1 import _FlatProblem
from bifurcationkit.jl_tpu_torch.ops import DIAMatrix, dia_spmv
from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod

NX, NY = 60, 40
DOMAIN = dict(lx=8 * np.pi * NX / 151, ly=4 * np.pi / np.sqrt(3) * NY / 100)
P_BP = -0.10081828     # the first bp of the 60x40 branch (branch tests)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def _sh(device):
    return bt.models.swift_hohenberg_2d(Nx=NX, Ny=NY, device=device,
                                        **DOMAIN)


def _plain_jac_op(prob):
    """The SH J.v through `sh_jv_plain` with the model's scalars."""
    hx2 = (2 * DOMAIN["lx"] / NX) ** 2
    hy2 = (2 * DOMAIN["ly"] / NY) ** 2

    def jac_op(u, par):
        scal = torch.stack([torch.as_tensor(par["l"], dtype=u.dtype,
                                            device=u.device),
                            torch.as_tensor(par["nu"], dtype=u.dtype,
                                            device=u.device)])
        scal = torch.cat([scal, torch.tensor([1 / hx2, 1 / hy2],
                                             dtype=u.dtype, device=u.device)])
        return lambda v: sh_jv_mod.sh_jv_plain(u, v, scal)

    return prob.re_make(jac_op=jac_op)


def _point(prob, device):
    u = prob.u0 + 0.1 * torch.as_tensor(
        np.random.default_rng(5).standard_normal((NX, NY)), device=device)
    return u, prob.set_lens_param(prob.params, P_BP)


@pytest.mark.cuda
def test_mixed_derivative_through_the_kernel_equals_plain(cuda_device):
    prob = _sh(cuda_device)
    u, par = _point(prob, cuda_device)
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(NX * NY),
                        device=cuda_device)
    fp = _FlatProblem(prob, u, par)
    fp_plain = _FlatProblem(_plain_jac_op(prob), u, par)
    fp_cpu = _FlatProblem(_sh("cpu"), u.cpu(), prob.set_lens_param(
        _sh("cpu").params, P_BP))
    before = sh_jv_mod.launch_count()
    Jv = fp.dF(v)
    assert sh_jv_mod.launch_count() == before + 1
    assert _rel(Jv, fp_plain.dF(v)) < 1e-12
    # R11 v = d/dp (J v): for SH, dJ/dl = I, so R11 v = v exactly
    r11 = fp.dFdp_dir(v, P_BP)
    assert _rel(r11, fp_plain.dFdp_dir(v, P_BP)) < 1e-12
    assert _rel(r11.cpu(), fp_cpu.dFdp_dir(v.cpu(), P_BP)) < 1e-12
    assert _rel(r11, v) < 1e-12
    assert sh_jv_mod.launch_count() == before + 1   # F only, no kernel


@pytest.mark.cuda
def test_mixed_derivative_through_the_dia_jac_op(cuda_device):
    """The Brusselator with a user DIA `jac_op`: d/dp (J v) depends on p
    through the diffusion, and comes out as on the CPU."""
    n = 16
    probs = {d: bt.models.brusselator_1d(n=n, device=d).re_make(
        jac_op=_bruss_dia_jac_op(n)) for d in (cuda_device, "cpu")}
    rng = np.random.default_rng(7)
    u = probs["cpu"].u0 * torch.as_tensor(1 + 0.1 * rng.standard_normal(2 * n))
    v = torch.as_tensor(rng.standard_normal(2 * n))
    out = {}
    for d, prob in probs.items():
        fp = _FlatProblem(prob, u.to(d), prob.set_lens_param(prob.params,
                                                             0.47))
        out[str(d)] = (fp.dF(v.to(d)).cpu(), fp.dFdp_dir(v.to(d), 0.47).cpu())
    (jv_card, r11_card), (jv_cpu, r11_cpu) = out[str(cuda_device)], out["cpu"]
    assert _rel(jv_card, jv_cpu) < 1e-12
    assert _rel(r11_card, r11_cpu) < 1e-12
    assert float(r11_cpu.abs().max()) > 0


def _bruss_dia_jac_op(n):
    """User code: the Brusselator jacobian as a five-diagonal `DIAMatrix`
    (offsets -n, -1, 0, 1, n on the stacked (u, v) state)."""
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


def _sh_operands(device):
    rng = np.random.default_rng(8)
    u = torch.as_tensor(rng.standard_normal((9, 7)), device=device)
    v = torch.as_tensor(rng.standard_normal((9, 7)), device=device)
    scal = torch.tensor([-0.1, 1.3, 9.0, 11.0], dtype=torch.float64,
                        device=device)
    return u, v, scal


@pytest.mark.cuda
def test_sh_jv_refuses_operands_with_derivatives(cuda_device):
    u, v, scal = _sh_operands(cuda_device)
    t = torch.ones_like(v)
    op = sh_jv_mod.sh_jv_operator(u, scal)
    for call in (lambda w: sh_jv_mod.sh_jv(u, w, scal), op):
        with pytest.raises(ValueError, match="derivative"):
            call(v.clone().requires_grad_())
        with pytest.raises(ValueError, match="derivative"):
            jvp(call, (v,), (t,))
        with fwAD.dual_level():
            with pytest.raises(ValueError, match="derivative"):
                call(fwAD.make_dual(v, t))
    with pytest.raises(ValueError, match="derivative"):
        sh_jv_mod.sh_jv_operator(u.clone().requires_grad_(), scal)
    # the trap of a jet taken through the model's jac_op: a tangent in the
    # parameter reaches the kernel's scalars
    with pytest.raises(ValueError, match="derivative"):
        jvp(lambda s: sh_jv_mod.sh_jv(u, v, s), (scal,), (scal,))
    # without derivatives the kernel runs as before
    assert _rel(op(v), sh_jv_mod.sh_jv_plain(u, v, scal)) < 1e-12


@pytest.mark.cuda
def test_dia_spmv_refuses_operands_with_derivatives(cuda_device):
    rng = np.random.default_rng(9)
    data = torch.as_tensor(rng.standard_normal((3, 20)), device=cuda_device)
    v = torch.as_tensor(rng.standard_normal(20), device=cuda_device)
    offsets = (-1, 0, 1)
    t = torch.ones_like(v)
    with pytest.raises(ValueError, match="derivative"):
        dia_spmv(DIAMatrix(data.clone().requires_grad_(), offsets), v)
    with pytest.raises(ValueError, match="derivative"):
        dia_spmv(DIAMatrix(data, offsets), v.clone().requires_grad_())
    with pytest.raises(ValueError, match="derivative"):
        jvp(lambda w: dia_spmv(DIAMatrix(data, offsets), w), (v,), (t,))
    with pytest.raises(ValueError, match="derivative"):
        jvp(lambda d: dia_spmv(DIAMatrix(d, offsets), v), (data,), (data,))
    with fwAD.dual_level():
        with pytest.raises(ValueError, match="derivative"):
            dia_spmv(DIAMatrix(data, offsets), fwAD.make_dual(v, t))
    ref = dia_spmv(DIAMatrix(data.cpu(), offsets), v.cpu())
    assert _rel(dia_spmv(DIAMatrix(data, offsets), v).cpu(), ref) < 1e-12


@pytest.mark.cuda
def test_matrix_free_normal_form_on_card_equals_cpu(cuda_device):
    """The MF 1d normal form at the 60x40 branch's first bp through the
    kernel equals the CPU's (plain version), from the same point."""
    out = {}
    x = None
    for dev in (cuda_device, "cpu"):
        prob = _sh(dev)
        prob = prob.re_make(params=prob.set_lens_param(prob.params, P_BP))
        if x is None:
            ls = bt.GMRES(restart=40, maxiter=300, rtol=1e-12,
                          precond=prob.spectral_precond)
            sol = bt.newton(prob, bt.NewtonPar(tol=1e-9, max_iterations=25,
                                               linsolver=ls))
            assert sol.converged
            x = sol.u.cpu()
        sp = SpecialPoint(type="bp", param=P_BP, x=x.to(dev),
                          status="converged", delta=(1, 0))
        before = sh_jv_mod.launch_count()
        nf = bt.get_normal_form(ContResult(prob=prob, specialpoint=[sp]), 0,
                                matrix_free=True)
        if dev == cuda_device:
            assert sh_jv_mod.launch_count() > before
        out[str(dev)] = nf
    card, cpu = out[str(cuda_device)], out["cpu"]
    assert type(card) is type(cpu)
    for key in ("a01", "b11", "b20", "b30"):
        c, r = card.nf[key], cpu.nf[key]
        assert abs(c - r) <= 1e-8 * max(abs(r), 1.0), (key, c, r)
