"""The PDE codim-2 models' DIA J.v and their matrix-free codim-2 normal
forms on the card.  Every test needs the card, so each is marked `cuda`
and skips where there is none (decided in a fixture).  The file imports
no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_codim2_nf_card.py

Tolerances, and why:
* J.v through `dia_spmv` against the same model with `dia_spmv_plain` on
  the card and against `torch.func.jvp` of F, at the full widths
  (40 x 40 BT, 32 x 32 fold-Hopf), to 1e-12 relative to the largest entry
  (the kernel sums five products in its own order);
* the matrix-free BT and ZH forms on the card against the CPU's from the
  same inputs, to 1e-8 * max(|c|, 1) (the same iterations from the same
  start vectors; the kernel's rounding differs); the ZH G's flip together
  with q0, so each side is aligned by the sign of q0's mean;
* `_ParamJet.A1` on a problem whose J.v is the kernel: no derivative
  reaches the kernel (it would refuse one), no launch happens, and the
  value equals the CPU's to 1e-12 relative.
"""
import pytest
import torch
from torch.func import jvp

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.codim2.unfolding import _ParamJet
from bifurcationkit.jl_tpu_torch.ops import dia_spmv
from bifurcationkit.jl_tpu_torch.ops.dia_spmv import dia_spmv_plain

DT = torch.float64
SIZES = {"bogdanov_takens_2d": 40, "fold_hopf_interaction_2d": 32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def _model(name, device, **kw):
    N = SIZES[name]
    return getattr(bt.models, name)(Nx=N, Ny=N, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
def test_dia_jac_op_equals_plain_and_jvp(cuda_device, name):
    p = _model(name, cuda_device)
    q = _model(name, cuda_device, spmv=dia_spmv_plain)
    g = torch.Generator(device="cpu").manual_seed(1)
    u = torch.randn(p.u0.shape, generator=g, dtype=DT).to(cuda_device)
    v = torch.randn((3,) + p.u0.shape, generator=g, dtype=DT).to(
        cuda_device)
    n0 = dia_spmv.launches
    out = p.jac_op(u, p.params)(v)
    assert dia_spmv.launches == n0 + 1          # one batched launch
    ref = q.jac_op(u, q.params)(v)
    assert _rel(out, ref) <= 1e-12
    ref_f = torch.stack([jvp(lambda x: p.F(x, p.params), (u,), (vk,))[1]
                         for vk in v])
    assert _rel(out, ref_f) <= 1e-12
    out_t = p.jac_adjoint(u, p.params)(v[0])
    assert _rel(out_t, q.jac_adjoint(u, q.params)(v[0])) <= 1e-12


def _zero_params(p, device, **vals):
    return {k: torch.tensor(vals.get(k, float(v)), dtype=DT, device=device)
            for k, v in p.params.items()}


@pytest.mark.cuda
def test_mf_bt_form_card_equals_cpu(cuda_device):
    """The matrix-free BT form and unfolding at the exact BT of the 40 x 40
    model, on the card and on the CPU."""
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = _model("bogdanov_takens_2d", dev)
        par = _zero_params(p, dev, b1=0.0, b2=0.0)
        nf = bt.bt_unfolding(p, torch.zeros_like(p.u0), par,
                             bt.as_lens("b1"), bt.as_lens("b2"),
                             matrix_free=True)
        out[dev.type] = {k: torch.as_tensor(nf[k]).cpu()
                         for k in ("a", "b", "K10", "K11", "K2")}
    for k, ref in out["cpu"].items():
        got = out["cuda"][k]
        assert float((got - ref).abs().max()) <= 1e-8 * max(
            float(ref.abs().max()), 1.0), (k, got, ref)


@pytest.mark.cuda
def test_mf_zh_form_card_equals_cpu(cuda_device):
    """The matrix-free ZH form at the exact ZH of the 32 x 32 fold-Hopf
    model (p1 = a = 0, x = 0), on the card and on the CPU."""
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = _model("fold_hopf_interaction_2d", dev)
        par = _zero_params(p, dev, p1=0.0, a=0.0)
        pt = bt.zh_normal_form(p, torch.zeros_like(p.u0), par,
                               matrix_free=True, omega=1.0)
        s = float(torch.sign(torch.sum(pt.zeta[0])))
        out[dev.type] = {"G200": s * pt.nf["G200"],
                         "G011": s * pt.nf["G011"],
                         "G110": s * pt.nf["G110"], "omega": pt.omega}
    for k, ref in out["cpu"].items():
        got = out["cuda"][k]
        assert abs(got - ref) <= 1e-8 * max(abs(ref), 1.0), (k, got, ref)


@pytest.mark.cuda
def test_param_jet_through_dia_model_reaches_no_kernel(cuda_device):
    """d(J q)/dp through the kernel model's problem: taken from F, so no
    derivative reaches `dia_spmv` (which would refuse it) and no launch
    happens; the value equals the CPU's."""
    vals = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = _model("bogdanov_takens_2d", dev)
        g = torch.Generator(device="cpu").manual_seed(2)
        x = torch.randn(p.u0.shape, generator=g, dtype=DT).to(dev)
        q = torch.randn(p.u0.numel(), generator=g, dtype=DT).to(dev)
        n0 = dia_spmv.launches
        pj = _ParamJet(p, x, p.params, bt.as_lens("b2"))
        vals[dev.type] = (pj.A1(q).cpu(), pj.J1().cpu())
        assert dia_spmv.launches == n0
    for got, ref in zip(vals["cuda"], vals["cpu"]):
        assert _rel(got, ref) <= 1e-12
