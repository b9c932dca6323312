"""The periodic closure of the SH J.v CUDA kernel
(`jl_tpu_torch/csrc/sh_jv.cu`, `sh_jv_periodic_f32/f64`) against its
plain PyTorch version (`sh_jv_plain(closure="periodic")`, `torch.roll`)
on the card.  The kernel has no CPU mode, so every test here is marked
`cuda` and skips where there is no card.  The file imports no JAX, so it
also runs on the machine with the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_sh_jv_periodic_card.py

Cases: the periodic model's 512x512 at GMRES's K = 1 and LOBPCG's K = 15
(11 eigenvalues + 4 guard vectors), the flagship's 151x100, and odd and
tiny shapes (N or M in {1, 2, 3, 5}, where the wrap meets itself within
the halo), f32 and f64.  Each goes through `sh_jv` and through
`sh_jv_operator`, the periodic model's route; the model's `jac_op` is
held to the same on a 64x48 grid.

Tolerance: relative to max |plain|, f64 1e-12 and f32 1e-5 (the kernel
multiplies by 1/h^2 where the plain version divides by h^2, and sums in
another order).
"""
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu_torch import models
from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CASES = [((512, 512), 1), ((512, 512), 15), ((151, 100), 1),
         ((151, 100), 15), ((37, 23), 3), ((1, 1), 1), ((1, 7), 2),
         ((2, 5), 3), ((3, 130), 1), ((5, 2), 15), ((70, 1), 2),
         ((21, 130), 4), ((17, 65), 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, K, dtype, device, seed=5):
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                            device=device) for s in (shape, (K,) + shape))
    scal = torch.tensor([-0.15, 1.3, 1.0 / 0.11, 1.0 / 0.07], dtype=dtype,
                        device=device)
    return u, v, scal


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,K", CASES)
def test_periodic_kernel_matches_plain_on_card(cuda_device, shape, K, dtype):
    u, v, scal = _inputs(shape, K, dtype, cuda_device)
    vv = v if K > 1 else v[0]
    before = dict(sh_jv_mod.sh_jv.launches_by_case)
    out = sh_jv_mod.sh_jv(u, vv, scal, closure="periodic")
    via_op = sh_jv_mod.sh_jv_operator(u, scal, closure="periodic")(vv)
    torch.cuda.synchronize()
    ref = sh_jv_mod.sh_jv_plain(u, vv, scal, closure="periodic")
    assert _rel(out, ref) < RTOL[dtype]
    assert torch.equal(via_op, out)
    key = ("periodic", str(dtype).split(".")[-1], K)
    assert sh_jv_mod.sh_jv.launches_by_case[key] == before.get(key, 0) + 2
    if shape != (1, 1):       # the Neumann entry point is another map
        neu = sh_jv_mod.sh_jv(u, vv, scal)
        assert _rel(neu, ref) > 1e-3


@pytest.mark.cuda
def test_model_jac_op_is_the_periodic_kernel(cuda_device):
    prob = models.swift_hohenberg_periodic_2d(Nx=64, Ny=48)
    u = prob.u0 + 0.1 * torch.randn(64, 48, dtype=torch.float64,
                                    device=cuda_device,
                                    generator=torch.Generator(
                                        cuda_device).manual_seed(0))
    v = torch.randn(3, 64, 48, dtype=torch.float64, device=cuda_device)
    launches = sh_jv_mod.launch_count()
    out = prob.jac_op(u, prob.params)(v)
    torch.cuda.synchronize()
    assert sh_jv_mod.launch_count() == launches + 1
    ad = torch.stack([torch.func.jvp(lambda x: prob.F(x, prob.params), (u,),
                                     (vk,))[1] for vk in v])
    assert _rel(out, ad) < 1e-12
