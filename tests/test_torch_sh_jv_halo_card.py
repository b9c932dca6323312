"""The halo-row closure of the SH J.v CUDA kernel
(`jl_tpu_torch/csrc/sh_jv.cu`, `sh_jv_halo_f32/f64`) on the card: a field
split into row blocks, each launched with its neighbours' rows and the
global-edge flags, against the whole-field Neumann kernel and against
the plain version (`sh_jv_halo_plain`) of each block.  The kernel has no
CPU mode, so every test here is marked `cuda` and skips where there is
no card.  The file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_sh_jv_halo_card.py

Tolerance: relative to max |reference|, f64 1e-12 and f32 1e-5."""
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CASES = [((152, 100), 2, 1), ((152, 100), 4, 13), ((152, 100), 8, 1),
         ((37, 23), 3, 3), ((4, 100), 2, 1), ((16, 9), 8, 2),
         ((151, 100), 3, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, K, dtype, device, seed=7):
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                            device=device) for s in (shape, (K,) + shape))
    scal = torch.tensor([-0.1, 1.3, 1.0 / 0.0241, 1.0 / 0.0313],
                        dtype=dtype, device=device)
    return u, v, scal


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,nb,K", CASES)
def test_halo_kernel_matches_whole_field_and_plain(cuda_device, shape, nb,
                                                   K, dtype):
    u, v, scal = _inputs(shape, K, dtype, cuda_device)
    bounds = [int(b) for b in np.linspace(0, shape[0], nb + 1).round()]
    vv = v if K > 1 else v[0]
    before = dict(sh_jv_mod.sh_jv.launches_by_case)
    out = sh_jv_mod.sh_jv_by_blocks(u, vv, scal, bounds)
    key = ("halo", str(dtype).split(".")[-1], K)
    assert sh_jv_mod.sh_jv.launches_by_case.get(key, 0) \
        - before.get(key, 0) == nb
    plain = sh_jv_mod.sh_jv_by_blocks(u, vv, scal, bounds,
                                      fn=sh_jv_mod.sh_jv_halo_plain)
    whole = sh_jv_mod.sh_jv(u, vv, scal)
    torch.cuda.synchronize()
    assert _rel(out, plain) < RTOL[dtype]
    assert _rel(out, whole) < RTOL[dtype]


@pytest.mark.cuda
def test_halo_kernel_refusals(cuda_device):
    u, v, scal = _inputs((8, 6), 2, torch.float64, cuda_device)
    good = v[:, :2].contiguous()
    with pytest.raises(ValueError, match="top must have shape"):
        sh_jv_mod.sh_jv_halo(u, v, good[:, :1].contiguous(), None, scal,
                             False, True)
    with pytest.raises(TypeError, match="float32 or float64"):
        sh_jv_mod.sh_jv_halo(u, v, good.float(), None, scal, False, True)
    with pytest.raises(ValueError, match="must lie on"):
        sh_jv_mod.sh_jv_halo(u, v, good.cpu(), None, scal, False, True)
    with pytest.raises(ValueError, match="carries a derivative"):
        sh_jv_mod.sh_jv_halo(u, v.clone().requires_grad_(), None, None,
                             scal, True, True)
