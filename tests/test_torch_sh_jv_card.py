"""The SH J.v CUDA kernel (`jl_tpu_torch/csrc/sh_jv.cu`) against its plain
PyTorch version on the card.  The kernel has no CPU mode, so every test
here is marked `cuda` and skips where there is no card.  The file imports
no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_sh_jv_card.py

Tolerance: relative to max |plain|, f64 1e-12 and f32 1e-5 (the kernel
multiplies by 1/h^2 where the plain version divides by h^2, and sums in
another order).
"""
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,K", [((151, 100), 1), ((151, 100), 60),
                                     ((37, 23), 3), ((1024, 1024), 1)])
def test_kernel_matches_plain_on_card(cuda_device, shape, K, dtype):
    rng = np.random.default_rng(3)
    u, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                            device=cuda_device) for s in (shape, (K,) + shape))
    scal = torch.tensor([-0.1, 1.3, 1.0 / 0.11, 1.0 / 0.07], dtype=dtype,
                        device=cuda_device)
    before = sh_jv_mod.sh_jv.launches
    out = sh_jv_mod.sh_jv(u, v, scal)
    torch.cuda.synchronize()
    assert sh_jv_mod.sh_jv.launches == before + 1
    ref = sh_jv_mod.sh_jv_plain(u, v, scal)
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err < RTOL[dtype]
    # an unbatched field and the rejection of a CPU tensor
    one = sh_jv_mod.sh_jv(u, v[0], scal)
    assert float((one - ref[0]).abs().max() / ref[0].abs().max()) < RTOL[dtype]
    with pytest.raises(ValueError, match="must lie on"):
        sh_jv_mod.sh_jv(u, v.cpu(), scal)

