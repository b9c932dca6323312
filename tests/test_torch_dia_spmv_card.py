"""The DIA SpMV CUDA kernel (`jl_tpu_torch/csrc/dia_spmv.cu`) against its
plain PyTorch version on the card.  The kernel has no CPU mode, so every
test here is marked `cuda` and skips where there is no card.  The file
imports no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_dia_spmv_card.py

Cases: the Brusselator path's shape (n = 256, offsets -128, -1, 0, 1, 128)
at K = 1 and K = 8, a ragged n (not a multiple of 32 or 1024), offsets
far beyond one tile (+-5000 on n = 20,000), five diagonals on 2^20 rows,
n of 1 to 3, and more diagonals than one unrolled group of the kernel (12,
and the most it takes, 32).  The out-of-band entries of `data` hold random
nonzero values.  A matrix whose `data` is replaced after its first product
shows that a product reads what the matrix holds at the call.

Tolerance: relative to max |plain|, f64 1e-12 and f32 1e-5 (the kernel
fuses each multiply-add where the plain version rounds the product
first).
"""
import dataclasses

import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu_torch.ops import DIAMatrix
from bifurcationkit.jl_tpu_torch.ops.dia_spmv import (
    MAX_DIAGS, dia_spmv, dia_spmv_plain)

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CASES = [(256, (-128, -1, 0, 1, 128), 1), (256, (-128, -1, 0, 1, 128), 8),
         (1000, (-37, -1, 0, 2, 999), 3),
         (20000, (-5000, -1, 0, 1, 5000), 1),
         (1 << 20, (-1024, -1, 0, 1, 1024), 1),
         (1, (0,), 1), (2, (-1, 0, 1), 2), (3, (-5, -2, 0, 1, 3), 1),
         (300, tuple(range(-6, 6)), 2),
         (777, tuple(range(-40, 40, 5)) + tuple(range(300, 1100, 50)), 3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(n, offsets, K, dtype, device, seed=4):
    rng = np.random.default_rng(seed)
    data = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                           dtype=dtype, device=device)
    v = torch.as_tensor(rng.standard_normal((K, n)), dtype=dtype,
                        device=device)
    return DIAMatrix(data, offsets), (v if K > 1 else v[0])


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,offsets,K", CASES)
def test_kernel_matches_plain_on_card(cuda_device, n, offsets, K, dtype):
    A, v = _case(n, offsets, K, dtype, cuda_device)
    before = dia_spmv.launches
    out = dia_spmv(A, v)
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 1
    ref = dia_spmv_plain(A, v)
    assert out.shape == ref.shape and out.dtype == dtype
    assert _rel(out, ref) < RTOL[dtype]
    # the container's matvec is the same launch, on a non-contiguous v too
    assert torch.equal(A(v), out)
    if K > 1:
        assert torch.equal(A(v.t().contiguous().t()), out)
    assert dia_spmv.launches == before + 2 + (K > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_product_follows_replaced_data(cuda_device, dtype):
    """A product reads what the matrix holds at the call, not what it held
    at its first product: `data` replaced on the matrix, a
    `dataclasses.replace` copy, `data` overwritten in place, and `data` of
    another dtype all give the plain product."""
    A, v = _case(256, (-128, -1, 0, 1, 128), 1, dtype, cuda_device)
    B, _ = _case(256, (-128, -1, 0, 1, 128), 1, dtype, cuda_device, seed=5)
    A(v)
    object.__setattr__(A, "data", B.data.clone())
    assert _rel(A(v), dia_spmv_plain(B, v)) < RTOL[dtype]
    C = dataclasses.replace(A, data=2 * B.data)
    assert _rel(C(v), 2 * dia_spmv_plain(B, v)) < RTOL[dtype]
    A.data.copy_(3 * B.data)
    assert _rel(A(v), 3 * dia_spmv_plain(B, v)) < RTOL[dtype]
    other = torch.float32 if dtype == torch.float64 else torch.float64
    object.__setattr__(A, "data", A.data.to(other))
    w = v.to(other)
    assert _rel(A(w), dia_spmv_plain(A, w)) < RTOL[torch.float32]
    with pytest.raises(TypeError, match="match data"):
        A(v)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    """Every refusal of the wrapper; nothing is launched."""
    A, v = _case(256, (-128, 0, 128), 1, torch.float64, cuda_device)
    before = dia_spmv.launches
    with pytest.raises(ValueError, match="v must lie on"):
        dia_spmv(A, v.cpu())
    with pytest.raises(ValueError, match="data must lie on"):
        dia_spmv(DIAMatrix(A.data.cpu(), A.offsets), v)
    with pytest.raises(TypeError, match="match data"):
        dia_spmv(A, v.float())
    with pytest.raises(TypeError, match="float32 or float64"):
        dia_spmv(DIAMatrix(A.data.half(), A.offsets), v.half())
    with pytest.raises(ValueError, match="v must be contiguous"):
        dia_spmv(A, torch.stack([v, v], dim=1)[:, 0])
    with pytest.raises(ValueError, match="data must be contiguous"):
        dia_spmv(DIAMatrix(A.data.t().contiguous().t(), A.offsets), v)
    with pytest.raises(ValueError, match="data must be \\(ndiag, n\\)"):
        dia_spmv(DIAMatrix(A.data, (-128, 0)), v)
    with pytest.raises(ValueError, match="diagonals"):
        many = tuple(range(MAX_DIAGS + 1))
        dia_spmv(DIAMatrix(torch.zeros(len(many), 256, dtype=v.dtype,
                                       device=cuda_device), many), v)
    with pytest.raises(ValueError, match="v must be"):
        dia_spmv(A, v[:100])
    with pytest.raises(ValueError, match="v must be"):
        dia_spmv(A, v.reshape(1, 1, 256))
    with pytest.raises(ValueError, match="batch 65536 > 65535"):
        one = DIAMatrix(torch.ones(1, 1, dtype=v.dtype, device=cuda_device),
                        (0,))
        dia_spmv(one, torch.zeros(65536, 1, dtype=v.dtype,
                                  device=cuda_device))
    assert dia_spmv.launches == before
