"""The SH J.v CUDA kernel (`jl_tpu_torch/csrc/sh_jv.cu`) against its plain
PyTorch version on the card.  The kernel has no CPU mode, so every test
here is marked `cuda` and skips where there is no card.  The file imports
no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_sh_jv_card.py

Cases: the flagship's 151x100 grid at every batch size its path launches
(GMRES's K = 1, LOBPCG's 20, 40 and 60) and at 2, 59 and 61 (a batch
walk that ends on a full, a one-field and a split chunk),
1024x1024, grids with N or M in {1, 2, 3, 5} (a tile wider than the field
on either axis, where both Neumann closures meet), and tiles ragged on
both axes.  Each goes through `sh_jv` and through `sh_jv_operator`, the
SH model's lean route.

Tolerance: relative to max |plain|, f64 1e-12 and f32 1e-5 (the kernel
multiplies by 1/h^2 where the plain version divides by h^2, and sums in
another order).
"""
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu_torch.ops import sh_jv as sh_jv_mod

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CASES = [((151, 100), 1), ((151, 100), 2), ((151, 100), 20),
         ((151, 100), 40), ((151, 100), 59), ((151, 100), 60),
         ((151, 100), 61), ((37, 23), 3),
         ((1024, 1024), 1), ((1, 1), 1), ((1, 7), 2), ((2, 5), 3),
         ((3, 130), 1), ((5, 2), 61), ((70, 1), 2), ((5, 3), 59),
         ((21, 130), 4), ((17, 65), 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, K, dtype, device, seed=3):
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                            device=device) for s in (shape, (K,) + shape))
    scal = torch.tensor([-0.1, 1.3, 1.0 / 0.11, 1.0 / 0.07], dtype=dtype,
                        device=device)
    return u, v, scal


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,K", CASES)
def test_kernel_matches_plain_on_card(cuda_device, shape, K, dtype):
    u, v, scal = _inputs(shape, K, dtype, cuda_device)
    before = sh_jv_mod.launch_count()
    out = sh_jv_mod.sh_jv(u, v, scal)
    torch.cuda.synchronize()
    assert sh_jv_mod.launch_count() == before + 1
    ref = sh_jv_mod.sh_jv_plain(u, v, scal)
    assert _rel(out, ref) < RTOL[dtype]
    # an unbatched field, and the operator the SH model's jac_op uses
    one = sh_jv_mod.sh_jv(u, v[0], scal)
    assert _rel(one, ref[0]) < RTOL[dtype]
    op = sh_jv_mod.sh_jv_operator(u, scal)
    by_batch = sh_jv_mod.launches_by_batch()
    assert torch.equal(op(v), out) and torch.equal(op(v[0]), one)
    assert sh_jv_mod.launch_count() == before + 4
    assert sh_jv_mod.launches_by_batch()[K] == by_batch[K] + 1 + (K == 1)
    with pytest.raises(ValueError, match="must lie on"):
        sh_jv_mod.sh_jv(u, v.cpu(), scal)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    """Every refusal of the wrapper, through `sh_jv` and, for v, through
    the operator too; nothing is launched."""
    u, v, scal = _inputs((16, 8), 2, torch.float64, cuda_device)
    op = sh_jv_mod.sh_jv_operator(u, scal)
    before = sh_jv_mod.launch_count()
    for bad_u, bad_v, bad_scal, err, match in [
            (u.cpu(), v, scal, ValueError, "u must lie on"),
            (u, v, scal.cpu(), ValueError, "scal must lie on"),
            (u.half(), v.half(), scal.half(), TypeError, "float32 or float64"),
            (u, v, scal.float(), TypeError, "scal must be .* match u"),
            (u.t(), v, scal, ValueError, "u must be contiguous"),
            (u, v, torch.stack([scal, scal], 1)[:, 0], ValueError,
             "scal must be contiguous"),
            (u[:0], v[:, :0], scal, ValueError, "non-empty \\(N, M\\) field"),
            (u[0], v[:, 0], scal, ValueError, "non-empty \\(N, M\\) field"),
            (u, v, scal[:3], ValueError, "scal must have shape \\(4,\\)")]:
        with pytest.raises(err, match=match):
            sh_jv_mod.sh_jv(bad_u, bad_v, bad_scal)
    big = torch.zeros((65536, 1, 1), dtype=u.dtype, device=cuda_device)
    for bad_v, err, match in [
            (v.cpu(), ValueError, "v must lie on"),
            (v.float(), TypeError, "v must be .* match u"),
            (v.transpose(1, 2).contiguous().transpose(1, 2), ValueError,
             "v must be contiguous"),
            (v[..., :7].contiguous(), ValueError,
             "v must be \\(N, M\\) or \\(K, N, M\\)"),
            (v[None], ValueError, "v must be \\(N, M\\) or \\(K, N, M\\)")]:
        for apply in (op, lambda x: sh_jv_mod.sh_jv(u, x, scal)):
            with pytest.raises(err, match=match):
                apply(bad_v)
    one = sh_jv_mod.sh_jv_operator(u[:1, :1].contiguous(), scal)
    with pytest.raises(ValueError, match="batch 65536 > 65535"):
        one(big)
    assert sh_jv_mod.launch_count() == before
