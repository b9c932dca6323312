"""Parity of the port's fused Swift-Hohenberg J.v (`jl_tpu_torch/ops/sh_jv.py`)
with the JAX package's (`jl_tpu/ops/pallas_sh.py`) and with `jax.jvp` of
the SH2d residual, which is what the JAX flagship computes at 151x100.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that plain version in
`test_torch_sh_jv_card.py`, which skips where there is no card.

Tolerances: relative to max |reference|, f64 1e-12 and f32 1e-5 — the two
sides evaluate the same stencil in a different order (and the kernel
multiplies by 1/h^2 where the plain version divides by h^2), so they agree
to a few ulps of the largest intermediate, ~|J| ~ 1e2 times the entries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu.ops.pallas_sh import sh_jv_pallas, sh_jv_reference
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch.ops.sh_jv import (launch_count, sh_jv,
                                                   sh_jv_operator,
                                                   sh_jv_plain)

RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors: one intra-op thread per test worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, K, dtype, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(dtype)
    v = rng.standard_normal((K,) + shape).astype(dtype)
    scal = np.array([-0.1, 1.3, 1.0 / 0.11, 1.0 / 0.07], dtype)
    return u, v, scal


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape,K", [((31, 20), 1), ((37, 23), 3),
                                     ((2, 5), 2), ((1, 1), 1)])
def test_plain_matches_jax_reference(shape, K, dtype):
    """Ragged shapes, a batch of K fields, f32 and f64."""
    u, v, scal = _inputs(shape, K, dtype)
    ref = np.stack([np.asarray(sh_jv_reference(
        jnp.asarray(u), jnp.asarray(v[k]), jnp.asarray(scal)))
        for k in range(K)])
    before = launch_count()
    out = sh_jv(torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(scal))
    assert launch_count() == before          # CPU tensors: no launch
    assert out.dtype == torch.as_tensor(u).dtype
    assert _rel(out.numpy(), ref) < RTOL[dtype]
    # an unbatched (N, M) field gives the first batch entry
    one = sh_jv(torch.as_tensor(u), torch.as_tensor(v[0]),
                torch.as_tensor(scal))
    assert _rel(one.numpy(), ref[0]) < RTOL[dtype]
    # the operator of the SH model's jac_op is the same map
    op = sh_jv_operator(torch.as_tensor(u), torch.as_tensor(scal))
    assert torch.equal(op(torch.as_tensor(v)), out)
    assert launch_count() == before


def test_plain_matches_pallas_kernel_interpret():
    """The TPU kernel itself, in interpret mode at a tileable shape."""
    u, v, scal = _inputs((64, 128), 1, np.float32, seed=1)
    pal = sh_jv_pallas(jnp.asarray(u), jnp.asarray(v[0]), jnp.asarray(scal),
                       block_rows=32, interpret=True)
    out = sh_jv_plain(torch.as_tensor(u), torch.as_tensor(v[0]),
                      torch.as_tensor(scal))
    assert _rel(out.numpy(), pal) < RTOL[np.float32]


def test_model_jv_matches_jvp_of_jax_residual():
    """The port's SH2d `dF` (through `jac_op` and the fused J.v) against
    `jax.jvp` of the JAX model's F — the flagship's J.v — at 31x20."""
    pj = jmodels.swift_hohenberg_2d(Nx=31, Ny=20)
    pt = tmodels.swift_hohenberg_2d(Nx=31, Ny=20, device="cpu")
    u0 = np.asarray(pj.u0)
    v = np.random.default_rng(2).standard_normal(u0.shape)
    ref = jax.jvp(lambda x: pj.F(x, pj.params), (jnp.asarray(u0),),
                  (jnp.asarray(v),))[1]
    ut, part = interop.state_from_numpy(u0, pj.params, "cpu")
    out = pt.dF(ut, part, torch.as_tensor(v))
    assert _rel(out.numpy(), ref) < RTOL[np.float64]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Off the CPU the wrapper and the operator validate before any
    launch (a `meta` tensor stands in for a device tensor here)."""
    u = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="must lie on"):
        sh_jv(u, u, torch.empty((4,), device="meta"))
    with pytest.raises(ValueError, match="must lie on"):
        sh_jv_operator(u, torch.empty((4,), device="meta"))
