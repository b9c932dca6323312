"""The halo-row closure of the SH J.v (`ops/sh_jv.py::sh_jv_halo`, the
row block of `jl_tpu/parallel/halo.py::sharded_sh_jv`) on the CPU, where
it is its plain version `sh_jv_halo_plain`: a field split into row blocks,
each given its neighbours' 2 rows and the global-edge flags, against the
whole-field Neumann J.v (`sh_jv_plain`) and the JAX package's
`sh_jv_reference`.

Blocks: 2, 3 and 8, even and ragged (the flagship's 151 rows, 37 x 23),
blocks of 2 rows, a batch of K = 1 and 3 fields.  Tolerance: relative to
max |reference|, 1e-13 in f64 (the halo version multiplies by 1/h^2 where
the whole-field one divides by h^2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu.ops.pallas_sh import sh_jv_reference
from bifurcationkit.jl_tpu_torch.ops.sh_jv import (sh_jv_by_blocks,
                                                   sh_jv_halo,
                                                   sh_jv_halo_plain,
                                                   sh_jv_plain)

CASES = [((152, 100), 2), ((152, 100), 8), ((151, 100), 3), ((37, 23), 3),
         ((16, 9), 8), ((64, 32), 8), ((6, 5), 3)]


def _inputs(shape, K, seed=11):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape)
    v = rng.standard_normal((K,) + shape)
    scal = np.array([-0.1, 1.3, 1.0 / 0.0241, 1.0 / 0.0313])
    return u, v, scal


def _bounds(N, nb):
    return [int(b) for b in np.linspace(0, N, nb + 1).round()]


def _rel(out, ref):
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("shape,nb", CASES)
def test_blocks_match_whole_field(shape, nb, K):
    u, v, scal = _inputs(shape, K)
    ut, vt, st = (torch.tensor(a) for a in (u, v, scal))
    bounds = _bounds(shape[0], nb)
    out = sh_jv_by_blocks(ut, vt, st, bounds).numpy()
    assert _rel(out, sh_jv_plain(ut, vt, st).numpy()) < 1e-13
    ref = np.stack([np.asarray(sh_jv_reference(jnp.asarray(u),
                                               jnp.asarray(v[k]),
                                               jnp.asarray(scal)))
                    for k in range(K)])
    assert _rel(out, ref) < 1e-13


def test_single_block_is_the_neumann_field():
    """One block flagged at both ends is the whole-field Neumann J.v; a
    (B, M) v without a batch dimension takes (2, M) halos."""
    u, v, scal = _inputs((9, 7), 1)
    ut, vt, st = (torch.tensor(a) for a in (u, v[0], scal))
    out = sh_jv_halo(ut, vt, None, None, st, True, True)
    assert _rel(out.numpy(), sh_jv_plain(ut, vt, st).numpy()) < 1e-13
    mid = sh_jv_halo_plain(ut[2:6], vt[2:6], vt[0:2], vt[6:8], st, False,
                           False)
    assert _rel(mid.numpy(), out[2:6].numpy()) < 1e-13


def test_halo_rows_are_read_only_off_the_edges():
    """At a flagged edge the halo given is ignored (the edge row is
    replicated); off an edge it enters the product."""
    u, v, scal = _inputs((8, 6), 2)
    ut, vt, st = (torch.tensor(a) for a in (u, v, scal))
    junk = torch.full((2, 2, 6), 1e3, dtype=torch.float64)
    a = sh_jv_halo(ut, vt, junk, junk, st, True, True)
    b = sh_jv_halo(ut, vt, None, None, st, True, True)
    assert torch.equal(a, b)
    c = sh_jv_halo(ut, vt, junk, None, st, False, True)
    assert not torch.allclose(a[..., :2, :], c[..., :2, :])
    assert torch.equal(a[..., 2:, :], c[..., 2:, :])
