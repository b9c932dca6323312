"""Parity of the port's sparse containers (`jl_tpu_torch/ops/sparse.py`)
and of the DIA kernel's plain version (`ops/dia_spmv.py::dia_spmv_plain`)
with the JAX package: `DIAMatrix.matvec`, `todense`, `from_dense`,
`ELLMatrix.from_scipy`, `BSRMatrix.diag_blocks`, `laplacian_1d_dia`, and
the Pallas DIA kernel run in interpret mode.  Inputs are made with numpy
from a seed and handed to both packages.

Tolerances, and why: 1e-12 relative to max |reference| for every product
and 0 for every container built from the same numbers — both packages sum
the same f64 terms, in the same order (the Pallas kernel and the plain
version both add the diagonals' terms one after another).  GMRES on a DIA
operator: solution residual 1e-8 as in `test_sparse.py`, and the port's
solution to 1e-10 of the JAX one (both stop at rtol 1e-12 with the same
CGS2 Arnoldi).

The DIA cases put random, finite, nonzero values in the out-of-band
entries of `data` (those whose column i + off lies outside [0, n)): the
product must ignore them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.ops import (BSRMatrix as JBSR, DIAMatrix as JDIA,
                                       ELLMatrix as JELL,
                                       laplacian_1d_dia as j_lap)
from bifurcationkit.jl_tpu.ops import pallas_spmv
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.ops import (BSRMatrix, DIAMatrix, ELLMatrix,
                                             dia_spmv, laplacian_1d_dia)
from bifurcationkit.jl_tpu_torch.ops.dia_spmv import (dia_spmv_bytes,
                                                      dia_spmv_flops,
                                                      dia_spmv_plain)

RTOL = 1e-12


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300)


def _dia_case(n, offsets, K, seed):
    """Random data with nonzero out-of-band entries, and K vectors."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n))
    v = rng.standard_normal((K, n) if K else (n,))
    return data, v


# (n, offsets, K): the Brusselator's 5 diagonals at 16 sites, offsets beyond
# one 1024-row TILE of the Pallas kernel, a ragged n with offsets >= n
DIA_CASES = [(32, (-16, -1, 0, 1, 16), 0), (32, (-16, -1, 0, 1, 16), 8),
             (2 * pallas_spmv.TILE, (-1500, -3, 0, 1, 1100), 0),
             (1000, (-1000, -37, 0, 5, 999, 1200), 3)]


@pytest.mark.parametrize("n,offsets,K", DIA_CASES)
def test_dia_plain_matches_jax_matvec(n, offsets, K):
    data, v = _dia_case(n, offsets, K, seed=n + K)
    Aj = JDIA(jnp.asarray(data), offsets)
    mv = jax.jit(Aj.matvec)
    ref = np.stack([mv(jnp.asarray(x)) for x in v]) if K else mv(
        jnp.asarray(v))
    At = DIAMatrix(torch.as_tensor(data), offsets)
    _close(dia_spmv_plain(At, torch.as_tensor(v)).numpy(), ref)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = dia_spmv.launches
    _close(At(torch.as_tensor(v)).numpy(), ref)
    assert dia_spmv.launches == before


@pytest.mark.parametrize("n,offsets", [(2 * pallas_spmv.TILE,
                                        (-2000, -1, 0, 1, 1500)),
                                       (777, (-5, 0, 3))])
def test_dia_plain_matches_pallas_interpret(n, offsets):
    data, v = _dia_case(n, offsets, 0, seed=n)
    out = pallas_spmv.dia_spmv_pallas(JDIA(jnp.asarray(data), offsets),
                                      jnp.asarray(v), interpret=True)
    At = DIAMatrix(torch.as_tensor(data), offsets)
    _close(dia_spmv_plain(At, torch.as_tensor(v)).numpy(), out)


def test_dia_dense_round_trip():
    rng = np.random.default_rng(0)
    n, offsets = 50, (-2, 0, 1)
    A = sum(np.diag(rng.standard_normal(n - abs(o)), o) for o in offsets)
    Dj = JDIA.from_dense(A, offsets)
    Dt = DIAMatrix.from_dense(A, offsets, device="cpu")
    np.testing.assert_array_equal(Dt.data.numpy(), np.asarray(Dj.data))
    todense = jax.jit(lambda D: D.todense())
    np.testing.assert_array_equal(Dt.todense().numpy(),
                                  np.asarray(todense(Dj)))
    np.testing.assert_array_equal(Dt.todense().numpy(), A)
    assert Dt.shape == Dj.shape and Dt.nnz == Dj.nnz
    # from a tensor, it stays on the tensor's device
    assert DIAMatrix.from_dense(torch.as_tensor(A), offsets).data.device \
        == torch.device("cpu")
    # todense of out-of-band data drops it, as the JAX package does
    data, _ = _dia_case(40, (-20, -1, 0, 3, 25), 0, seed=9)
    np.testing.assert_array_equal(
        DIAMatrix(torch.as_tensor(data), (-20, -1, 0, 3, 25)).todense(),
        np.asarray(todense(JDIA(jnp.asarray(data), (-20, -1, 0, 3, 25)))))


def test_laplacian_1d_dia():
    n, h = 33, 1.0 / 34
    Lj, Lt = j_lap(n, h), laplacian_1d_dia(n, h, device="cpu")
    assert Lt.offsets == Lj.offsets
    np.testing.assert_array_equal(Lt.data.numpy(), np.asarray(Lj.data))
    v = np.random.default_rng(1).standard_normal(n)
    _close(Lt(torch.as_tensor(v)).numpy(), Lj(jnp.asarray(v)))


def test_ell_matches_jax():
    rng = np.random.default_rng(1)
    A = sp.random(60, 60, density=0.1, random_state=2,
                  data_rvs=rng.standard_normal) + 5 * sp.eye(60)
    Ej, Et = JELL.from_scipy(A), ELLMatrix.from_scipy(A, device="cpu")
    np.testing.assert_array_equal(Et.data.numpy(), np.asarray(Ej.data))
    np.testing.assert_array_equal(Et.cols.numpy(), np.asarray(Ej.cols))
    assert Et.shape == Ej.shape and Et.nnz == Ej.nnz
    v = rng.standard_normal(60)
    _close(Et(torch.as_tensor(v)).numpy(), jax.jit(Ej.matvec)(jnp.asarray(v)))
    np.testing.assert_array_equal(Et.todense().numpy(),
                                  np.asarray(jax.jit(Ej.todense)()))
    # a batch of vectors, row by row
    V = rng.standard_normal((3, 60))
    _close(Et(torch.as_tensor(V)).numpy(), V @ A.toarray().T)


def test_bsr_matches_jax():
    rng = np.random.default_rng(3)
    nb, k, bs = 6, 3, 4
    blocks = rng.standard_normal((nb, k, bs, bs))
    bcols = np.full((nb, k), -1, np.int64)
    for r in range(nb):
        cols = rng.choice(nb, size=2, replace=False)
        if r not in cols:
            cols[0] = r
        bcols[r, :2] = cols
    Bj = JBSR(jnp.asarray(blocks), jnp.asarray(bcols.astype(np.int32)))
    Bt = BSRMatrix(torch.as_tensor(blocks), torch.as_tensor(bcols))
    assert Bt.shape == Bj.shape and Bt.nnz == Bj.nnz and Bt.bs == Bj.bs
    v = rng.standard_normal(nb * bs)
    _close(Bt(torch.as_tensor(v)).numpy(), jax.jit(Bj.matvec)(jnp.asarray(v)))
    _close(Bt.diag_blocks().numpy(), np.asarray(Bj.diag_blocks()))
    V = rng.standard_normal((2, nb * bs))
    _close(Bt(torch.as_tensor(V)).numpy(),
           np.stack([Bt(torch.as_tensor(x)).numpy() for x in V]))


def test_dia_in_gmres():
    """DIA as a matrix-free jacobian: the Laplacian system by GMRES, as
    `test_sparse.py::test_dia_in_gmres_newton`, in both packages."""
    n = 64
    Dj, Dt = j_lap(n, 1.0 / (n + 1)), laplacian_1d_dia(n, 1.0 / (n + 1),
                                                        device="cpu")
    sol_j, cv_j, it_j = jax.jit(
        lambda b: bj.GMRES(restart=64, maxiter=200, rtol=1e-12)(Dj, b))(
        jnp.ones(n))
    sol_t, cv_t, it_t = bt.GMRES(restart=64, maxiter=200, rtol=1e-12)(
        Dt, torch.ones(n, dtype=torch.float64))
    assert cv_t and bool(cv_j) and it_t == int(it_j)
    np.testing.assert_allclose(Dt(sol_t).numpy(), np.ones(n), atol=1e-8)
    _close(sol_t.numpy(), sol_j, rtol=1e-10)


def test_dia_bytes_and_flops():
    # in-band entries only: offsets beyond n move nothing
    assert dia_spmv_bytes(10, (-3, 0, 12), 2, 8) == (7 + 10 + 0 + 40) * 8
    assert dia_spmv_flops(10, (-3, 0, 12), 2) == 2 * 2 * 17


@pytest.mark.parametrize("make", [
    lambda **d: laplacian_1d_dia(8, 0.1, **d),
    lambda **d: DIAMatrix.from_dense(np.eye(4), (0,), **d),
    lambda **d: ELLMatrix.from_scipy(sp.eye(4), **d),
    lambda **d: bt.models.brusselator_1d(n=4, **d),
    lambda **d: bt.models.chan(n=5, **d)],
    ids=["laplacian_1d_dia", "from_dense", "from_scipy", "brusselator_1d",
         "chan"])
def test_constructors_need_the_card_unless_told(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    make(device="cpu")
