"""Parity of the rest of the port's `linalg/` with the JAX package's:
`SubspaceEig`, the batched GMRES (`GMRES.solve_block`), `BiCGStab`, the
two preconditioners and the generalized eigensolvers.  Both packages get
the same matrices, right-hand sides and start blocks, made with numpy
from a seed (mirrors `test_misc_solvers.py:14-66`, `test_gev_device.py`,
`test_linear.py:79` and `test_device_eig.py:103`).

Tolerances, and why:
* `SubspaceEig` from the same start block: the Ritz values to 1e-10
  absolute (the same subspace, LAPACK on the host on both sides; they
  differ by rounding only); against the dense eigenvalues, cold 1e-2 and
  warm 1e-5 as the JAX test;
* the batched GMRES: each column exactly what the single-vector call
  gives it — the same matvec count, the solution to 1e-12 relative (the
  batched products sum in another order) — and to 1e-10 of the JAX
  package's vmapped GMRES (both solve to rtol 1e-11);
* `BiCGStab`: the same iteration count as the JAX package and the
  solution to 1e-9 relative (both to rtol 1e-12);
* the preconditioners: the operator applied to a vector to 1e-12 of the
  JAX package's (P does not depend on the basis of the invariant
  subspace); the preconditioned GMRES solves in the same matvecs;
* the generalized eigenvalues: the finite ones to 1e-10 of the JAX
  package's host QZ, the pencil residual of each vector below 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import block_diag

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.linalg import (BlockJacobiPrecond as JBJ,
                                          DenseGEig as JDG,
                                          PartialSchurPrecond as JPS)
from bifurcationkit.jl_tpu.linalg.eig import SubspaceEig as JSub
from bifurcationkit.jl_tpu.linalg.geig import dense_gev as jdense_gev
import bifurcationkit.jl_tpu_torch as bt

CPU = torch.device("cpu")
DT = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=DT)


def _monodromy_like(seed=5, bulk=150):
    """A few dominant multipliers over a decaying bulk (the Floquet shape
    `SubspaceEig` exists for; `test_device_eig.py:103`)."""
    rng = np.random.default_rng(seed)
    mu = [1.0, 0.97, 0.6 * np.exp(1j)] + list(
        rng.uniform(0.001, 0.1, bulk)
        * np.exp(1j * rng.uniform(-3, 3, bulk)))
    blocks = []
    for m in mu:
        m = complex(m)
        if abs(m.imag) < 1e-12:
            blocks.append(np.array([[m.real]]))
        else:
            blocks.append(np.array([[m.real, m.imag], [-m.imag, m.real]]))
    D = block_diag(*blocks)
    n = D.shape[0]
    V = rng.standard_normal((n, n))
    A = np.linalg.solve(V, D @ V)
    wref = np.linalg.eigvals(A)
    return A, wref[np.lexsort((-wref.imag, -np.abs(wref)))]


def test_subspace_eig_monodromy_like():
    """The port's own random start, then a warm restart from its
    Re/Im-interleaved seed (`test_device_eig.py:103`)."""
    A, wref = _monodromy_like()
    wref = wref[:4]
    At = _t(A)
    op = bt.FlatOperator(lambda v: At @ v, A.shape[0], DT, CPU,
                         block_op=lambda X: X @ At.T)
    eig = bt.SubspaceEig(sweeps=2, krylov_blocks=3, extra=4, tol=1e-6)
    vals, vecs, _, _ = eig(op, 4)
    err = np.max(np.abs(np.sort_complex(vals.numpy())
                        - np.sort_complex(wref)))
    assert err < 1e-2, err
    v0 = eig.make_seed(vecs, eig.seed_cols(4))
    assert v0.shape == (A.shape[0], 8)
    vals2, _, _, _ = eig(op, 4, v0=v0)
    err2 = np.max(np.abs(np.sort_complex(vals2.numpy())
                         - np.sort_complex(wref)))
    assert err2 < 1e-5, err2
    assert err2 < err / 10


def test_subspace_eig_matches_jax_same_start():
    """The same start block in both packages: the same Ritz values, the
    same converged flag, the same warm-start seed."""
    A, _ = _monodromy_like(seed=8, bulk=60)
    n = A.shape[0]
    v0 = np.random.default_rng(3).standard_normal((n, 10))
    cfg = dict(sweeps=3, krylov_blocks=2, extra=4, tol=1e-6)

    def jax_side(Aj, v):
        eig = JSub(**cfg)
        vals, vecs, cv, _ = eig(bj.FlatOperator(lambda x: Aj @ x, n), 6,
                                v0=v)
        return vals, eig.make_seed(vecs, 10), cv

    wj, sj, cvj = jax.jit(jax_side)(jnp.asarray(A), jnp.asarray(v0))
    At = _t(A)
    eig = bt.SubspaceEig(**cfg)
    wt, vt, cvt, _ = eig(bt.FlatOperator(lambda x: At @ x, n, DT, CPU),
                         6, v0=_t(v0))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-10)
    assert cvt == bool(cvj)
    # the seeds span the same Ritz directions (each vector's scale and
    # phase are LAPACK's, the same on both sides)
    np.testing.assert_allclose(eig.make_seed(vt, 10).numpy(), np.asarray(sj),
                               atol=1e-8)


def _gmres_case(n=60, k=5, seed=2):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    B = rng.standard_normal((k, n))
    B[1] *= 1e-3                     # converges on another schedule
    B[3] = 0.0                       # done before the first matvec
    w, V = np.linalg.eig(A)
    B[4] = np.real(V[:, np.argmax(w.real)] + V[:, np.argmax(w.real)].conj())
    d = 1.0 / np.diag(A)
    return A, B, d


@pytest.mark.parametrize("precond", [False, True])
def test_gmres_block_equals_single_columns(precond):
    A, B, d = _gmres_case()
    At, Bt, dt_ = _t(A), _t(B), _t(d)
    pre = (lambda v: v * dt_) if precond else None
    gm = bt.GMRES(restart=8, maxiter=60, rtol=1e-11, precond=pre)
    X, cv, its = gm.solve_block(lambda V: V @ At.T, Bt)
    for i in range(B.shape[0]):
        x1, c1, it1 = gm(At, Bt[i])
        assert int(its[i]) == it1 and bool(cv[i]) == c1
        scale = max(float(x1.abs().max()), 1e-300)
        assert float((X[i] - x1).abs().max()) <= 1e-12 * scale
    assert int(its[3]) == 0 and float(X[3].abs().max()) == 0.0

    # against the JAX package's vmapped GMRES
    def jax_side(Aj, Bj, dj):
        jpre = (lambda v: v * dj) if precond else None
        jg = bj.GMRES(restart=8, maxiter=60, rtol=1e-11, precond=jpre)
        return jax.vmap(lambda b: jg(Aj, b)[0])(Bj)

    Xj = np.asarray(jax.jit(jax_side)(jnp.asarray(A), jnp.asarray(B),
                                      jnp.asarray(d)))
    np.testing.assert_allclose(X.numpy(), Xj, rtol=0,
                               atol=1e-10 * np.abs(Xj).max())


def test_bicgstab_matches_jax():
    rng = np.random.default_rng(0)
    n = 40
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    xj, cvj, kj = jax.jit(lambda Aj, bj_: bj.BiCGStab(
        rtol=1e-12, maxiter=500)(Aj, bj_))(jnp.asarray(A), jnp.asarray(b))
    xt, cvt, kt = bt.BiCGStab(rtol=1e-12, maxiter=500)(_t(A), _t(b))
    assert cvt and bool(cvj) and kt == int(kj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9)
    np.testing.assert_allclose(A @ xt.numpy(), b, atol=1e-7)


def test_partial_schur_precond_matches_jax():
    rng = np.random.default_rng(2)
    n = 40
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    D = np.diag(np.concatenate([[50.0, 30.0], np.linspace(1.0, 2.0, n - 2)]))
    J = Q @ D @ Q.T
    v = rng.standard_normal(n)
    Pj = JPS.from_matrix(jnp.asarray(J), nev=2)
    Pt = bt.PartialSchurPrecond.from_matrix(_t(J), nev=2)
    np.testing.assert_allclose(Pt(_t(v)).numpy(), np.asarray(Pj(v)),
                               atol=1e-12 * np.abs(v).max())
    solj = jax.jit(lambda Jj, bj_: bj.GMRES(
        restart=15, maxiter=60, rtol=1e-10, precond=Pj)(Jj, bj_))(
        jnp.asarray(J), jnp.asarray(v))
    sol, cv, it = bt.GMRES(restart=15, maxiter=60, rtol=1e-10,
                           precond=Pt)(_t(J), _t(v))
    _, _, it2 = bt.GMRES(restart=15, maxiter=60, rtol=1e-10)(_t(J), _t(v))
    assert cv and it == int(solj[2]) and it <= it2
    np.testing.assert_allclose(sol.numpy(), np.asarray(solj[0]), rtol=1e-9)


def test_block_jacobi_precond_matches_jax():
    rng = np.random.default_rng(3)
    nb, bs = 10, 4
    blocks = rng.standard_normal((nb, bs, bs)) + 5 * np.eye(bs)[None]
    v = rng.standard_normal(nb * bs)
    out_j = np.asarray(JBJ.from_blocks(jnp.asarray(blocks))(jnp.asarray(v)))
    out_t = bt.BlockJacobiPrecond.from_blocks(_t(blocks))(_t(v)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-12)
    np.testing.assert_allclose(out_t[:bs], np.linalg.solve(blocks[0], v[:bs]),
                               atol=1e-12)


def _pencils():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((20, 20))
    B = rng.standard_normal((20, 20)) + 5 * np.eye(20)
    rng1 = np.random.default_rng(1)
    n, k = 10, 3                   # B of rank n - k: k infinite eigenvalues
    As = rng1.standard_normal((n, n))
    Bs = rng1.standard_normal((n, n - k)) @ rng1.standard_normal((n - k, n))
    rng2 = np.random.default_rng(2)
    A14 = rng2.standard_normal((14, 14))
    B14 = rng2.standard_normal((14, 14)) + 3.0 * np.eye(14)
    return [(A, B), (As, Bs), (A14, B14)]


@pytest.mark.parametrize("case", range(3))
def test_dense_gev_matches_jax(case):
    A, B = _pencils()[case]
    wj = np.asarray(jax.jit(lambda a, b: jdense_gev(a, b)[0])(
        jnp.asarray(A), jnp.asarray(B)))
    wt, vt = bt.dense_gev(_t(A), _t(B))
    wt, vt = wt.numpy(), vt.numpy()
    fin_t, fin_j = np.isfinite(wt.real), np.isfinite(wj.real)
    assert fin_t.sum() == fin_j.sum() == (7 if case == 1 else A.shape[0])
    np.testing.assert_allclose(wt[fin_t], wj[fin_j], atol=1e-10)
    assert np.all(np.diff(wt[fin_t].real) <= 1e-12)
    for i in range(4):
        x = vt[:, i]
        r = A @ x - wt[i] * (B @ x)
        assert np.linalg.norm(r) < 1e-8 * (abs(wt[i]) + 1) \
            * np.linalg.norm(x)


def test_geig_solvers():
    """`DenseGEig`, `gev`, `EigenMassMatrix` and `IterativeGEig` (dense
    and matrix-free) against the JAX package's `DenseGEig`
    (`test_misc_solvers.py:27`)."""
    rng = np.random.default_rng(1)
    n = 30
    A = rng.standard_normal((n, n))
    A = A + A.T
    B = np.eye(n) * 2.0
    wj = np.asarray(JDG()(jnp.asarray(A), jnp.asarray(B), 3)[0])
    At, Bt = _t(A), _t(B)
    wd, vd, cv, _ = bt.gev(bt.DenseGEig(), At, Bt, 3)
    np.testing.assert_allclose(wd.numpy(), wj, atol=1e-10)
    we, _, _, _ = bt.EigenMassMatrix(B=Bt)(At, 3)
    np.testing.assert_allclose(we.numpy(), wj, atol=1e-10)
    wi, _, _, _ = bt.IterativeGEig()(At, Bt, 3)
    np.testing.assert_allclose(np.sort(wi.numpy().real), np.sort(wj.real),
                               rtol=1e-6)
    Aop = bt.FlatOperator(lambda v: At @ v, n, DT, CPU)
    wm, _, _, _ = bt.IterativeGEig(linsolver=bt.DenseLS())(Aop, Bt, 3)
    np.testing.assert_allclose(np.sort(wm.numpy().real), np.sort(wj.real),
                               rtol=1e-6)
