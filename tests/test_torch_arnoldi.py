"""Parity of the port's matrix-free non-symmetric eigensolvers
(`jl_tpu_torch/linalg/eig.py::ArnoldiEig`, `ShiftInvertEig`) with the JAX
package's, on the Brusselator jacobian at 16 sites (32 unknowns) given as
a five-diagonal `DIAMatrix`, near its Hopf point so that the rightmost
eigenvalues are a complex pair.  Both packages get the same matrix and
the same start vector `v0`, made with numpy from a seed.

Tolerances, and why:
* a full Krylov space (krylov_dim = 32): every Ritz value is an
  eigenvalue, to 1e-10 relative to max |lambda| of the dense LAPACK
  eigenvalues — both packages and LAPACK differ only by rounding;
* a partial space (the eigensolve inside the continuation): the two
  packages build the same Arnoldi factorization from the same v0 and
  solve the same Hessenberg problem with LAPACK on the host, so their
  Ritz values agree to 1e-9 relative to the largest one, far inside the
  solvers' own tolerance (1e-9 on the Ritz residuals);
* shift-invert: the rightmost eigenvalues, the complex pair first, match
  the dense eigenvalues nearest the shift and each other to 1e-8 relative
  (inner GMRES to rtol 1e-10, Ritz residuals to 1e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu.ops import DIAMatrix as JDIA
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.ops import DIAMatrix

N_SITES = 16
N = 2 * N_SITES
OFFSETS = (-N_SITES, -1, 0, 1, N_SITES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jacobian_data(l=0.5, alpha=2.0, beta=5.45, D1=0.008, D2=0.004):
    """The Brusselator jacobian's five diagonals at a perturbed state."""
    n, h = N_SITES, 1.0 / N_SITES
    rng = np.random.default_rng(11)
    u = alpha * (1 + 0.002 * rng.standard_normal(n))
    v = beta / alpha * (1 + 0.002 * rng.standard_normal(n))
    c1, c2 = D1 / (l * h) ** 2, D2 / (l * h) ** 2
    inner = np.r_[0.0, np.ones(n - 1)]           # row 0 of a block: no i-1
    data = np.stack([
        np.r_[np.zeros(n), beta - 2 * u * v],              # -n: dfv/du
        np.r_[c1 * inner, c2 * inner],                      # -1
        np.r_[-2 * c1 - (beta + 1) + 2 * u * v, -2 * c2 - u * u],
        np.r_[c1 * inner[::-1], c2 * inner[::-1]],          # +1
        np.r_[u * u, np.zeros(n)],                          # +n: dfu/dv
    ])
    # out-of-band entries hold nonzero values the product must ignore
    data[0, :n] = rng.standard_normal(n)
    data[4, n:] = rng.standard_normal(n)
    return data


def _dense(data):
    return DIAMatrix(torch.as_tensor(data), OFFSETS).todense().numpy()


def _solve_both(make, data, nev, v0):
    """The same eigensolver config in both packages, on the DIA operator."""
    def jax_side(d, v):
        op = bj.FlatOperator(JDIA(d, OFFSETS).matvec, N)
        vals, _, cv, _ = make(bj)(op, nev, v0=v)
        return vals, cv

    wj, cvj = jax.jit(jax_side)(jnp.asarray(data), jnp.asarray(v0))
    A = DIAMatrix(torch.as_tensor(data), OFFSETS)
    wt, vt, cvt, _ = make(bt)(
        bt.FlatOperator(A, N, torch.float64, torch.device("cpu")), nev,
        v0=torch.as_tensor(v0))
    return np.asarray(wj), bool(cvj), wt.numpy(), vt, cvt


def _v0(seed=5):
    return np.random.default_rng(seed).standard_normal(N)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_arnoldi_lr_full_space():
    data = _jacobian_data()
    lam = np.linalg.eigvals(_dense(data))
    lam = lam[np.lexsort((-lam.imag, -lam.real))]
    wj, cvj, wt, vt, cvt = _solve_both(
        lambda pkg: pkg.ArnoldiEig(krylov_dim=N, restarts=1, which="LR"),
        data, 6, _v0())
    assert cvt and cvj
    assert _rel(wt, lam[:6]) < 1e-10 and _rel(wj, lam[:6]) < 1e-10
    # the rightmost pair is complex and unstable at this l
    assert wt[0].real > 0 and abs(wt[0].imag) > 0.1
    assert wt[0] == np.conj(wt[1])
    # the Ritz vectors are eigenvectors
    J = _dense(data)
    V = vt.numpy()
    assert np.abs(J @ V - V * wt[None, :]).max() < 1e-8 * np.abs(lam).max()


@pytest.mark.parametrize("which", ["LR", "LM"])
def test_arnoldi_partial_space(which):
    data = _jacobian_data()
    wj, cvj, wt, _, cvt = _solve_both(
        lambda pkg: pkg.ArnoldiEig(krylov_dim=20, restarts=3, which=which,
                                   tol=1e-9), data, 4, _v0())
    # unconverged here (the wanted ends of the spectrum are clustered):
    # both packages stop at the same Ritz values and report the same flag
    assert cvt == cvj
    assert _rel(wt, wj) < 1e-9


def test_shift_invert_on_dia_operator():
    data = _jacobian_data()
    wj, cvj, wt, vt, cvt = _solve_both(
        lambda pkg: pkg.ShiftInvertEig(
            sigma=0.0,
            eigsolver=pkg.ArnoldiEig(which="LM", krylov_dim=20, restarts=3,
                                     tol=1e-9),
            linsolver=pkg.GMRES(restart=N, maxiter=2 * N, rtol=1e-10)),
        data, 8, _v0(6))
    lam = np.linalg.eigvals(_dense(data))
    near = lam[np.argsort(np.abs(lam))[:8]]
    near = near[np.lexsort((-near.imag, -near.real))]
    assert cvt and cvj
    assert _rel(wt, near) < 1e-8 and _rel(wt, wj) < 1e-8
    assert wt[0].real > 0 and wt[0].imag > 0 and wt[1] == np.conj(wt[0])
    assert vt.shape == (N, 8)


def test_shift_invert_dense():
    data = _jacobian_data(l=0.45)
    J = _dense(data)
    cfg = dict(sigma=0.1)
    wj, _, _, _ = jax.jit(lambda A, v: bj.ShiftInvertEig(
        eigsolver=bj.ArnoldiEig(which="LM", krylov_dim=N, restarts=1),
        **cfg)(A, 5, v0=v))(jnp.asarray(J), jnp.asarray(_v0()))
    wt, _, cvt, _ = bt.ShiftInvertEig(
        eigsolver=bt.ArnoldiEig(which="LM", krylov_dim=N, restarts=1),
        **cfg)(torch.as_tensor(J), 5, v0=torch.as_tensor(_v0()))
    assert cvt and _rel(wt.numpy(), np.asarray(wj)) < 1e-10
    # below the Hopf point at l = 0.45: every eigenvalue is stable
    assert np.all(wt.numpy().real < 0)
    with pytest.raises(ValueError, match="linsolver"):
        bt.ShiftInvertEig()(bt.FlatOperator(lambda v: v, N), 2)
