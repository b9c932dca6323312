"""The PO codim-2 solvers of `periodic/cop.py`: `cop_bc_sigma` (the
Floquet-boundary minimally augmented test function, real for PD and
complex for NS, solved in complex128 directly) and `cop_solve_block`
(the k-border Schur elimination over one COP factorization).

Blocks are random at a small size (n = 3, m = 4, Ntst = 5: 63 node
unknowns), the same numbers for both packages.  Tolerances: sigma and
the bordered vector against the JAX package and against a dense bordered
solve of the assembled operator to 1e-10 (absolute, the quantities are
O(1)); the adjoint weights of `cop_bc_sigma` as the sigma-row functional
of the dense solve to 1e-10; `cop_solve_block` with k = 2 against the
JAX package and a dense solve to 1e-10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu.periodic import cop as jc
from bifurcationkit.jl_tpu_torch.periodic import cop as tc
from tests._codim2_models import one_thread  # noqa: F401

n, m, Ntst = 3, 4, 5
N = (Ntst * m + 1) * n
TOL = 1e-10


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(1)
    arr = dict(Aint=rng.standard_normal((Ntst, m * n, m * n))
               + 4 * np.eye(m * n),
               B0=rng.standard_normal((Ntst, m * n, n)),
               cT=rng.standard_normal((Ntst, m * n)),
               phi0=rng.standard_normal((Ntst, n)),
               phiI=rng.standard_normal((Ntst, m * n)))
    jb = jc.COPBlocks(**{k: jnp.asarray(v) for k, v in arr.items()},
                      n=n, m=m, Ntst=Ntst)
    tb = tc.COPBlocks(**{k: torch.tensor(v) for k, v in arr.items()},
                      n=n, m=m, Ntst=Ntst)
    return arr, jb, tb


def _dense_abc(arr, s):
    """A_bc: the interior blocks and the boundary rows -s du_0 + du_N."""
    A = np.zeros((N, N), complex)
    for j in range(Ntst):
        r = slice(j * m * n, (j + 1) * m * n)
        A[r, j * m * n:j * m * n + n] = arr["B0"][j]
        A[r, j * m * n + n:(j * m + m) * n + n] = arr["Aint"][j]
    A[-n:, :n] = -s * np.eye(n)
    A[-n:, -n:] += np.eye(n)
    return A


def _dense_full(arr):
    """The COP jacobian with its period column and phase row."""
    J = np.zeros((N + 1, N + 1))
    for j in range(Ntst):
        r = slice(j * m * n, (j + 1) * m * n)
        J[r, j * m * n:j * m * n + n] = arr["B0"][j]
        J[r, j * m * n + n:(j * m + m) * n + n] = arr["Aint"][j]
        J[r, N] = arr["cT"][j]
        J[-1, j * m * n:j * m * n + n] += arr["phi0"][j]
        J[-1, j * m * n + n:(j * m + m) * n + n] += arr["phiI"][j]
    J[N - n:N, :n] = np.eye(n)
    J[N - n:N, N - n:N] = -np.eye(n)
    return J


@pytest.mark.parametrize("cplx", [False, True])
def test_bc_sigma_matches_jax_and_dense(blocks, cplx):
    arr, jb, tb = blocks
    rng = np.random.default_rng(2 + cplx)
    a = rng.standard_normal(N) + (1j * rng.standard_normal(N) if cplx else 0)
    b = rng.standard_normal(N) + (1j * rng.standard_normal(N) if cplx else 0)
    sre, sim = (np.cos(0.7), np.sin(0.7)) if cplx else (-1.0, 0.0)
    ref = jc.cop_bc_sigma(jb, jnp.asarray(a), jnp.asarray(b), sre, sim)
    got = tc.cop_bc_sigma(tb, torch.tensor(a), torch.tensor(b), sre, sim,
                          adjoint=True)
    for x, y in zip(ref, got[:4]):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                   atol=TOL)
    M = np.zeros((N + 1, N + 1), complex)
    M[:N, :N] = _dense_abc(arr, sre + 1j * sim)
    M[:N, N] = a
    M[N, :N] = np.conj(b)
    e = np.zeros(N + 1)
    e[-1] = 1.0
    sol = np.linalg.solve(M, e)
    sig, v = complex(got[0]) + 1j * complex(got[1]), \
        got[2].numpy() + 1j * got[3].numpy()
    assert abs(sig - sol[-1]) <= TOL
    np.testing.assert_allclose(v, sol[:N], rtol=0, atol=TOL)
    # the adjoint weights: sigma of [r; 0] as sum Wc.r_c + Wb.r_b
    Wc, Wb = got[4].numpy().reshape(-1), got[5].numpy()
    for seed in (3, 4):
        r = np.random.default_rng(seed).standard_normal(N)
        want = np.linalg.solve(M, np.concatenate([r, [0.0]]))[-1]
        assert abs(np.sum(Wc * r[:-n]) + np.sum(Wb * r[-n:]) - want) <= TOL


def test_bc_sigma_real_case_stays_real(blocks):
    _, _, tb = blocks
    a = torch.ones(N, dtype=torch.float64)
    sr, si, vr, vi = tc.cop_bc_sigma(tb, a, a, -1.0)
    assert sr.dtype == torch.float64 and not vr.is_complex()
    assert float(si) == 0.0 and float(vi.abs().max()) == 0.0


def test_solve_block_k2_matches_jax_and_dense(blocks):
    arr, jb, tb = blocks
    rng = np.random.default_rng(9)
    R = rng.standard_normal(N + 1)
    C = rng.standard_normal((N + 1, 2))
    D = rng.standard_normal((2, N + 1))
    E = rng.standard_normal((2, 2))
    s = rng.standard_normal(2)
    xj, yj = jc.cop_solve_block(jb, *(jnp.asarray(z) for z in (R, C, D, E,
                                                                s)))
    xt, yt = tc.cop_solve_block(tb, *(torch.tensor(z) for z in (R, C, D, E,
                                                                s)))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=TOL)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)
    big = np.block([[_dense_full(arr), C], [D, E]])
    sol = np.linalg.solve(big, np.concatenate([R, s]))
    np.testing.assert_allclose(np.concatenate([xt.numpy(), yt.numpy()]),
                               sol, rtol=0, atol=TOL)
