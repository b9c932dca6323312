"""The port's multi-device path (`jl_tpu_torch/parallel/`) against the
JAX package's (`tests/test_parallel.py`): the same six cases, seeds,
sizes and tolerances, with the port on 4 gloo ranks on the CPU and the
JAX package on the conftest's 8-device CPU mesh; a seventh case holds the
roll-based stencils of `parallel/ops.py` on a row-sharded DTensor.

The ranks (`tests/_parallel_ranks.py::cases`, no JAX) are spawned once
per module, on a free localhost port, and run every case while this
process computes the JAX side; each case is its own test of the
returned results."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import bifurcationkit.jl_tpu as bk
from bifurcationkit.jl_tpu.ops import DIAMatrix
from bifurcationkit.jl_tpu_torch.parallel.launch import start_ranks

from _parallel_ranks import (N_RANKS, brusselator_guess, dia_data,
                             stencil_field)

RANKS = __file__.replace("test_torch_parallel.py", "_parallel_ranks.py")


def _sh_inputs():
    """test_parallel.py's SH J.v inputs (jax.random keys 0 and 1)."""
    u = jax.random.normal(jax.random.PRNGKey(0), (64, 32))
    v = jax.random.normal(jax.random.PRNGKey(1), (64, 32))
    scal = jnp.array([-0.1, 1.3, 1.0 / 0.0241, 1.0 / 0.0241])
    return u, v, scal


def _maps():
    rng = np.random.default_rng(5)
    return np.eye(6) + 0.05 * rng.standard_normal((32, 6, 6))


@pytest.fixture(scope="module")
def run():
    """(per-rank results of the port, the JAX package's results)."""
    u, v, scal = _sh_inputs()
    ranks = start_ranks(f"{RANKS}:cases", N_RANKS,
                        dict(sh_u=np.asarray(u), sh_v=np.asarray(v),
                             sh_scal=np.asarray(scal), maps=_maps()),
                        timeout=90)
    ref = {}
    try:
        from bifurcationkit.jl_tpu import models
        from bifurcationkit.jl_tpu.ops.pallas_sh import sh_jv_reference
        from bifurcationkit.jl_tpu.parallel.halo import sharded_sh_jv
        from bifurcationkit.jl_tpu.periodic.floquet import \
            monodromy_from_maps

        data, vd = dia_data(0, 8 * 64, (-3, -1, 0, 1, 3))
        ref["dia"] = np.asarray(DIAMatrix(jnp.asarray(data),
                                          (-3, -1, 0, 1, 3)).matvec(
            jnp.asarray(vd)))
        mesh = Mesh(np.array(jax.devices()[:8]), ("space",))
        ref["sh_jv"] = np.asarray(sharded_sh_jv(mesh, u, v, scal))
        ref["sh_jv_single"] = np.asarray(sh_jv_reference(u, v, scal))
        ref["monodromy"] = np.asarray(
            monodromy_from_maps(jnp.asarray(_maps()), method="seq"))
        n_sites = 8 * 8
        prob = models.brusselator_1d(n=n_sites)
        u0 = jax.device_put(jnp.asarray(brusselator_guess(n_sites)),
                            NamedSharding(mesh, P("space")))
        with mesh:
            sol = bk.newton(prob.re_make(u0=u0), bk.NewtonPar(
                tol=1e-8, max_iterations=12,
                linsolver=bk.GMRES(restart=160, maxiter=320, rtol=1e-10)))
        ref["newton_u"] = np.asarray(sol.u)
        ref["newton_converged"] = bool(sol.converged)
        from bifurcationkit.jl_tpu.parallel.ops import sh_residual_2d

        ref["sh_residual"] = np.asarray(sh_residual_2d(
            jnp.asarray(stencil_field()), {"l": -0.1, "nu": 1.3}, 0.3, 0.4))
    finally:
        out = ranks.join()
    return out, ref


def test_sharded_dia_spmv_matches(run):
    out, ref = run
    for r in out:
        np.testing.assert_allclose(r["dia"], r["dia_ref"], atol=1e-12)
        np.testing.assert_allclose(r["dia"], ref["dia"], atol=1e-12)


def test_sharded_spmv_with_sharded_input(run):
    for r in run[0]:
        np.testing.assert_allclose(r["dia_sharded_in"],
                                   r["dia_sharded_in_ref"], atol=1e-12)


def test_pdot_on_every_rank(run):
    total = float(np.sum(np.arange(8 * 16, dtype=np.float64)))
    assert [r["pdot"] for r in run[0]] == [pytest.approx(total)] * N_RANKS


def test_sharded_newton_gmres_matches_jax(run):
    out, ref = run
    assert ref["newton_converged"]
    for r in out:
        assert r["newton_converged"]
        np.testing.assert_allclose(r["newton_u"], ref["newton_u"],
                                   rtol=0, atol=1e-8)


def test_sharded_sh_jv_matches_jax(run):
    out, ref = run
    for r in out:
        np.testing.assert_allclose(r["sh_jv"], ref["sh_jv"], rtol=1e-12,
                                   atol=1e-10)
        np.testing.assert_allclose(r["sh_jv"], ref["sh_jv_single"],
                                   rtol=1e-12, atol=1e-10)


def test_roll_stencils_on_a_sharded_state_match_jax(run):
    """`parallel/ops.py`'s residual takes a DTensor sharded by rows and
    keeps it sharded."""
    out, ref = run
    for r in out:
        assert "Shard(dim=0)" in r["sh_residual_placements"]
        np.testing.assert_allclose(r["sh_residual"], ref["sh_residual"],
                                   rtol=1e-13, atol=1e-12)


def test_bordered_gmres_counts_the_replicated_border_once(run):
    """MatrixFreeBLS under `use_mesh`: GMRES on the raveled [u; p], whose
    p every rank holds, takes the one-device solve's iterations to its
    answer."""
    for r in run[0]:
        assert r["bls_converged"]
        assert r["bls_it"] == r["bls_it_single"]
        np.testing.assert_allclose(r["bls_u"], r["bls_u_single"], rtol=0,
                                   atol=1e-10)
        assert r["bls_p"] == pytest.approx(r["bls_p_single"], abs=1e-10)


class _OneRankReducer:
    """A reducer over one rank: what `use_mesh` installs, without ranks."""

    def reduce(self, t, op):
        return t

    def span(self, n):
        return 0, n


@pytest.fixture
def reducer():
    from bifurcationkit.jl_tpu_torch.core import state

    prev = state.set_reducer(_OneRankReducer())
    yield
    state.set_reducer(prev)


def _solver_calls():
    import torch

    import bifurcationkit.jl_tpu_torch as bt

    A = torch.eye(6, dtype=torch.float64) * 2.0
    b = torch.ones(6, dtype=torch.float64)
    op = bt.FlatOperator(lambda v: A @ v, 6, torch.float64,
                         torch.device("cpu"))
    return {
        "DenseLS": lambda: bt.DenseLS()(A, b),
        "BiCGStab": lambda: bt.BiCGStab()(A, b),
        "IterativeRefinement": lambda: bt.IterativeRefinement()(A, b),
        "DenseEig": lambda: bt.DenseEig()(A, 2),
        "LOBPCGEig": lambda: bt.LOBPCGEig()(op, 2),
        "SubspaceEig": lambda: bt.SubspaceEig()(op, 2),
        "ArnoldiEig on a dense jacobian": lambda: bt.ArnoldiEig()(A, 2),
        "MatrixBLS": lambda: bt.MatrixBLS()(A, b, b, 1.0, b, 0.0),
        "LSFromBLS": lambda: bt.LSFromBLS()(torch.eye(7, dtype=torch.float64),
                                            torch.ones(7,
                                                       dtype=torch.float64)),
    }


@pytest.mark.parametrize("name", sorted(_solver_calls()))
def test_unreduced_solvers_refuse_a_partitioned_state(reducer, name):
    """Solvers whose reductions do not go through the cross-rank reducer
    raise inside `use_mesh`, where they would return one rank's partial
    answer."""
    with pytest.raises(NotImplementedError, match=name):
        _solver_calls()[name]()


def test_continuation_kernels_check_their_partition(reducer):
    """Kernels of a problem without `n_global` refuse to run inside
    `use_mesh`; a row-partitioned problem's refuse to run outside it."""
    import bifurcationkit.jl_tpu_torch as bt
    from bifurcationkit.jl_tpu_torch.continuation.engine import ContIterable
    from bifurcationkit.jl_tpu_torch.core import state

    prob = bt.models.brusselator_1d(n=8, device="cpu", batched=True)
    cp = bt.ContinuationPar(ds=1e-2, dsmax=5e-2, p_min=0.25, p_max=0.8,
                            detect_bifurcation=0)
    kn = ContIterable(prob, bt.PALC(), cp).kernels
    with pytest.raises(NotImplementedError, match="continuation kernels"):
        kn.newton_fixed(prob.u0, kn.as_p(0.3), prob.params)
    part = prob.re_make()
    object.__setattr__(part, "n_global", 2 * 8)
    kp = ContIterable(part, bt.PALC(), cp).kernels
    assert kp.n_state == 16
    kp.newton_fixed(prob.u0, kp.as_p(0.3), prob.params)
    prev = state.set_reducer(None)
    try:
        with pytest.raises(RuntimeError, match="inside `parallel.use_mesh"):
            kp.newton_fixed(prob.u0, kp.as_p(0.3), prob.params)
    finally:
        state.set_reducer(prev)


def test_time_sharded_monodromy_matches_jax(run):
    out, ref = run
    for r in out:
        np.testing.assert_allclose(r["monodromy"], ref["monodromy"],
                                   atol=1e-11)


def test_mesh_needs_the_card_unless_told(monkeypatch):
    """`make_mesh` puts the mesh on the card by default and raises where
    there is none, before it touches the process group."""
    import torch

    from bifurcationkit.jl_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
