"""Dry-run leg 5 on 2 gloo ranks on the CPU: the time-sharded functional
PO-MA corrector solve (`parallel/cop.py::POMinAugLSSharded`, the NS kind:
one sharded COP factorization, the k = 2 column solves and the Schur
complement replicated) on the zero-Hopf ODE's orbit at
Collocation(Ntst = 4, m = 4), with the complex borders of
`dryrun.leg5_borders` (numpy draws, fed to both packages).

The solution and the orbit against one device (`POMinAugLS`, 1e-10
relative, the same Newton iterations) and against the JAX dry run's
leg 5 on 2 devices of the conftest's CPU mesh with the blocks sharded on
`time` as `__graft_entry__.py` shards them (1e-8, the JAX bound)."""
import pytest
import torch

from bifurcationkit.jl_tpu_torch.parallel import dryrun
from bifurcationkit.jl_tpu_torch.parallel.launch import start_ranks

from _dryrun_jax import N_RANKS, jax_leg5
from _parallel_ranks import rel

RANKS = __file__.replace("test_torch_parallel_leg5.py", "_parallel_ranks.py")


@pytest.fixture(scope="module")
def run():
    """(per-rank results, the one-device leg, the JAX leg 5)."""
    ranks = start_ranks(f"{RANKS}:leg5", N_RANKS, dict(n_ranks=N_RANKS),
                        timeout=90)
    try:
        torch.set_num_threads(1)
        one = dryrun.leg5_po_ma(None, torch.device("cpu"), N_RANKS)
        jx = jax_leg5(dryrun.leg5_borders(N_RANKS))
    finally:
        out = ranks.join()
    return out, one, jx


def test_leg5_matches_one_device(run):
    out, one, _ = run
    for r in out:
        assert r["newton_it"] == one["newton_it"]
        assert rel(r["u_po"], one["u_po"]) <= 1e-10
        assert rel(r["x"], one["x"]) <= 1e-10


def test_leg5_matches_the_jax_dry_run(run):
    out, _, jx = run
    assert jx["converged"]
    for r in out:
        assert rel(r["u_po"], jx["u_po"]) <= 1e-8
        assert rel(r["x"], jx["x"]) <= 1e-8
        assert rel(r["x"], jx["x_single"]) <= 1e-8
