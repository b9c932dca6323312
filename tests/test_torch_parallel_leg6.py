"""Dry-run leg 6 on a real 2 x 2 ("time", "space") mesh of 4 gloo ranks on
the CPU (`dryrun.dryrun_mesh2d(2, 2)`): the Brusselator PO on 8 sites,
its Collocation(Ntst = 4, m = 3) block jacobian placed over both axes as
the JAX dry run places it, gathered over `space` and solved over `time`;
then the matrix-free trapezoid monodromy apply (Trapeze(M = 8), block
GMRES on the space-sharded, batched Brusselator) on v split by sites.

Against one device (`leg6_mesh2d(None, ..., 2, 2)`: 1e-10 relative, the
same GMRES iterations in every slice) and against the JAX dry run's leg 6
rebuilt on a 2 x 2 mesh of 4 devices of the conftest's CPU mesh (1e-8,
the JAX bound).  The 2 x 1 shape of 2 ranks runs in
`test_torch_parallel_dryrun.py`."""
import pytest
import torch

from bifurcationkit.jl_tpu_torch.parallel import dryrun
from bifurcationkit.jl_tpu_torch.parallel.launch import start_ranks

from _dryrun_jax import jax_leg6
from _parallel_ranks import rel

RANKS = __file__.replace("test_torch_parallel_leg6.py", "_parallel_ranks.py")
NT, NS = 2, 2


@pytest.fixture(scope="module")
def run():
    """(per-rank results, the one-device leg, the JAX leg 6)."""
    ranks = start_ranks(f"{RANKS}:leg6", NT * NS, dict(nt=NT, ns=NS),
                        timeout=90)
    try:
        torch.set_num_threads(1)
        one = dryrun.leg6_mesh2d(None, torch.device("cpu"), NT, NS)
        jx = jax_leg6(NT, NS)
    finally:
        out = ranks.join()
    return out, one, jx


def test_leg6_on_a_2x2_mesh_matches_one_device(run):
    out, one, _ = run
    assert len(out) == 4
    for r in out:
        assert (r["nt"], r["ns"]) == (NT, NS)
        assert rel(r["x"], one["x"]) <= 1e-10
        assert rel(r["monodromy_apply"], one["monodromy_apply"]) <= 1e-10
        assert r["gmres_it"] == one["gmres_it"]


def test_leg6_on_a_2x2_mesh_matches_the_jax_dry_run(run):
    out, _, jx = run
    for r in out:
        assert rel(r["x"], jx["x"]) <= 1e-8
        assert rel(r["x"], jx["x_single"]) <= 1e-8
        assert rel(r["monodromy_apply"], jx["monodromy_apply"]) <= 1e-8
        assert rel(r["monodromy_apply"],
                   jx["monodromy_apply_single"]) <= 1e-8
