"""The time-sharded COP solve (`jl_tpu_torch/parallel/cop.py`) and dry-run
leg 3 on 2 gloo ranks on the CPU (`tests/_parallel_ranks.py::cop_legs`):
the Stuart-Landau collocation PO's block jacobian
(Collocation(Ntst = 4, m = 3)) with its intervals split over a
("time",) mesh.

* The plain, bordered and k = 2 border solves against the one-device
  `cop_solve`, `cop_solve_bordered` and `cop_solve_block` to 1e-10
  relative, and the plain one against the JAX package's `cop_solve`
  (`periodic/cop.py:269`) to 1e-8.
* Leg 3's x and its monodromy (the tree product of each rank's interval
  maps) against one device (1e-10) and against the JAX dry run's leg 3 on
  2 devices of the conftest's CPU mesh, the blocks and maps sharded on
  `time` as `__graft_entry__.py` shards them (1e-8, the JAX bound)."""
import pytest
import torch

from bifurcationkit.jl_tpu_torch.parallel import dryrun
from bifurcationkit.jl_tpu_torch.parallel.launch import start_ranks
from bifurcationkit.jl_tpu_torch.periodic import cop

from _dryrun_jax import N_RANKS, jax_leg3
from _parallel_ranks import cop_borders, rel

RANKS = __file__.replace("test_torch_parallel_cop.py", "_parallel_ranks.py")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def run():
    """(per-rank results, the one-device solves, the JAX leg 3)."""
    ranks = start_ranks(f"{RANKS}:cop_legs", N_RANKS,
                        dict(n_ranks=N_RANKS), timeout=90)
    try:
        torch.set_num_threads(1)
        blocks, rhs = dryrun._stuart_landau_cop(CPU, N_RANKS)
        b = {k: torch.tensor(v) for k, v in cop_borders(rhs.shape[0]).items()}
        x, dp = cop.cop_solve_bordered(blocks, rhs, 0.3, b["dR"], b["dzu"],
                                       0.7, 0.5, 0.6, 0.9)
        one = {"leg3": dryrun.leg3_cop(None, CPU, N_RANKS),
               "bordered": (x.numpy(), float(dp)),
               "block": tuple(t.numpy() for t in cop.cop_solve_block(
                   blocks, rhs, b["C"], b["D"], b["E"], b["s"]))}
        jx = jax_leg3()
    finally:
        out = ranks.join()
    return out, one, jx


def test_sharded_cop_solve_matches_one_device_and_jax(run):
    out, one, jx = run
    for r in out:
        x = r["leg3"]["x"]
        assert rel(x, one["leg3"]["x"]) <= 1e-10
        assert rel(x, jx["x_single"]) <= 1e-8
        assert rel(x, jx["x"]) <= 1e-8


def test_sharded_bordered_cop_solve_matches_one_device(run):
    out, one, _ = run
    for r in out:
        x, dp = r["bordered"]
        assert rel(x, one["bordered"][0]) <= 1e-10
        assert dp == pytest.approx(one["bordered"][1], rel=1e-10)


def test_sharded_k_border_cop_solve_matches_one_device(run):
    out, one, _ = run
    for r in out:
        for got, want in zip(r["block"], one["block"]):
            assert rel(got, want) <= 1e-10


def test_leg3_monodromy_tree_product(run):
    out, one, jx = run
    for r in out:
        M = r["leg3"]["M"]
        assert rel(M, one["leg3"]["M"]) <= 1e-10
        assert rel(M, jx["M"]) <= 1e-8
