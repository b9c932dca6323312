"""Dry-run leg 7 on 2 gloo ranks on the CPU: the matrix-free fold MA
problem of the 16-site Brusselator in (l, beta), its sigma system a
replicated scalar tail on a head split by sites over `space`: the
anchors (v, w, sigma) from the nested GMRES sigma and adjoint solves,
and one Govaerts operator apply, on the sharded model's closed-form
derivatives (`parallel/models.py`).

Against one device (the unsharded `brusselator_1d`, every derivative by
AD: 1e-10 relative, the same GMRES matvecs in each solve) and against
the JAX dry run's leg 7 on 2 devices of the conftest's CPU mesh with the
flat vectors sharded as `__graft_entry__.py` shards them (1e-8, the JAX
bound), all in the global layout [u; v (; tail)]."""
import pytest
import torch

from bifurcationkit.jl_tpu_torch.parallel import dryrun
from bifurcationkit.jl_tpu_torch.parallel.launch import start_ranks

from _dryrun_jax import N_RANKS, jax_leg7
from _parallel_ranks import rel

RANKS = __file__.replace("test_torch_parallel_leg7.py", "_parallel_ranks.py")


@pytest.fixture(scope="module")
def run():
    """(per-rank results, the one-device leg, the JAX leg 7)."""
    ranks = start_ranks(f"{RANKS}:leg7", N_RANKS, dict(n_ranks=N_RANKS),
                        timeout=90)
    try:
        torch.set_num_threads(1)
        one = dryrun.leg7_fold_mf(None, torch.device("cpu"), N_RANKS)
        jx = jax_leg7()
    finally:
        out = ranks.join()
    return out, one, jx


def test_leg7_matches_one_device(run):
    out, one, _ = run
    for r in out:
        for key in ("v", "w", "apply"):
            assert rel(r[key], one[key]) <= 1e-10, key
        assert r["sigma"] == pytest.approx(one["sigma"], rel=1e-10)
        for key in ("sigma_gmres_matvecs", "adjoint_gmres_matvecs"):
            assert r[key] == one[key] > 0


def test_leg7_matches_the_jax_dry_run(run):
    out, _, jx = run
    for r in out:
        for key in ("v", "w", "apply"):
            assert rel(r[key], jx[key]) <= 1e-8, key
            assert rel(r[key], jx[f"{key}_single"]) <= 1e-8, key
        assert r["sigma"] == pytest.approx(jx["sigma"], rel=1e-8)
        assert r["sigma"] == pytest.approx(jx["sigma_single"], rel=1e-8)
