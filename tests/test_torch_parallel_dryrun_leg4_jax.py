"""The port's dry run on 2 gloo ranks against the JAX dry run's leg 4
(SH2d on the flagship's 100 columns, its 152 rows cut to 24 x 100 for
the file's time, 1 continuation step with detection), run by the JAX
package on 2 devices of the conftest's CPU mesh with the state sharded
by rows as `__graft_entry__.py::dryrun_multichip` shards it
(`_dryrun_jax.py`): p to 1e-8 and the same detection counts on every
rank."""
import pytest

from _dryrun_jax import jax_leg4, jax_mesh, spawn_ranks


@pytest.fixture(scope="module")
def run():
    """(per-rank results of the port, the JAX dry run's leg 4)."""
    ranks = spawn_ranks()
    try:
        jx = jax_leg4(jax_mesh())
    finally:
        out = ranks.join()
    return out, jx


def test_leg4_matches_the_jax_dry_run(run):
    out, jx = run
    assert jx["converged"]
    for r in out:
        leg = r["leg4"]
        assert leg["converged"]
        assert leg["p"] == pytest.approx(jx["p"], abs=1e-8)
        assert leg["n_unstable"] == jx["n_unstable"]
