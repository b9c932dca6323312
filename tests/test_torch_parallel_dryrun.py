"""The port's multi-device dry run (`jl_tpu_torch/parallel/dryrun.py`,
modelled on `__graft_entry__.py::dryrun_multichip`) on 2 gloo ranks on
the CPU: legs 1-3 and 5-7 as in the JAX dry run at 2 devices (leg 6 on
its 2 x 1 time x space mesh), and leg 4 with the flagship's 152 rows cut
to 24 x 100 to keep the file within its time (the card runs leg 4 at
152 x 100 in `chip_smoke.py`).

Each leg is held against the same work on one device with the unsharded
models (`dryrun.single_device`); leg 1 also against the JAX dry run's leg
1 on the same inputs (`_dryrun_jax.py`: the JAX package on 2 devices of
the conftest's CPU mesh, the state sharded as the dry run shards it), and
it adds a PALC corrector with a secant tangent whose u-part is not zero
(the dry run's own tangent has none), held against both too.  Legs 2 and
4 meet the JAX dry run's in `test_torch_parallel_dryrun_leg2_jax.py` and
`..._leg4_jax.py` (one file each, for the JAX package's compile time),
legs 3 and 5-7 in `test_torch_parallel_cop.py`, `..._leg5.py`,
`..._leg6.py` (on a 2 x 2 mesh of 4 ranks) and `..._leg7.py`.  Here legs
3 and 5-7 meet one device to 1e-10 relative (their solutions, monodromy
and applies; the iteration counts equal)."""
import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu_torch.parallel import dryrun

from _dryrun_jax import N_RANKS, ROWS, jax_leg1, jax_mesh, spawn_ranks
from _parallel_ranks import rel


@pytest.fixture(scope="module")
def run():
    """(per-rank results, the port on one device, the JAX dry run's legs)."""
    ranks = spawn_ranks()
    try:
        torch.set_num_threads(1)
        single = dryrun.single_device(N_RANKS, "cpu", ROWS)
        jax_legs = {"leg1": jax_leg1(jax_mesh())}
    finally:
        out = ranks.join()
    return out, single, jax_legs


def test_leg1_brusselator_newton_and_palc(run):
    out, single, jax_legs = run
    ref, jx = single["leg1"], jax_legs["leg1"]
    assert ref["newton_it"] == jx["newton_it"]
    for r in out:
        leg = r["leg1"]
        assert leg["newton_it"] == ref["newton_it"]
        for key in ("u_newton", "u_palc"):
            np.testing.assert_allclose(leg[key], ref[key], rtol=0,
                                       atol=1e-10)
            np.testing.assert_allclose(leg[key], jx[key], rtol=0, atol=1e-8)
        assert leg["palc_res"] <= 1e-8
        assert leg["palc_p"] == pytest.approx(ref["palc_p"], abs=1e-10)
        assert leg["palc_p"] == pytest.approx(jx["palc_p"], abs=1e-8)


def test_leg1_palc_with_a_secant_tangent(run):
    """The corrector with a tangent whose u-part is not zero: the
    normalised PALC dot and the secant's norm divide by the whole state's
    size on every rank, as on one device and in the JAX package."""
    out, single, jax_legs = run
    ref, jx = single["leg1"], jax_legs["leg1"]
    assert np.max(np.abs(ref["tau_u_secant"])) > 1e-2
    for r in out:
        leg = r["leg1"]
        assert leg["secant_res"] <= 1e-8
        for key in ("tau_u_secant", "u_secant"):
            np.testing.assert_allclose(leg[key], ref[key], rtol=0,
                                       atol=1e-10)
            np.testing.assert_allclose(leg[key], jx[key], rtol=0, atol=1e-8)
        for key in ("secant_tau_p", "secant_p"):
            assert leg[key] == pytest.approx(ref[key], abs=1e-10)
            assert leg[key] == pytest.approx(jx[key], abs=1e-8)


def test_leg2_sh_steps_with_detection(run):
    out, single, _ = run
    ref = single["leg2"]
    for r in out:
        leg = r["leg2"]
        assert leg["converged"]
        assert leg["p"] == pytest.approx(ref["p"], abs=1e-8)
        assert leg["n_unstable"] == ref["n_unstable"]


def test_leg4_flagship_width_cut_rows(run):
    out, single, _ = run
    ref = single["leg4"]
    for r in out:
        leg = r["leg4"]
        assert r["transport"] == "direct (gloo, cpu tensors)"
        assert leg["jv_rel_err"] < 1e-10
        assert leg["converged"]
        assert leg["p"] == pytest.approx(ref["p"], abs=1e-8)
        assert leg["n_unstable"] == ref["n_unstable"]
        np.testing.assert_allclose(leg["eigvals"], ref["eigvals"],
                                   rtol=1e-4)


# each new leg's arrays (1e-10 relative) and counts (equal) against one device
NEW_LEGS = {"leg3": (("x", "M"), ()),
            "leg5": (("x", "u_po"), ("newton_it",)),
            "leg6": (("x", "monodromy_apply"), ("nt", "ns", "gmres_it")),
            "leg7": (("v", "w", "apply"),
                     ("sigma_gmres_matvecs", "adjoint_gmres_matvecs"))}


@pytest.mark.parametrize("leg", sorted(NEW_LEGS))
def test_new_legs_match_one_device(run, leg):
    out, single, _ = run
    arrays, counts = NEW_LEGS[leg]
    ref = single[leg]
    for r in out:
        assert r["seconds"][leg] > 0
        assert r["launches"][leg] == {"sh_jv": 0, "dia_spmv": 0}
        for key in arrays:
            assert rel(r[leg][key], ref[key]) <= 1e-10, key
        for key in counts:
            assert r[leg][key] == ref[key], key
    if leg == "leg7":
        assert out[0][leg]["sigma"] == pytest.approx(ref["sigma"], rel=1e-10)
