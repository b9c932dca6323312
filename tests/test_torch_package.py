"""The port's package boundary: it imports neither JAX nor the JAX package,
its entry points go to the card unless told otherwise, and its interop
helpers carry data across both ways."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels

REPO = Path(__file__).resolve().parent.parent


def test_imports_without_jax():
    """Every submodule of the port loads in a fresh interpreter with
    neither `jax` nor `bifurcationkit.jl_tpu` in `sys.modules`."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bifurcationkit.jl_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('bifurcationkit.jl_tpu.')\n"
        "       or m == 'bifurcationkit.jl_tpu']\n"
        "assert not bad, bad\n"
        "n = sum(m.startswith('bifurcationkit.jl_tpu_torch.') "
        "for m in sys.modules)\n"
        "print(n)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


# the JAX package's top-level names the port lacked before
EVENTS_AND_ALIASES = (
    "ContinuousEvent", "DiscreteEvent", "PairOfEvents", "SetOfEvents",
    "bif_detect_event", "fold_detect_event", "save_at_event",
    "ODEBifProblem", "PDEBifProblem")
# the codim-2 normal forms, unfoldings and switching
CODIM2 = (
    "bautin_normal_form", "bt_normal_form", "bt_predictors",
    "cusp_normal_form", "get_normal_form_codim2", "newton_bt",
    "zh_normal_form", "hh_normal_form", "bautin_unfolding", "bt_unfolding",
    "hh_unfolding", "zh_unfolding", "predictor_fold_po",
    "predictor_homoclinic_bt", "predictor_ns_hh", "predictor_ns_zh",
    "switch_codim2", "switch_codim2_mf", "switch_codim2_po")
# the periodic-orbit codim-2 curves, normal forms and branch switching
PERIODIC = (
    "continuation_pd", "continuation_ns", "continuation_fold_po",
    "bp_po_branch_switch", "pd_branch_switch", "po_codim2_test_values",
    "get_normal_form_po", "neimark_sacker_iooss", "period_doubling_iooss",
    "poincare_return_map", "cop_solve", "cop_solve_bordered")
# the wave, BVP, I/O and plotting surface
WAVE_BVP_UTILS = (
    "BVPCollocation", "BVPModel", "BVPShooting", "BVPTrapezoid",
    "bvp_problem", "discretize", "travelling_wave_problem", "load_branch",
    "save_branch", "save_every_step", "resume_data", "plot_branch",
    "plot_bifurcation_diagram", "plot_periodic_orbit", "savefig")


@pytest.mark.parametrize("name", EVENTS_AND_ALIASES + CODIM2 + PERIODIC
                         + WAVE_BVP_UTILS)
def test_public_names(name):
    """Each name is exported at the top level; the codim-2 ones are the
    same objects as in `codim2` (`normal_forms` for the Bautin form), the
    periodic-orbit ones as in `periodic`, and the ODE/PDE constructors
    alias `BifurcationProblem`."""
    import bifurcationkit.jl_tpu_torch as bt
    from bifurcationkit.jl_tpu_torch import codim2, normal_forms, periodic

    obj = getattr(bt, name)
    if name in CODIM2:
        home = normal_forms if name == "bautin_normal_form" else codim2
        assert getattr(home, name) is obj
    if name in PERIODIC:
        assert getattr(periodic, name) is obj
    if name in ("ODEBifProblem", "PDEBifProblem"):
        assert obj is bt.BifurcationProblem
    if name in WAVE_BVP_UTILS:
        from bifurcationkit.jl_tpu_torch import bvp, utils, wave

        assert any(getattr(home, name, None) is obj
                   for home in (bvp, utils, wave))


def _public(mod):
    """A package's exported names: its public attributes that are not
    submodules, and its lazily loaded submodules."""
    import types

    return ({n for n, v in vars(mod).items() if not n.startswith("_")
             and not isinstance(v, types.ModuleType)}
            | set(getattr(mod, "_LAZY_SUBMODULES", ())))


# the JAX package's subpackages, each compared with the port's
SUBPACKAGES = ("", "models", "bvp", "codim2", "continuation", "core",
               "detection", "linalg", "native", "normal_forms", "ops",
               "parallel", "periodic", "utils", "wave")
# names the port does not export: the Pallas entry that the CUDA kernel
# `csrc/dia_spmv.cu` replaces (`ops.dia_spmv` on the card)
EXEMPT = {"ops": {"dia_spmv_pallas"}}


def test_subpackage_list_is_the_jax_packages():
    import pkgutil

    import bifurcationkit.jl_tpu as bj

    assert {m.name for m in pkgutil.iter_modules(bj.__path__)
            if m.ispkg} == set(SUBPACKAGES) - {""}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_export_sets_cover_the_jax_package(sub):
    """Every name the JAX package exports at the top level and from each
    subpackage is exported by the port's counterpart, the Pallas entry
    `ops.dia_spmv_pallas` excepted."""
    import importlib

    suffix = f".{sub}" if sub else ""
    jmod = importlib.import_module("bifurcationkit.jl_tpu" + suffix)
    tmod = importlib.import_module("bifurcationkit.jl_tpu_torch" + suffix)
    assert _public(jmod) - _public(tmod) - EXEMPT.get(sub, set()) == set()


def test_entry_point_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.swift_hohenberg_2d(Nx=8, Ny=6)
    prob = tmodels.swift_hohenberg_2d(Nx=8, Ny=6, device="cpu")
    assert prob.u0.device.type == "cpu"
    assert prob.u0.dtype == torch.float64


def test_tf32_is_refused(monkeypatch):
    import bifurcationkit.jl_tpu_torch as bt

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    prob = tmodels.swift_hohenberg_2d(Nx=8, Ny=6, device="cpu")
    with pytest.raises(RuntimeError, match="allow_tf32"):
        bt.newton(prob)


def test_interop_round_trip():
    u = np.random.default_rng(0).standard_normal((5, 4))
    ut, par = interop.state_from_numpy(u, {"l": -0.1, "nu": 1.3}, "cpu")
    assert ut.dtype == torch.float64 and par["l"].dim() == 0
    u2, par2 = interop.state_to_numpy(ut, par)
    np.testing.assert_array_equal(u2, u)
    assert par2 == {"l": -0.1, "nu": 1.3}
