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
