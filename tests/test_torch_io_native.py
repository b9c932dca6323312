"""The port's `utils/` and `native/` against the JAX package's: a branch
saved by either package loads in the other (the same npz layout), the
checkpoint hook and resume, the host CSR converters of the port's own
copy of the C++ library against the JAX package's on the same CSR,
`BranchLog` files read across both packages, and the plotting recipes.
Exact equality throughout: the same numbers go through the same file
layouts and the same conversions."""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
from bifurcationkit.jl_tpu import native as jnative
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import models as tmodels
from bifurcationkit.jl_tpu_torch import native as tnative


def _cp(pkg):
    return pkg.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-4, p_min=-1.0,
                               p_max=1.0, max_steps=60, detect_bifurcation=3,
                               nev=2, n_inversion=4,
                               newton_options=pkg.NewtonPar(tol=1e-10))


@pytest.fixture(scope="module")
def branches():
    return (bj.continuation(jmodels.pitchfork_1d(p=-0.5), bj.PALC(), _cp(bj)),
            bt.continuation(tmodels.pitchfork_1d(p=-0.5, device="cpu"),
                            bt.PALC(), _cp(bt)))


def _same(a, b):
    assert len(a) == len(b)
    np.testing.assert_array_equal(np.asarray(a.param), np.asarray(b.param))
    assert [s.type for s in a.specialpoint] == \
        [s.type for s in b.specialpoint]
    assert [s.param for s in a.specialpoint] == \
        [s.param for s in b.specialpoint]
    assert len(a.sol) == len(b.sol) and len(a.eig) == len(b.eig)
    for sa, sb in zip(a.sol, b.sol):
        np.testing.assert_array_equal(np.asarray(sa["x"]), np.asarray(sb["x"]))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_branch_files_cross_packages(branches, saver, tmp_path):
    br_j, br_t = branches
    assert any(s.type == "bp" for s in br_t.specialpoint)
    src = br_j if saver == "jax" else br_t
    path = (bj if saver == "jax" else bt).save_branch(
        src, str(tmp_path / "br"))
    by_port = bt.load_branch(path, device="cpu")
    by_jax = bj.load_branch(path)
    _same(by_port, by_jax)
    np.testing.assert_array_equal(by_port.param, np.asarray(src.param))
    assert by_port.sol[-1]["x"].device.type == "cpu"
    assert by_port.specialpoint[0].param == pytest.approx(
        float(src.specialpoint[0].param), abs=0)


def test_save_every_step_and_resume(tmp_path):
    path = str(tmp_path / "ck")
    cp = bt.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-4, p_min=-1.0,
                            p_max=0.0, max_steps=30, detect_bifurcation=0,
                            newton_options=bt.NewtonPar(tol=1e-10))
    br = bt.continuation(tmodels.pitchfork_1d(p=-0.5, device="cpu"),
                         bt.PALC(), cp,
                         finalise_solution=bt.save_every_step(path, 5))
    assert os.path.exists(path + ".npz")
    x, p, res = bt.resume_data(path, device="cpu")
    assert 1 < len(res) <= len(br)
    assert torch.is_tensor(x) and p == res.sol[-1]["p"]
    x_j, p_j, _ = bj.resume_data(path)
    np.testing.assert_array_equal(np.asarray(x_j), x.numpy())


def test_native_library_builds_and_converts():
    """The port's own copy of the C++ library is compiled and loaded; its
    converters give the JAX package's arrays on the same CSR (a banded
    matrix with a ragged row)."""
    assert tnative.loaded()
    A = sp.random(40, 40, density=0.1, random_state=0, format="csr") \
        + sp.diags([1.0, 2.0, 3.0], [-1, 0, 5], shape=(40, 40))
    A = A.tocsr()
    for fn in ("csr_to_ell_arrays", "csr_to_dia_arrays"):
        got = getattr(tnative, fn)(A.indptr, A.indices, A.data)
        ref = getattr(jnative, fn)(A.indptr, A.indices, A.data)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    data, offs = tnative.csr_to_dia_arrays(A.indptr, A.indices, A.data)
    dense = np.zeros((40, 40))
    for d, o in zip(data, offs):
        i = np.arange(40)
        m = (i + o >= 0) & (i + o < 40)
        dense[i[m], i[m] + o] = d[m]
    np.testing.assert_array_equal(dense, A.toarray())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_branch_log_cross_packages(writer, tmp_path):
    path = str(tmp_path / f"log_{writer}.bin")
    log = (jnative if writer == "jax" else tnative).BranchLog(path, 3)
    rows = np.arange(12.0).reshape(4, 3) / 7
    for i, r in enumerate(rows):
        log.append(10 + i, r)
    log.close()
    for mod in (tnative, jnative):
        steps, values = mod.BranchLog.read(path, 3)
        np.testing.assert_array_equal(steps, 10 + np.arange(4))
        np.testing.assert_array_equal(values, rows)


def test_plotting_recipes(branches, tmp_path):
    ax = bt.plot_branch(branches[1])
    assert ax is not None and len(ax.lines) > 1
    bt.savefig(ax, str(tmp_path / "branch.png"))
    assert os.path.getsize(tmp_path / "branch.png") > 0
    from bifurcationkit.jl_tpu_torch.normal_forms import BifDiagNode

    node = BifDiagNode(gamma=branches[1], level=0,
                       children=[BifDiagNode(gamma=branches[1], level=1)])
    assert bt.plot_bifurcation_diagram(node) is not None


def test_plotting_without_matplotlib_warns(monkeypatch, branches):
    """Without matplotlib (an import that fails) each recipe does nothing
    and warns, as in the JAX package."""
    import sys

    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.warns(UserWarning, match="matplotlib unavailable"):
        assert bt.plot_branch(branches[1]) is None
    with pytest.warns(UserWarning, match="matplotlib unavailable"):
        assert bt.savefig(object(), "unused.png") is None
