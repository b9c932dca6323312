"""Parity of the port's Hopf -> periodic-orbit branch switching with its
default discretization, `Collocation(Ntst=20, m=4)`, with the JAX
package's, on the 2d Hopf normal form (exact orbits: amplitude 2 sqrt(p),
period 2 pi; mirrors `test_periodic_orbits.py:100-128`).  The JAX side's
Newton and continuation are jitted inside the package.

Tolerances, and why: the branch (parameters, periods, amplitudes) against
the JAX package's to 1e-9 (both converge to 1e-9 through the same
steps); the amplitude against 2 sqrt(p) to 2e-3 relative and the period
against 2 pi to 1e-3, the JAX test's.
"""
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(pkg):
    return {} if pkg is bj else {"device": "cpu"}


def test_hopf_abs_to_po_collocation():
    """aBS from the Hopf point of the 2d Hopf normal form to the PO branch
    with the default Collocation(Ntst=20, m=4) (`test_periodic_orbits.py:
    100-128`, cut from 60 to 12 steps): amplitude 2 sqrt(p), period 2 pi,
    the branch against the JAX package's."""
    tbl = {}
    for pkg in (bj, bt):
        prob = pkg.models.hopf_normal_2d(p=-0.1, omega=1.0, l1=-1.0,
                                         **_kw(pkg))
        cp = pkg.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-5,
                                 p_min=-0.2, p_max=1.0, max_steps=100,
                                 detect_bifurcation=3, nev=2, n_inversion=4,
                                 newton_options=pkg.NewtonPar(tol=1e-10))
        br = pkg.continuation(prob, pkg.PALC(), cp)
        hopfs = br.get_special_points("hopf")
        assert len(hopfs) == 1
        cp_po = pkg.ContinuationPar(
            ds=0.02, dsmax=0.08, dsmin=1e-5, p_min=0.0, p_max=0.6,
            max_steps=12, detect_bifurcation=0, detect_fold=False,
            newton_options=pkg.NewtonPar(tol=1e-9, max_iterations=25))
        br_po = pkg.continuation_hopf_po(br, br.specialpoint.index(hopfs[0]),
                                         cp_po)
        tbl[pkg] = {k: np.asarray(br_po.gamma._table()[k], dtype=float)
                    for k in ("param", "period", "amplitude")}
    t = tbl[bt]
    for k in t:
        np.testing.assert_allclose(t[k], tbl[bj][k], atol=1e-9)
    mask = t["param"] > 0.05
    assert mask.sum() >= 5
    np.testing.assert_allclose(t["amplitude"][mask],
                               2 * np.sqrt(t["param"][mask]), rtol=2e-3)
    np.testing.assert_allclose(t["period"][mask], 2 * np.pi, rtol=1e-3)
