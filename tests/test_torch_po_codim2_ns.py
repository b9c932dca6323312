"""The NS kind of the functional PO-MA problem (`periodic/codim2.py`) at
the Freire switched branch's NS point (Collocation(30, 4), 364 + 2
unknowns: the orbit, p1 = nu and theta), continued in beta: G, the
`POMAJac` rows (complex sigma split into its real and imaginary rows,
the theta column from the boundary row) and the k = 2 bordered solve,
against the JAX package's functional (jitted) at the port's start point
and borders; then a 3-step NS curve (test_bp_po.py:110-146).

Tolerances: G to 1e-10; the sigma gradient rows (X, p1, theta) against
`jax.jacrev` and the port's `torch.func` reference to 1e-8 relative to
their largest entry; `POMinAugLS` against a dense solve of the assembled
augmented jacobian to 1e-10 relative; along the curve theta in (0, pi)
and a Floquet multiplier of the inner orbit at |mu| = 1 to 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu import models as jm
from bifurcationkit.jl_tpu.periodic import codim2 as jc2
from bifurcationkit.jl_tpu.periodic.orbits import (
    periodic_orbit_problem as j_po_problem)
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch.periodic import codim2 as pc2
from bifurcationkit.jl_tpu_torch.periodic.codim2 import POMinAugLS
from tests._codim2_models import one_thread  # noqa: F401
from tests._po_models import freire_switched


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def ns_curve():
    _, _, _, br2 = freire_switched()
    ins = next(i for i, s in enumerate(br2.gamma.specialpoint)
               if s.type == "ns")
    cp2 = bt.ContinuationPar(
        ds=1e-3, dsmax=3e-3, dsmin=1e-8, p_min=0.3, p_max=0.7, max_steps=3,
        detect_bifurcation=0, detect_event=0, save_sol_every_step=1,
        newton_options=bt.NewtonPar(tol=1e-7, max_iterations=30))
    brc = bt.continuation_ns(br2, ins, "beta", cp2, detect_codim3=0)
    return br2, brc


def test_ns_functional_matches_jax(ns_curve):
    br2, brc = ns_curve
    po = br2.gamma.prob
    maprob = brc.gamma.prob
    Y, par = maprob.u0, maprob.params
    assert par["_a"].is_complex() and par["_b"].is_complex()
    jpo = j_po_problem(jm.freire(), bj.Collocation(Ntst=po.disc.Ntst,
                                                   m=po.disc.m),
                       jnp.asarray(po.u0.numpy()), use_cop=True)
    jmp, _ = jc2._po_ma_problem_functional(jpo, "beta", "ns")
    Yj, parj = interop.po_ma_point_to_numpy(Y, par)
    Gj = np.asarray(jax.jit(jmp.F)(jnp.asarray(Yj), parj))
    np.testing.assert_allclose(maprob.F(Y, par).numpy(), Gj, rtol=0,
                               atol=1e-10)
    Jj = jax.jit(jmp.jac)(jnp.asarray(Yj), parj)
    J = maprob.jac(Y, par)
    for a, b in ((J.sig_X, Jj.sig_X), (J.sig_p1, Jj.sig_p1),
                 (J.sig_th, Jj.sig_th)):
        assert _rel(a.numpy(), b) <= 1e-8
    ref = pc2.po_sigma_autodiff(maprob, Y, par)
    for a, b in zip((J.sig_X, J.sig_p1, J.sig_th), ref):
        assert _rel(a.numpy(), b.numpy()) <= 1e-8
    # the k = 2 bordered solve against the assembled augmented jacobian
    nY = Y.shape[0]
    dense = torch.stack([J(e) for e in torch.eye(nY, dtype=Y.dtype)], 1)
    rhs = torch.tensor(np.random.default_rng(5).standard_normal(nY))
    x, _, _ = POMinAugLS()(J, rhs)
    want = torch.linalg.solve(dense, rhs)
    assert _rel(x.numpy(), want.numpy()) <= 1e-10


def test_ns_curve(ns_curve):
    br2, brc = ns_curve
    tab = brc.gamma._table()
    assert len(tab["param"]) >= 3
    theta = np.asarray(tab["theta"])
    assert np.all((theta > 0) & (theta < np.pi))
    vals = bt.po_codim2_test_values(brc, -1)
    mult = vals["multipliers"]
    cplx = mult[np.abs(mult.imag) > 1e-6]
    assert np.min(np.abs(np.abs(cplx) - 1.0)) < 1e-6
