"""The matrix-free shooting monodromy on the 1D Brusselator against
FloquetColl on the same orbit (mirrors `test_floquet_mf.py:77-129`, cut
from 20 to 10 sites and from `Shooting(M=5, steps_per_segment=150)` to
60 steps), and the variational operator against `torch.func.jvp`.  The
model is the port's batched Brusselator (closed-form J.v and d2F).

Tolerances, and why:
* the leading 4 multipliers of the matrix-free monodromy
  (`FloquetQaDMF(SubspaceEig)`) against FloquetColl's at the same orbit:
  1e-4 (the JAX test's; shooting and collocation discretize the same
  orbit);
* the matrix-free monodromy through the model's J.v against the same
  operator through `torch.func.jvp`: 1e-12 relative to its largest entry
  (exact jvps of the same map).
"""
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.periodic.cop import (
    collocation_block_jacobian)

N_SITES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def test_mf_monodromy_vs_floquet_coll():
    """The matrix-free shooting monodromy on the collocation orbit
    interpolated onto `Shooting(M=5)` against FloquetColl there
    (`test_floquet_mf.py:77-129`), and the operator through the model's
    J.v against the same operator through `torch.func.jvp`."""
    brt = bt.continuation(
        bt.models.brusselator_1d(n=N_SITES, device="cpu", batched=True),
        bt.PALC(), bt.ContinuationPar(
            ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29, p_max=0.8,
            max_steps=120, detect_bifurcation=3, nev=10, n_inversion=4,
            newton_options=bt.NewtonPar(tol=1e-9)))
    ih = [i for i, sp in enumerate(brt.specialpoint) if sp.type == "hopf"][0]
    cpo = bt.ContinuationPar(ds=0.01, dsmax=0.02, dsmin=1e-6, p_min=0.29,
                             p_max=0.75, max_steps=4, detect_bifurcation=0,
                             newton_options=bt.NewtonPar(tol=1e-9,
                                                         max_iterations=25))
    disc_c = bt.Collocation(Ntst=30, m=4)
    gam = bt.continuation_hopf_po(brt, ih, cpo, delta_p=0.02, disc=disc_c,
                                  use_cop=True).gamma
    Xc, p_at = gam.sol[-1]["x"], float(gam.sol[-1]["p"])
    po_c = gam.prob
    par_c = po_c.set_lens_param(po_c.params, p_at)
    expo_c, _, _, _ = bt.FloquetColl()(collocation_block_jacobian(
        disc_c, po_c.prob_vf, Xc, par_c), 4)
    mult_c = np.sort(np.abs(np.exp(_host(expo_c))))[::-1]

    n = 2 * N_SITES
    nodes, T = disc_c.split(Xc, n)
    disc_s = bt.Shooting(M=5, steps_per_segment=60)
    X0 = disc_s.generate_solution(
        lambda t: disc_c.interpolate(nodes, par_c["_mesh"],
                                     (t / (2 * np.pi)) % 1.0), float(T), n,
        device="cpu")
    vf = po_c.prob_vf.re_make(params=par_c["_inner"])
    sol_s, po_s = bt.newton_po(vf, disc_s, X0, options=bt.NewtonPar(
        tol=1e-10, max_iterations=25))
    assert sol_s.converged
    op = disc_s.monodromy_operator(vf, sol_s.u, po_s.params)
    # the block solver: each sweep is one pass of the segment chain on its
    # 12 columns
    mf = bt.FloquetQaDMF(eigsolver=bt.SubspaceEig(sweeps=4, krylov_blocks=4,
                                                  extra=8, tol=1e-8))
    expo, _, _, _ = mf(op, 4)
    mult_mf = np.sort(np.abs(np.exp(_host(expo))))[::-1]
    np.testing.assert_allclose(mult_mf, mult_c, atol=1e-4)

    # the variational operator against torch.func.jvp through the flow,
    # on a coarser grid (the AD route costs ~0.5 ms per operation)
    disc_q = bt.Shooting(M=5, steps_per_segment=8)
    V = torch.as_tensor(np.random.default_rng(2).standard_normal((3, n)))
    got = disc_q.monodromy_operator(vf, sol_s.u, po_s.params).block(V)
    ref = disc_q.monodromy_operator(vf.re_make(jac_op=None), sol_s.u,
                                    po_s.params).block(V)
    scale = float(torch.abs(ref).max())
    np.testing.assert_allclose(_host(got), _host(ref), atol=1e-12 * scale)
