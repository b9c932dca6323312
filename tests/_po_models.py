"""The periodic-orbit fixtures of the PO codim-2 parity tests, built with
the port on the CPU: the Lur'e PO branch to its PD point
(test_po_codim2.py:14-38) and the Freire PO branch, its second branch
point and the switched branch with its NS point (test_bp_po.py:14-56),
each cut to the steps that reach the points the tests use; and the JAX
package's random null-vector borders, so that both packages' bordered
solves see the same borders."""
import jax
import numpy as np
import torch

import bifurcationkit.jl_tpu_torch as bt


def lure_po_branch(ntst=25, max_steps=100):
    prob = bt.models.lure(alpha=1.2, beta=1.0, device="cpu")
    # the equilibrium branch is cut just past its Hopf at alpha = 1
    cp = bt.ContinuationPar(ds=-0.01, dsmax=0.02, dsmin=1e-6, p_min=0.9,
                            p_max=1.4, max_steps=120, detect_bifurcation=3,
                            nev=3, n_inversion=6,
                            newton_options=bt.NewtonPar(tol=1e-10))
    br = bt.continuation(prob, bt.PALC(tangent=bt.Bordered()), cp)
    ih = next(i for i, s in enumerate(br.specialpoint) if s.type == "hopf")
    cp_po = bt.ContinuationPar(
        ds=-0.01, dsmax=0.03, dsmin=1e-7, p_min=0.2, p_max=1.05,
        max_steps=max_steps, detect_bifurcation=3, nev=3, n_inversion=4,
        max_bisection_steps=15, tol_stability=1e-4,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=25))
    br_po = bt.continuation_hopf_po(br, ih, cp_po,
                                    disc=bt.Collocation(Ntst=ntst, m=4),
                                    delta_p=-0.01)
    ipd = next(i for i, s in enumerate(br_po.gamma.specialpoint)
               if s.type == "pd")
    return prob, br, br_po, ipd


def freire_po_branch(po_steps=20):
    """The Freire PO branch to its second BP (near nu = -0.587): (prob,
    br_po, index of that BP)."""
    prob = bt.models.freire(device="cpu")
    # the equilibrium branch is cut just past its Hopf at nu = -0.58933
    cp = bt.ContinuationPar(ds=0.01, dsmax=0.05, dsmin=1e-6, p_min=-1.0,
                            p_max=-0.55, max_steps=200, detect_bifurcation=3,
                            nev=3, n_inversion=8,
                            newton_options=bt.NewtonPar(tol=1e-10))
    br = bt.continuation(prob, bt.PALC(), cp)
    ih = next(i for i, s in enumerate(br.specialpoint) if s.type == "hopf")
    cp_po = bt.ContinuationPar(
        ds=-0.001, dsmax=0.01, dsmin=1e-8, p_min=-0.7, p_max=-0.4,
        max_steps=po_steps, detect_bifurcation=3, nev=4, n_inversion=6,
        max_bisection_steps=15, tol_stability=1e-4,
        newton_options=bt.NewtonPar(tol=1e-9, max_iterations=25))
    br_po = bt.continuation_hopf_po(br, ih, cp_po,
                                    disc=bt.Collocation(Ntst=30, m=4),
                                    delta_p=0.001, use_cop=True)
    ibp = next(i for i, s in enumerate(br_po.gamma.specialpoint)
               if s.type == "bp" and abs(s.param + 0.587) < 2e-3)
    return prob, br_po, ibp


def freire_switched(po_steps=20, switched_steps=8):
    """The Freire PO branch to its second BP (near nu = -0.587) and the
    branch switched there (its NS near -0.5917 at step 6)."""
    prob, br_po, ibp = freire_po_branch(po_steps)
    cp2 = bt.ContinuationPar(
        ds=-0.001, dsmax=0.005, dsmin=1e-8, p_min=-0.7, p_max=-0.4,
        max_steps=switched_steps, detect_bifurcation=3, nev=4,
        n_inversion=6, tol_stability=1e-4,
        newton_options=bt.NewtonPar(tol=1e-8, max_iterations=30))
    br2 = bt.bp_po_branch_switch(br_po, ibp, cp2, ampfactor=0.01,
                                 delta_p=-0.001, use_cop=True)
    return prob, br_po, ibp, br2


def jax_null_borders(nj, keys=(0, 1, 2)):
    """The (br, bl) pairs the JAX package's `_null_bordered` draws for an
    operator of size nj with each key."""
    out = []
    for key in keys:
        k1, k2 = jax.random.split(jax.random.PRNGKey(key))
        br = np.asarray(jax.random.uniform(k1, (nj,), dtype=np.float64)) - .5
        bl = np.asarray(jax.random.uniform(k2, (nj,), dtype=np.float64)) - .5
        out.append((torch.tensor(br), torch.tensor(bl)))
    return tuple(out)


def jax_params(params):
    """The port's parameter dict as the JAX package's floats."""
    return {k: float(v) for k, v in params.items()}
