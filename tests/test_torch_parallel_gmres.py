"""Block GMRES, the replicated tail of a flat vector, and the sharded
Brusselator's closed-form hooks, on 2 gloo ranks on the CPU
(`tests/_parallel_ranks.py::gmres_and_hooks`), each against the same work
on one device.

* Block GMRES inside `use_mesh` (`linalg/linear.py::_gmres_block`) on 5
  columns of the Brusselator's implicit trapezoid step, restarted every 6
  iterations: the same iterations and convergence per column (so the
  same columns frozen at the same points, one of them from the start) and
  X to 1e-10 relative to its largest entry.
* GMRES with `n_rep=1` on a flat extended vector [v; s], whose s every
  rank holds: on a shifted bordered Brusselator jacobian at rtol 1e-3 it
  stops early (8 iterations of 33), and the iterations and [v; s] equal
  one device's to 1e-10 only if s counts once.
* The hooks of `parallel/models.py::brusselator_1d_sharded(batched=True)`
  (batched F and J.v, J^T.v, the pairing gradient, d2F, dF/dp and
  d(J.v)/dp for l and beta) against `torch.func` on the one-device
  `brusselator_1d` to 1e-12 relative to the largest entry."""
import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vjp

import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch.parallel.launch import start_ranks

from _parallel_ranks import (GMRES_SITES, block_gmres_case, bordered_operator,
                             bordered_rhs, hook_inputs, tail_case)

RANKS = __file__.replace("test_torch_parallel_gmres.py", "_parallel_ranks.py")
N_RANKS = 2


@pytest.fixture(scope="module")
def run():
    """(per-rank results, the one-device model)."""
    ranks = start_ranks(f"{RANKS}:gmres_and_hooks", N_RANKS,
                        dict(n_ranks=N_RANKS), timeout=90)
    try:
        torch.set_num_threads(1)
        prob = bt.models.brusselator_1d(n=GMRES_SITES, device="cpu",
                                        batched=True)
    finally:
        out = ranks.join()
    return out, prob


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_block_gmres_matches_one_device(run):
    out, prob = run
    x, B, c, gm = block_gmres_case()
    J = prob.jac_op(torch.tensor(x), prob.params)
    X, cv, it = gm.solve_block(lambda W: W - c * J(W), torch.tensor(B))
    it = np.asarray(it)
    assert it[3] == 0 and len(set(it.tolist())) > 2
    for r in out:
        Xr, cvr, itr = r["block"]
        np.testing.assert_array_equal(itr, it)
        np.testing.assert_array_equal(cvr, np.asarray(cv))
        assert _rel(Xr, X.numpy()) <= 1e-10


def test_gmres_counts_a_flat_tail_once(run):
    out, prob = run
    x, a, shift, opts = tail_case()
    at = torch.tensor(a)
    J = prob.jac_op(torch.tensor(x), prob.params)
    z, cv, it = bt.GMRES(n_rep=1, **opts)(
        bordered_operator(lambda v: J(v) - shift * v, at), bordered_rhs(at))
    assert cv and it < GMRES_SITES
    for r in out:
        v, s, cvr, itr = r["tail"]
        assert cvr and itr == it
        assert _rel(v, z[:-1].numpy()) <= 1e-10
        assert s == pytest.approx(float(z[-1]), rel=1e-10)


def _ad_references():
    """The hooks' values by torch.func on the one-device model (AD only)."""
    m = bt.models.brusselator_1d(n=GMRES_SITES, device="cpu")
    par = m.params
    x, rows, (v, w) = (torch.tensor(t) for t in hook_inputs())
    F = m.F

    def jv(y, d, p=par):
        return jvp(lambda q: F(q, p), (y,), (d,))[1]

    def pairing(y):
        return torch.dot(w, jv(y, v)) + torch.dot(v, jv(y, w))

    ref = {"F_batch": torch.stack([F(r, par) for r in rows]),
           "jv_batch": torch.stack([jv(x, r) for r in rows]),
           "jac_adjoint": vjp(lambda q: F(q, par), x)[1](w)[0],
           "grad_pairing": grad(pairing)(x),
           "d2F": jvp(lambda q: jv(q, v), (x,), (w,))[1]}
    for name in ("l", "beta"):
        p0 = par[name]

        def at(p, name=name):
            return {**par, name: p}

        one = torch.ones_like(p0)
        ref[f"dF_d{name}"] = jvp(lambda p: F(x, at(p)), (p0,), (one,))[1]
        ref[f"dJv_d{name}"] = jvp(lambda p: jv(x, v, at(p)), (p0,),
                                  (one,))[1]
    return ref


def test_sharded_brusselator_hooks_match_torch_func(run):
    out, _ = run
    ref = _ad_references()
    for r in out:
        for key, want in ref.items():
            assert _rel(r[key], want.numpy()) <= 1e-12, key
