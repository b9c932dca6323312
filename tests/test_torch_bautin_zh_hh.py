"""The 4th/5th-order jets and the Bautin l2, run by the JAX package and by
the port on the same numpy-seeded inputs (mirrors `test_codim2.py:204-262`
and the matrix-free Bautin of `test_minaug_mf.py:752-880`; the zero-Hopf
and Hopf-Hopf forms are in `test_torch_zh_hh.py`).

Tolerances, and why:
* jets: d4F, d5F and their complex extensions to 1e-10 relative to the
  largest entry — the same nested derivatives of the same polynomial
  (on the quintic Bautin model here, on the CO model in
  `test_torch_co_tm.py`);
* coefficients: to 1e-8 * max(|c|, 1) against the JAX package's, and the
  closed-form gold values (l2 = 4 Re e, l2 = 4 L5) to 1e-8;
* no alignment is needed: l1, l2, g21 and g32 do not depend on the
  eigenvector's phase (p is normalised against q).

The JAX models run under `jax.jit`.
"""
import jax.numpy as jnp
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu.normal_forms.bautin import (
    _bautin_core as j_bautin_core)
from tests._codim2_models import (DTYPE, L5_GH, bautin_gold, check_jets,
                                  close, one_thread, quintic_bautin)

# --------------------------------------------------------------------------
# jets
# --------------------------------------------------------------------------


def test_jets_match_jax():
    """d4F, d5F and their complex extensions (the port batches the 2^k
    re/im evaluations in one vmap) on the quintic Bautin model against
    the JAX package's nested jvps, to 1e-10 relative to the largest entry
    (the CO model's case is in `test_torch_co_tm.py`)."""
    check_jets(quintic_bautin(bj), quintic_bautin(bt), 2)


# --------------------------------------------------------------------------
# Bautin l2
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bautin_ref():
    """The JAX package's dense Bautin core on the gold model
    b = 0.3i, e = -1, run eagerly (its own jit of the fifth-order jets
    compiles for about 27 s; the computation is the same)."""
    pj = bautin_gold(bj, 0.3j, -1.0)
    out = j_bautin_core(pj, jnp.zeros(2), pj.params)
    return dict(zip(("l1", "l2", "g21", "g32", "omega"),
                    (complex(v) for v in out[:5])))


@pytest.mark.parametrize("mf", [False, True], ids=["dense", "mf"])
def test_bautin_l2_matches_jax(bautin_ref, mf):
    """(l1, l2, g21, g32, omega) of the port, dense and matrix-free,
    against the JAX package's on z' = i w z + 0.3i z|z|^2 - z|z|^4, to
    1e-8 * max(|c|, 1); l2 = 4 Re e = -4 and the subtype."""
    pt = bautin_gold(bt, 0.3j, -1.0)
    got = bt.bautin_normal_form(pt, torch.zeros(2, dtype=DTYPE), pt.params,
                                matrix_free=mf)
    for k in ("l1", "l2", "g21", "g32"):
        close(got.nf[k], bautin_ref[k])
    close(got.omega, bautin_ref["omega"])
    close(got.nf["l2"], -4.0)
    assert got.subtype == "SuperCritical"


@pytest.mark.parametrize("model, l2, mf", [("gold2", 2.0, False),
                                           ("quintic", 4 * L5_GH, True)],
                         ids=["gold2-dense", "quintic-mf"])
def test_bautin_l2_gold(model, l2, mf):
    """l1 = 0 and l2 = 4 Re(e) on z' = i w z - 0.7i z|z|^2
    + (0.5 + 0.4i) z|z|^4, and l2 = 4 L5 on the quintic Bautin model of
    `test_po_switch.py` (matrix-free), to 1e-8."""
    pt = bautin_gold(bt, -0.7j, 0.5 + 0.4j) if model == "gold2" \
        else quintic_bautin(bt)
    got = bt.bautin_normal_form(pt, torch.zeros(2, dtype=DTYPE), pt.params,
                                matrix_free=mf)
    assert abs(got.nf["l1"]) < 1e-10
    close(got.nf["l2"], l2)
    assert got.subtype == ("SuperCritical" if l2 < 0 else "SubCritical")
