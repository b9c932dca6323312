"""Normal forms of fixed points of maps (`normal_forms/maps.py`): the two
analytic cases of `test_misc_solvers.py:96-131` and the port against the
JAX package on a 3-d map with cubic terms.

Tolerances: the analytic flip coefficient c = a to 1e-8 (as the JAX
test), the NS coefficient d = 2 d0 to 1e-6 relative and theta to 1e-8;
port against JAX: c, d, the multiplier and theta to 1e-10 relative to
max(|c|, 1).  Sizes are the maps' own (1, 2 and 3 unknowns)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu.normal_forms.maps import (
    neimark_sacker_nf as j_ns, period_doubling_nf as j_pd)
from bifurcationkit.jl_tpu_torch.normal_forms.maps import (
    neimark_sacker_nf, period_doubling_nf)
from tests._codim2_models import close, one_thread  # noqa: F401

DT = torch.float64


def _tprob(G, n, **params):
    return bt.BifurcationProblem(
        G, u0=torch.zeros(n, dtype=DT),
        params={k: torch.tensor(v, dtype=DT) for k, v in params.items()},
        lens=next(iter(params)))


def test_pd_normal_form_map():
    """G(x) = -(1 + eps) x + a x^3 at eps = 0: c = a, subcritical for
    a < 0 (map convention)."""
    a = -2.0

    def G(x, par):
        return torch.stack([-(1.0 + par["eps"]) * x[0] + a * x[0] ** 3])

    prob = _tprob(G, 1, eps=0.0)
    pt = period_doubling_nf(prob, torch.zeros(1, dtype=DT), prob.params)
    assert pt.nf["c"] == pytest.approx(a, abs=1e-8)
    assert pt.subtype == "SubCritical"


def test_ns_normal_form_map():
    """G(z) = e^{i th}(z + d z|z|^2): Re(e^{-i th} g21) = 2 d with the
    unit-norm eigenvector convention."""
    th, d = 0.7, -0.3

    def G(u, par):
        r2 = u[0] ** 2 + u[1] ** 2
        zr, zi = u[0] * (1 + d * r2), u[1] * (1 + d * r2)
        c, s = np.cos(th), np.sin(th)
        return torch.stack([c * zr - s * zi, s * zr + c * zi])

    prob = _tprob(G, 2, eps=0.0)
    pt = neimark_sacker_nf(prob, torch.zeros(2, dtype=DT), prob.params)
    assert pt.omega == pytest.approx(th, abs=1e-8)
    assert pt.nf["d"] == pytest.approx(2 * d, rel=1e-6)
    assert pt.subtype == "SuperCritical"


def _map3(pkg):
    """A 3-d map with a -1 multiplier, a complex pair on the unit circle
    for other parameters, and quadratic and cubic couplings."""
    stack = jnp.stack if pkg is bj else torch.stack
    cos = jnp.cos if pkg is bj else torch.cos
    sin = jnp.sin if pkg is bj else torch.sin

    def G(u, par):
        x, y, z = u[0], u[1], u[2]
        th, r = par["th"], par["r"]
        return stack([
            -r * x + 0.3 * x * y + 0.5 * x ** 3 - 0.2 * y * z,
            cos(th) * y - sin(th) * z + 0.4 * x * x + 0.1 * y * z
            - 0.3 * y * (y * y + z * z),
            sin(th) * y + cos(th) * z - 0.2 * x * y + 0.2 * z ** 3])

    return G


@pytest.mark.parametrize("which,r", [("pd", 1.0), ("ns", 0.5)])
def test_map_normal_forms_match_jax(which, r):
    par = {"th": 0.9, "r": r}
    Gj = jax.jit(_map3(bj))
    pj = bj.BifurcationProblem(Gj, u0=jnp.zeros(3), params=par, lens="r")
    pt_ = _tprob(_map3(bt), 3, **par)
    if which == "pd":
        ref = j_pd(pj, jnp.zeros(3), par)
        got = period_doubling_nf(pt_, torch.zeros(3, dtype=DT), pt_.params)
        close(got.nf["c"], ref.nf["c"], 1e-10)
    else:
        ref = j_ns(pj, jnp.zeros(3), par)
        got = neimark_sacker_nf(pt_, torch.zeros(3, dtype=DT), pt_.params)
        close(got.nf["d"], ref.nf["d"], 1e-10)
        close(got.omega, ref.omega, 1e-10)
    close(complex(got.nf["mu"]), complex(ref.nf["mu"]), 1e-10)
    assert got.subtype == ref.subtype
