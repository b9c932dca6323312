"""Matrix-free minimally augmented codim-2 curves (mirrors
`test_minaug_mf.py`): MF against dense on the cusp's fold curve and on the
exact Hopf curve, BT detection along an MF fold curve, the MF first
Lyapunov kernel against the dense one, mixed
precision, and single applications of the 32-site Brusselator's MF Hopf
functional, of its Govaerts operator and of dFdp against the JAX
package's, in f64 and with the f32 twin on both sides.

Tolerances, and why:
* closed forms: the cusp fold curve to 1e-8, the Hopf curve p1 = -q and
  omega = 1 to 1e-10 (1e-8 with f32 Krylov work and f64 refinement), the
  BT model's fold curve b1 = b2^2/4 to 1e-6 and its BT point b2 = 0 to
  1e-6 (5e-2 in the JAX test; both packages bisect it to 1e-10);
* MF against dense: 1e-9 in `param` and `p1` — GMRES solves the extended
  systems to 1e-10 relative;
* the l1 kernels: MF against dense to 1e-8 relative (as in the JAX
  test);
* the Brusselator's G, Govaerts operator and dFdp against the JAX
  package's: 1e-10 relative to the largest entry in f64 (the bordered
  GMRES solves converge to 1e-12 from the same start); the f32 twin's
  products to 1e-5 and the refined G to 1e-9.

The JAX package's matrix-free curves compile for 8-13 s each on the CPU;
to keep this file near its time budget the curves run in the port only,
held to the closed forms and to the port's dense route (which
`test_torch_codim2.py` holds against the JAX package), while the
functionals themselves are compared with the JAX package's directly.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
from bifurcationkit.jl_tpu import models as jmodels
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop
from bifurcationkit.jl_tpu_torch import models as tmodels

DTYPE = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _arr(pkg, values):
    if pkg is bj:
        return jnp.asarray(values, dtype=jnp.float64)
    return torch.tensor(np.asarray(values), dtype=DTYPE)


def _par(pkg, **kw):
    return {k: (v if pkg is bj else torch.tensor(v, dtype=DTYPE))
            for k, v in kw.items()}


def _stack(pkg, rows):
    return jnp.array(rows) if pkg is bj else torch.stack(rows)


def _cp(pkg, **kw):
    base = dict(ds=0.01, dsmax=0.05, dsmin=1e-5, p_min=-1.0, p_max=1.0,
                max_steps=150, detect_bifurcation=3, nev=2, n_inversion=4,
                newton_options=pkg.NewtonPar(tol=1e-10, max_iterations=30))
    base.update(kw)
    return pkg.ContinuationPar(**base)


def _first(br, *types):
    sp = next(sp for sp in br.specialpoint if sp.type in types)
    return br.specialpoint.index(sp)


def cusp_model(pkg):
    def F(u, par):
        return u ** 3 + par["p1"] * u + par["p2"]

    return pkg.BifurcationProblem(F, u0=_arr(pkg, [1.0]),
                                  params=_par(pkg, p1=-1.0, p2=0.0),
                                  lens="p2")


def sl_model(pkg, c3=-1.0 + 0.0j, c5=0.0):
    """z' = (p + q + i) z + c3 z|z|^2 + c5 z|z|^4: Hopf curve p = -q with
    omega = 1, l1 proportional to Re(c3)."""
    def F(u, par):
        x, y = u[0], u[1]
        r2 = x * x + y * y
        mu = par["p"] + par["q"]
        re = mu + c3.real * r2 + c5 * r2 * r2
        im = 1.0 + c3.imag * r2
        return _stack(pkg, [re * x - im * y, im * x + re * y])

    return pkg.BifurcationProblem(F, u0=_arr(pkg, [0.0, 0.0]),
                                  params=_par(pkg, p=-0.5, q=0.0), lens="p")


def _curve(br):
    return interop.codim2_branch_to_numpy(br)


def _close_curves(a, b, keys, atol):
    assert len(a["param"]) == len(b["param"])
    for k in keys:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def test_fold_mf_parity_cusp():
    """MF fold curve == dense fold curve on the cusp model (4 p1^3 + 27
    p2^2 = 0)."""
    br = bt.continuation(cusp_model(bt), bt.PALC(),
                         _cp(bt, detect_bifurcation=0, detect_fold=True,
                             max_steps=20))
    cp2 = _cp(bt, ds=0.02, dsmax=0.08, p_min=-1.2, p_max=-0.001,
              max_steps=40, detect_bifurcation=0, detect_fold=False,
              detect_event=0)
    i = _first(br, "fold")
    mf = _curve(bt.continuation_fold(br, i, "p1", cp2,
                                     detect_codim2_bifurcation=0,
                                     jacobian_ma="minaug"))
    assert len(mf["param"]) > 10
    assert np.max(np.abs(4 * mf["param"] ** 3 + 27 * mf["p1"] ** 2)) < 1e-8
    _close_curves(mf, _curve(bt.continuation_fold(
        br, i, "p1", cp2, detect_codim2_bifurcation=0)), ("param", "p1"),
        1e-9)


@pytest.fixture(scope="module")
def sl_branch():
    return bt.continuation(sl_model(bt, c3=-1.0 + 0.8j, c5=0.3), bt.PALC(),
                           _cp(bt, max_steps=15))


def _sl_hopf_mf(br, **kw):
    cp2 = _cp(bt, ds=0.02, dsmax=0.05, p_min=-0.8, p_max=0.8, max_steps=8,
              detect_bifurcation=0, detect_fold=False)
    return bt.continuation_hopf(br, _first(br, "hopf"), "q", cp2,
                                detect_codim2_bifurcation=0,
                                jacobian_ma="minaug", **kw)


@pytest.fixture(scope="module")
def sl_hopf(sl_branch):
    return _sl_hopf_mf(sl_branch)


def test_hopf_mf_parity(sl_hopf):
    """MF Hopf curve on the Stuart-Landau model: exactly p1 = -q with
    omega = 1, and the iterative inner spectrum at its last point
    (`_iter_spectrum_at`, Arnoldi on `eig_jacobian`) is the pair +-i."""
    from bifurcationkit.jl_tpu_torch.codim2.minaug_mf import (
        _iter_spectrum_at)

    t = _curve(sl_hopf)
    assert len(t["param"]) > 5
    np.testing.assert_allclose(t["p1"], -t["param"], atol=1e-10)
    np.testing.assert_allclose(t["omega"], 1.0, atol=1e-10)
    mp = sl_hopf.gamma.prob
    vals, vecs, cv = _iter_spectrum_at(
        mp, sl_hopf.gamma.sol[-1]["x"],
        mp.set_lens_param(mp.params, float(t["param"][-1])), nev=2)
    assert cv and vecs.shape == (2, 2)
    np.testing.assert_allclose(np.sort(vals.imag), [-1.0, 1.0], atol=1e-10)
    np.testing.assert_allclose(vals.real, 0.0, atol=1e-10)


def test_solve_shifted_cplx_matches_dense():
    """(sigma I - J) x = b for complex sigma and b over a real operator, in
    the real 2n embedding, against a dense complex solve."""
    from bifurcationkit.jl_tpu_torch.codim2.minaug_mf import (
        solve_shifted_cplx)

    rng = np.random.default_rng(8)
    n = 12
    J = rng.standard_normal((n, n))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    sig = 0.3 + 2.1j
    Jt = torch.as_tensor(J)
    gm = bt.GMRES(restart=2 * n, maxiter=8 * n, rtol=1e-13, atol=1e-15)
    xr, xi, cv = solve_shifted_cplx(
        lambda v: Jt @ v, sig.real, sig.imag, torch.as_tensor(b.real),
        torch.as_tensor(b.imag), gm)
    ref = np.linalg.solve(sig * np.eye(n) - J, b)
    assert cv
    np.testing.assert_allclose(_host(xr) + 1j * _host(xi), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def test_hopf_mf_low_dtype_f32(sl_branch):
    """With `low_dtype` f32 the Krylov work of every extended solve and of
    the corrector runs in f32 with f64 refinement (the Govaerts operator
    is a PairedOperator): the curve stays exact."""
    brh = _sl_hopf_mf(sl_branch, low_dtype=torch.float32)
    assert brh.gamma.prob.jac_op_paired
    t = _curve(brh)
    assert len(t["param"]) > 5
    np.testing.assert_allclose(t["p1"], -t["param"], atol=1e-8)
    np.testing.assert_allclose(t["omega"], 1.0, atol=1e-8)


def test_l1_kernel_mf_vs_dense_parity(sl_branch, sl_hopf):
    """make_l1_kernel_mf == the dense `_make_l1_kernel` (and `_hopf_l1`)
    along the quintic Stuart-Landau Hopf curve (l1 proportional to
    Re(c3) < 0)."""
    from bifurcationkit.jl_tpu_torch.codim2.minaug import (
        _hopf_l1, _make_l1_kernel, hopf_ma_problem)
    from bifurcationkit.jl_tpu_torch.codim2.minaug_mf import (
        make_l1_kernel_mf)

    mp_t = sl_hopf.gamma.prob
    l1_mf = make_l1_kernel_mf(mp_t)
    prob = sl_branch.prob
    one = torch.tensor([1.0, 0.0], dtype=DTYPE)
    mp_d = hopf_ma_problem(prob, prob.lens, "q", one, one)
    l1_d = _make_l1_kernel(mp_d)
    gamma = sl_hopf.gamma
    for k in [1, len(gamma) - 1]:
        X = gamma.sol[k]["x"]
        p2 = float(gamma.param[k])
        v_mf = float(l1_mf(X, mp_t.set_lens_param(mp_t.params, p2)))
        v_d = l1_d(X, mp_d.set_lens_param(dict(mp_d.params), p2)["_inner"])
        v_h = _hopf_l1(mp_d, SimpleNamespace(
            current_params=mp_d.set_lens_param(dict(mp_d.params), p2)),
            SimpleNamespace(z=SimpleNamespace(u=X)))
        assert abs(v_mf - v_d) < 1e-8 * max(abs(v_d), 1.0), (v_mf, v_d)
        assert abs(v_h - v_d) < 1e-8 * max(abs(v_d), 1.0), (v_h, v_d)
        assert v_d < 0


def test_fold_mf_bt_detection():
    """BT detection along an MF fold curve of x' = y,
    y' = b1 + b2 x + x^2 - x y (fold curve b1 = b2^2/4, BT at b2 = 0):
    the <w, v> test function through the iterative bordered solves."""
    def F(u, par):
        x, y = u[0], u[1]
        return torch.stack([y, par["b1"] + par["b2"] * x + x * x - x * y])

    b1, b2 = 0.0, 0.5
    x0 = (-b2 + np.sqrt(max(b2 * b2 - 4 * b1, 0.0) + 1e-9)) / 2
    prob = bt.BifurcationProblem(F, u0=_arr(bt, [x0, 0.0]),
                                 params=_par(bt, b1=b1, b2=b2), lens="b1")
    br = bt.continuation(prob, bt.PALC(),
                         _cp(bt, ds=0.01, dsmax=0.02, p_min=-0.2, p_max=0.5,
                             max_steps=16, detect_bifurcation=2,
                             detect_fold=True))
    cp2 = _cp(bt, ds=-0.02, dsmax=0.05, p_min=-2.5, p_max=2.5,
              max_steps=16, detect_bifurcation=0, detect_fold=False,
              newton_options=bt.NewtonPar(tol=1e-9, max_iterations=30))
    t = _curve(bt.continuation_fold(br, _first(br, "fold", "bp"), "b2", cp2,
                                    detect_codim2_bifurcation=2,
                                    jacobian_ma="minaug"))
    assert np.max(np.abs(t["p1"] - t["param"] ** 2 / 4)) < 1e-6
    bts = [i for i, k in enumerate(t["sp_type"]) if k == "bt"]
    assert bts, "no BT detected along the MF fold curve"
    assert t["sp_status"][bts[0]] == "converged"
    assert abs(t["sp_param"][bts[0]]) < 1e-6


def _bruss_dia_jac_op(n):
    """The Brusselator jacobian as a five-diagonal `DIAMatrix` (user code,
    as in `chip_smoke.py`)."""
    h = 1.0 / n

    def jac_op(uv, par):
        c1 = par["D1"] / (par["l"] ** 2 * h ** 2)
        c2 = par["D2"] / (par["l"] ** 2 * h ** 2)
        b, u, v = par["beta"], uv[:n], uv[n:]
        z, i = torch.zeros_like(u), torch.arange(n)
        first, last = (i != 0).to(u.dtype), (i != n - 1).to(u.dtype)
        return bt.DIAMatrix(torch.stack([
            torch.cat([z, b - 2 * u * v]),
            torch.cat([c1 * first, c2 * first]),
            torch.cat([-2 * c1 - (b + 1) + 2 * u * v, -2 * c2 - u * u]),
            torch.cat([c1 * last, c2 * last]),
            torch.cat([u * u, z])]), (-n, -1, 0, 1, n))

    return jac_op


def _hopf_mf_apply(make, pkg, prob, X, borders, d, p2, low=None, **kw):
    """G, one Govaerts product and dFdp at (X, borders, p2), or with
    `low` G and one product of the operator's low twin; the JAX side under
    one `jax.jit` (eager calls compile every primitive on their own)."""
    mp = make(prob, prob.lens, "beta" if "beta" in prob.params else "q",
              low_dtype=low, **kw)
    par = dict(mp.params)
    par.update({k: _arr(pkg, v) for k, v in borders.items()})
    par = mp.set_lens_param(par, p2)

    def apply(Xa, par, da):
        J = mp.jac_op(Xa, par)
        if low is not None:
            return mp.F(Xa, par), J.low(da.astype(low) if pkg is bj
                                        else da.to(low))
        return mp.F(Xa, par), J(da), mp.dFdp(Xa, par)

    if pkg is bj:
        apply = jax.jit(apply)
    return [_host(o) for o in apply(_arr(pkg, X), par, _arr(pkg, d))]


def test_brusselator_mf_hopf_functional_matches_jax():
    """One application of G, of the Govaerts operator and of dFdp of the
    32-site Brusselator's MF Hopf problem, both packages at the same point
    with the same borders (no curve).  The port's J.v is a DIA product
    (the route of the card's Hopf curve), the JAX package's a jvp of F;
    the second derivatives are taken from F in both."""
    from bifurcationkit.jl_tpu.codim2.minaug_mf import (
        hopf_ma_problem_mf as j_hopf)
    from bifurcationkit.jl_tpu_torch.codim2.minaug_mf import (
        hopf_ma_problem_mf as t_hopf)

    n = 32
    rng = np.random.default_rng(3)
    jp = jmodels.brusselator_1d(n=n)
    x = np.asarray(jp.u0) * (1 + 0.05 * rng.standard_normal(2 * n))
    X = np.concatenate([x, [0.5, 2.1]])
    borders = {k: rng.standard_normal(2 * n)
               for k in ("_ar", "_ai", "_br", "_bi")}
    d = rng.standard_normal(2 * n + 2)
    gm = dict(restart=2 * n + 2, maxiter=4 * (2 * n + 2), rtol=1e-12,
              atol=1e-14)
    tp = tmodels.brusselator_1d(n=n, device="cpu")
    out = {}
    for name, pkg, make, prob in (
            ("jax", bj, j_hopf, jp),
            ("torch", bt, t_hopf, tp.re_make(jac_op=_bruss_dia_jac_op(n)))):
        out[name] = _hopf_mf_apply(make, pkg, prob, X, borders, d, 5.6,
                                   gmres_opts=gm)
    for k, (t, j) in enumerate(zip(out["torch"], out["jax"])):
        assert np.max(np.abs(t - j)) <= 1e-10 * np.max(np.abs(j)), k


def test_hopf_mf_f32_twin_matches_jax():
    """`low_dtype` f32 on both sides, on the quintic Stuart-Landau model:
    G refined to f64 accuracy through the f32 extended solves, and one
    product of the Govaerts operator's f32 twin (`PairedOperator.low`)."""
    from bifurcationkit.jl_tpu.codim2.minaug_mf import (
        hopf_ma_problem_mf as j_hopf)
    from bifurcationkit.jl_tpu_torch.codim2.minaug_mf import (
        hopf_ma_problem_mf as t_hopf)

    rng = np.random.default_rng(4)
    X = np.array([0.01, -0.02, 0.1, 1.05])
    borders = {k: rng.standard_normal(2) for k in ("_ar", "_ai", "_br",
                                                   "_bi")}
    d = rng.standard_normal(4)
    out = {}
    for name, pkg, make, lo in (("jax", bj, j_hopf, jnp.float32),
                                ("torch", bt, t_hopf, torch.float32)):
        prob = sl_model(pkg, c3=-1.0 + 0.8j, c5=0.3)
        out[name] = _hopf_mf_apply(make, pkg, prob, X, borders, d, -0.1,
                                   low=lo)
    for k, (t, j, tol) in enumerate(zip(out["torch"], out["jax"],
                                        (1e-9, 1e-5))):
        assert np.max(np.abs(t - j)) <= tol * np.max(np.abs(j)), k
