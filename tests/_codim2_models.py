"""Small models with closed-form codim-2 geometry, written once for both
packages (`pkg` is `bifurcationkit.jl_tpu` or `bifurcationkit.jl_tpu_torch`)
in real arithmetic (the port's forward AD takes a real F), and the helpers
the codim-2 parity tests share.  The JAX models' F runs under `jax.jit`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bifurcationkit.jl_tpu as bj
import bifurcationkit.jl_tpu_torch as bt
from bifurcationkit.jl_tpu_torch import interop

DTYPE = torch.float64
COEF = 1e-8            # coefficients, relative to max(|c|, 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stack(pkg, rows):
    return jnp.stack(rows) if pkg is bj else torch.stack(rows)


def prob(pkg, F, n, lens=None, **params):
    """A problem of `pkg` with state zeros(n) and scalar parameters."""
    lens = lens or next(iter(params))
    if pkg is bj:
        return bj.BifurcationProblem(jax.jit(F), u0=jnp.zeros(n),
                                     params=dict(params), lens=lens)
    return bt.BifurcationProblem(
        F, u0=torch.zeros(n, dtype=DTYPE),
        params={k: torch.tensor(v, dtype=DTYPE) for k, v in params.items()},
        lens=lens)


def zeros(pkg, n):
    return jnp.zeros(n) if pkg is bj else torch.zeros(n, dtype=DTYPE)


def close(a, b, tol=COEF):
    """|a - b| <= tol * max(|b|, 1), for numbers, complex numbers, arrays
    and tensors."""
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b)
    bound = tol * np.maximum(np.abs(b), 1.0)
    assert np.all(np.abs(a - b) <= bound), (a, b)


def bautin_gold(pkg, b, e, w=1.3):
    """z' = i w z + b z|z|^2 + e z|z|^4 (b, e complex): l1 = 0 when
    Re b = 0, and l2 = 4 Re e."""
    def F(u, par):
        x, y = u[0], u[1]
        zz = x * x + y * y
        cr = b.real * zz + e.real * zz * zz
        ci = b.imag * zz + e.imag * zz * zz
        return stack(pkg, [-w * y + cr * x - ci * y, w * x + cr * y + ci * x])

    return prob(pkg, F, 2, p=0.0)


OM_GH, C1_GH, L5_GH, C2_GH = 1.3, 0.4, -2.0, 0.1


def quintic_bautin(pkg):
    """z' = (p1 + i om) z + (p2 + i c1) z|z|^2 + (L5 + i c2) z|z|^4
    (`test_po_switch._bautin_model`): fold of cycles p1 = p2^2 / (4 L5)."""
    def F(u, par):
        x, y = u[0], u[1]
        zz = x * x + y * y
        cr = par["p1"] + par["p2"] * zz + L5_GH * zz * zz
        ci = OM_GH + C1_GH * zz + C2_GH * zz * zz
        return stack(pkg, [cr * x - ci * y, cr * y + ci * x])

    return prob(pkg, F, 2, p1=0.0, p2=0.0)


def co_model(pkg):
    """The CO-oxidation model at its reference parameters."""
    if pkg is bj:
        from bifurcationkit.jl_tpu import models as jm
        p = jm.co_oxidation()
        return p.re_make(F=jax.jit(p.F))
    return bt.models.co_oxidation(device="cpu")


ZH_A, ZH_B, ZH_C, ZH_W = 0.7, -1.3, 0.4 + 0.2j, 1.9


def zh_gold(pkg):
    """x' = a x^2 + b|z|^2 + p x, z' = i w z + c x z: G200 = 2a,
    G011 = 2b (unit-norm q1), G110 = c."""
    def F(u, par):
        x, y1, y2 = u[0], u[1], u[2]
        dx = ZH_A * x * x + ZH_B * (y1 * y1 + y2 * y2) + par["p"] * x
        cr, ci = ZH_C.real * x, ZH_W + ZH_C.imag * x
        return stack(pkg, [dx, cr * y1 - ci * y2, cr * y2 + ci * y1])

    return prob(pkg, F, 3, p=0.0)


OM_ZH = 1.5
A_ZH, B_ZH, CR_ZH, CI_ZH, DR_ZH, DI_ZH = 1.0, -1.0, 0.5, 0.3, -1.0, 0.2


def zh_unfold(pkg):
    """x' = p1 + a x^2 + b|z|^2, z' = (p2 + i om) z + c x z + d z|z|^2
    (`test_po_switch._zh_model`): NS surface x = -dr s / a,
    p2 = -cr x - dr s, p1 = -a x^2 - b s (s = r^2)."""
    def F(u, par):
        x, y1, y2 = u[0], u[1], u[2]
        zz = y1 * y1 + y2 * y2
        cr = par["p2"] + CR_ZH * x + DR_ZH * zz
        ci = OM_ZH + CI_ZH * x + DI_ZH * zz
        return stack(pkg, [par["p1"] + A_ZH * x * x + B_ZH * zz,
                           cr * y1 - ci * y2, cr * y2 + ci * y1])

    return prob(pkg, F, 3, p1=0.0, p2=0.0)


HH_G = (1.0, 2.0, 6.0, 7.0)     # g2100, g1011, g1110, g0021
HH_W = (0.1, 0.3)


def hh_gold(pkg):
    """The constructed HH normal form of `test_codim2.py` (ref testNF.jl
    Fhh, :651-671)."""
    g2100, g1011, g1110, g0021 = HH_G
    w1, w2 = HH_W

    def F(u, par):
        ua1 = u[0] ** 2 + u[1] ** 2
        ua2 = u[2] ** 2 + u[3] ** 2
        r1 = par["b1"] + g2100 / 2 * ua1 + g1011 * ua2
        r2 = par["b2"] + g1110 * ua1 + g0021 / 2 * ua2
        return stack(pkg, [r1 * u[0] - w1 * u[1], r1 * u[1] + w1 * u[0],
                           r2 * u[2] - w2 * u[3], r2 * u[3] + w2 * u[2]])

    return prob(pkg, F, 4, b1=0.0, b2=0.0)


HH2_W = (0.9, 1.7)


def hh_two(pkg, b1=0.0, b2=0.0):
    """The two-oscillator HH model of `test_codim2.py` with quadratic
    couplings: pair 1 on b1 = 0 (omega = 0.9), pair 2 on b2 + 0.4 b1 = 0
    (omega = 1.7)."""
    w1, w2 = HH2_W

    def F(u, par):
        x1, y1, x2, y2 = u[0], u[1], u[2], u[3]
        ua1, ua2 = x1 * x1 + y1 * y1, x2 * x2 + y2 * y2
        m1 = par["b1"] - 0.5 * ua1 - 1.0 * ua2
        m2 = par["b2"] + 0.4 * par["b1"] - 2.0 * ua1 - 1.5 * ua2
        # 0.3 z1 z2 + 0.1 z2 conj(z1) and 0.2 z1^2 + 0.15 z1 conj(z2)
        q1r = 0.3 * (x1 * x2 - y1 * y2) + 0.1 * (x2 * x1 + y2 * y1)
        q1i = 0.3 * (x1 * y2 + y1 * x2) + 0.1 * (y2 * x1 - x2 * y1)
        q2r = 0.2 * (x1 * x1 - y1 * y1) + 0.15 * (x1 * x2 + y1 * y2)
        q2i = 0.2 * (2 * x1 * y1) + 0.15 * (y1 * x2 - x1 * y2)
        return stack(pkg, [m1 * x1 - w1 * y1 + q1r, m1 * y1 + w1 * x1 + q1i,
                           m2 * x2 - w2 * y2 + q2r, m2 * y2 + w2 * x2 + q2i])

    return prob(pkg, F, 4, b1=b1, b2=b2)


def bt_planar(pkg, a=1.0, b=1.0):
    """x' = y, y' = p1 + p2 y + a x^2 + b x y: the parameter transform of
    the BT unfolding is the identity (K10 = [1, 0], K11 = [0, 1],
    K2 = 0)."""
    def F(u, par):
        return stack(pkg, [u[1], par["p1"] + par["p2"] * u[1]
                           + a * u[0] ** 2 + b * u[0] * u[1]])

    return prob(pkg, F, 2, p1=0.0, p2=0.0)


def bt_cubic(pkg):
    """The BT model of `test_minaug_mf.test_bt_nf_mf_parity`: its cubic
    terms make every REF3 coefficient nonzero."""
    def F(u, par):
        x, y = u[0], u[1]
        return stack(pkg, [y + 0.3 * x * x,
                           par["b1"] + par["b2"] * x + x * x - x * y
                           + 0.5 * x ** 3 + 0.2 * x * x * y])

    return prob(pkg, F, 2, b1=0.0, b2=0.0)


def bt_model(pkg, b1=0.5, b2=1.0):
    """x' = y, y' = b1 + b2 x + x^2 - x y: fold curve b1 = b2^2/4 with a
    BT at b2 = 0, Hopf curve b1 = 0, b2 < 0 with omega^2 = -b2; the state
    starts on the fold branch side x = (-b2 + sqrt(b2^2 - 4 b1))/2."""
    def F(u, par):
        x, y = u[0], u[1]
        return stack(pkg, [y, par["b1"] + par["b2"] * x + x * x - x * y])

    x0 = (-b2 + np.sqrt(max(b2 * b2 - 4 * b1, 0.0) + 1e-9)) / 2
    p = prob(pkg, F, 2, lens="b1", b1=b1, b2=b2)
    u0 = [x0, 0.0]
    return p.re_make(u0=jnp.asarray(u0) if pkg is bj
                     else torch.tensor(u0, dtype=DTYPE))


def jets(pkg, prob, x, dirs):
    """d4F, d5F on the real parts and d4F_complex, d5F_complex on the
    complex directions, as numpy.  The JAX side runs eagerly over its
    jitted F: a `jax.jit` of the 32 nested fifth-order jvps compiles for
    seconds, the eager calls reuse the primitives compiled for d4F/d5F."""
    par = prob.params

    def all4(xs, *ds):
        re = [d.real for d in ds]
        return (prob.d4F(xs, par, *re[:4]), prob.d5F(xs, par, *re),
                prob.d4F_complex(xs, par, *ds[:4]),
                prob.d5F_complex(xs, par, *ds))

    if pkg is bj:
        out = all4(jnp.asarray(x), *[jnp.asarray(d) for d in dirs])
    else:
        out = all4(torch.as_tensor(x), *[torch.as_tensor(d) for d in dirs])
    return [interop._to_numpy(o) for o in out]


def check_jets(pj, pt, n, seed=11):
    """The four jets of `jets` at a random state and random complex
    directions, the port against the JAX package, to 1e-10 relative to
    the largest entry."""
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal(n)
    dirs = [rng.standard_normal(n) + 1j * rng.standard_normal(n)
            for _ in range(5)]
    for a, b in zip(jets(bj, pj, x, dirs), jets(bt, pt, x, dirs)):
        scale = max(np.max(np.abs(a)), 1e-300)
        assert np.max(np.abs(a - b)) <= 1e-10 * scale
