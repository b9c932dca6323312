"""The wave and BVP fixtures of `test_wave_bvp.py`,
`test_bvp_cop_adapt.py` and `test_bvp_oscillator.py`, written once for
each package (`jnp` or `torch` as `xp`), so that the port's tests and
`chip_smoke.py` build the same models."""
import numpy as np

BRATU_FOLD = 3.513830719


def bratu(pkg, xp):
    """Bratu u'' + lam e^u = 0, u(0) = u(1) = 0."""
    def F(u, par):
        return xp.stack([u[1], -par["lam"] * xp.exp(u[0])])

    def g(u0, u1, par):
        return xp.stack([u0[0], u1[0]])

    return pkg.BVPModel(F, g)


def duffing(pkg, xp):
    """The forced oscillator of examples/bvp_nl_oscillator.jl:20-31 with
    t as a third state, continued in the forcing period lam."""
    def F(x, par):
        r = par["lam"] / (2 * np.pi)
        z, z1 = x[0], x[1]
        return xp.stack([
            z1,
            -(r / 25 * z1 - z / 5 + 8 / 16 * z ** 3) / r ** 2
            + 2 / 5 * xp.cos(2 * np.pi * x[2]) / r ** 2,
            xp.ones_like(z)])

    def g(u0, uT, par):
        return xp.stack([u0[0] - uT[0], u0[1] - uT[1], u0[2]])

    return pkg.BVPModel(F, g)


def nagumo(xp, n=256, L=60.0, a=0.25):
    """The Nagumo front of test_wave_bvp.py on a Neumann box: (F, ddx,
    u_exact, c_exact)."""
    h = L / n

    def shifts(u):
        return (xp.concatenate([u[:1], u[:-1]]),
                xp.concatenate([u[1:], u[-1:]]))

    def F(u, par):
        um, up = shifts(u)
        return (um - 2 * u + up) / h ** 2 + u * (1 - u) * (u - par["a"])

    def ddx(u):
        um, up = shifts(u)
        return (up - um) / (2 * h)

    xs = np.linspace(-L / 2, L / 2, n)
    return F, ddx, 1.0 / (1.0 + np.exp(-xs / np.sqrt(2))), \
        (1 - 2 * a) / np.sqrt(2)


def cgl_pulse(xp, roll, n=128, L=40.0, r0=-0.1, nu0=1.0):
    """The 1D periodic cubic-quintic cGL of test_wave_bvp.py with its two
    generators (translation, gauge rotation) and the exact mu = 0 pulse:
    (F, T1, T2, a_exact)."""
    h = L / n

    def lap(u):
        return (roll(u, 1) + roll(u, -1) - 2 * u) / (h * h)

    def dx(u):
        return (roll(u, -1) - roll(u, 1)) / (2 * h)

    def F(u, par):
        u1, u2 = u[0], u[1]
        ua = u1 * u1 + u2 * u2
        r, nu, mu = par["r"], par["nu"], par["mu"]
        f1 = lap(u1) + r * u1 - nu * u2 + ua * (u1 + mu * u2) - ua ** 2 * u1
        f2 = lap(u2) + r * u2 + nu * u1 + ua * (u2 - mu * u1) - ua ** 2 * u2
        return xp.stack([f1, f2])

    X = (np.arange(n) - n / 2) * h
    D = np.sqrt(1 + 16 * r0 / 3)
    a2 = 4 * r0 / (-1 - D * np.cosh(2 * np.sqrt(-r0) * X))
    return (F, lambda u: xp.stack([dx(u[0]), dx(u[1])]),
            lambda u: xp.stack([-u[1], u[0]]),
            np.sqrt(np.maximum(a2, 0.0)))
