"""Tiny sizes of the benchmark's configurations for the CPU tests."""
import math

import numpy as np

from harness import registry

# the SH box cut with the grid, so the mesh width stays the cell's
SH_TINY = dict(Nx=32, Ny=32, lx=16 * math.pi * 32 / 512,
               ly=4 * math.pi * 2 / math.sqrt(3) * 32 / 512)


def bruss_hopf_l(sites: int) -> float:
    """The Hopf point of the `sites`-site Brusselator's homogeneous branch,
    by bisection on the rightmost eigenvalue of its dense jacobian (the
    reference's own jacobian)."""
    reg = registry.Cell(registry.load_spec(), "bruss_po.floquet")
    ref = reg.reference()
    cfg = dict(reg.config(), sites=sites)
    import torch

    x = torch.cat([torch.full((sites,), cfg["alpha"], dtype=torch.float64),
                   torch.full((sites,), cfg["beta"] / cfg["alpha"],
                              dtype=torch.float64)])

    def rightmost(l):
        return np.max(np.linalg.eigvals(ref.jacobian(x, l, cfg).numpy()).real)

    a, b = 0.3, 0.9
    for _ in range(50):
        c = (a + b) / 2
        a, b = (a, c) if rightmost(c) > 0 else (c, b)
    return a


def bruss_tiny(sites: int = 8) -> dict:
    return dict(sites=sites, hopf_l=bruss_hopf_l(sites))
