"""lu_busy_share (device trace): the share of the traced slice's device
busy time in factorization and triangular-solve kernels (getrf, getrs,
trsm and the pieces of a batched getrf: its column panels, row swaps and
laswp), matched by the name patterns below.  The trailing updates of a
batched getrf run as general gemm kernels, which this list cannot tell
from the COP's other products and leaves out."""
PATTERNS = ("getrf", "getf2", "getrs", "laswp", "trsm", "trsv", "Trsm",
            "Getrf", "computecolumn", "swap_kernel_batched")


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    s = sum(t for n, (t, _) in tr["rows"].items()
            if any(p in n for p in PATTERNS))
    return 100.0 * s / tr["busy_s"] if s > 0 else None
