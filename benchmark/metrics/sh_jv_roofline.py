"""sh_jv_roofline (device trace): the least time the traced slice's J.v
products could take on the card, over the device time of the kernels
named below.

Bytes are counted from the grid and the dtype, each input read once and
the output written once: (1 + 2K) Nx Ny itemsize a call of K vectors.
The calls are counted by the harness's wrapper around the model's
`jac_op` boundary (traced runs only), so the count survives a change of
implementation.  A kernel's time is the mean over the events the profiler
kept times the calls counted (the H100's profiler drops a few events).
The bound is the card's HBM bandwidth from the table of peaks; a 512 x 512
field (2 or 1 MB a vector) fits in the 50 MB L2, so it is not a hard floor
for a kernel that keeps its operands there."""
KERNELS = {"float64": "sh_jv_kernel<double", "float32": "sh_jv_kernel<float"}
ITEMSIZE = {"float64": 8, "float32": 4}


def read(ctx):
    tr, cfg = ctx["trace"], ctx["config"]
    if not tr:
        return None
    counts = {k: v for k, v in tr["counters"].items()
              if isinstance(k, tuple) and v > 0}
    if not counts:
        return None
    nbytes, seconds = 0.0, 0.0
    for dtype, pat in KERNELS.items():
        calls = sum(v for (d, _), v in counts.items() if d == dtype)
        if not calls:
            continue
        nbytes += sum((1 + 2 * K) * cfg["Nx"] * cfg["Ny"] * ITEMSIZE[d] * v
                      for (d, K), v in counts.items() if d == dtype)
        kept = [(t, c) for n, (t, c) in tr["rows"].items() if pat in n]
        t = sum(x for x, _ in kept)
        c = sum(y for _, y in kept)
        if not c:
            return None
        seconds += t / c * calls
    if seconds <= 0:
        return None
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / seconds
