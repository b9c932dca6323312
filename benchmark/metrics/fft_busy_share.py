"""fft_busy_share (device trace): the share of the traced slice's device
busy time in cuFFT's kernels, matched by the name patterns below."""
PATTERNS = ("fft", "FFT", "Radix", "radix")


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    s = sum(t for n, (t, _) in tr["rows"].items()
            if any(p in n for p in PATTERNS))
    return 100.0 * s / tr["busy_s"] if s > 0 else None
