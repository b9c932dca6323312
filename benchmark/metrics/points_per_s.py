"""points_per_s (host clock): every converged, recorded branch point of
the window over the window's seconds.  Job starts, detection and bisection
are inside the window."""


def read(ctx):
    if not ctx["points"]:
        return None
    return len(ctx["points"]) / ctx["window_s"]
