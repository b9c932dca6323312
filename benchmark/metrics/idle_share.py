"""idle_share (device trace): 1 - the union of the activity the profiler
kept (CUDA activity only) over the traced slice's wall time."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
