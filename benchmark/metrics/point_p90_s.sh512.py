"""point_p90_s.sh512 (host clock, traced run): as point_p90_s, over the
points of the traced run outside the profiled slice and the point after
it (the profiler's own start and stop are charged to those)."""
import numpy as np


def read(ctx):
    dts = [q["dt"] for q in ctx["points"] if not q.get("profiled")]
    return float(np.percentile(dts, 90)) if dts else None
