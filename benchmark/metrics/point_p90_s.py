"""point_p90_s (host clock): the 90th percentile of the seconds charged
to a point, over all points of the window.  A point is charged from the
previous point of its job, or from the start of its job."""
import numpy as np


def read(ctx):
    dts = [q["dt"] for q in ctx["points"]]
    return float(np.percentile(dts, 90)) if dts else None
