"""bisect_share (program counter, host clock): the share of the window's
time charged to points at which `continuation` appended a bifurcation
point in that step (its bisection and typing), read from
`res.specialpoint` in the hook; 0 where the window located none."""


def read(ctx):
    pts = ctx["points"]
    if not pts:
        return None
    return 100.0 * sum(q["dt"] for q in pts if q["special"]) \
        / ctx["window_s"]
