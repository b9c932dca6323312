"""newton_iters_per_point (program counter): the sum of
`ContState.itnewton` that the hook reads at each point, over the points."""


def read(ctx):
    pts = ctx["points"]
    return sum(q["itnewton"] for q in pts) / len(pts) if pts else None
