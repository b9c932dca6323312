"""linear_iters_per_point (program counter): the sum of
`ContState.itlinear` (the Krylov iterations of the point's corrector)
that the hook reads at each point, over the points."""


def read(ctx):
    pts = ctx["points"]
    return sum(q["itlinear"] for q in pts) / len(pts) if pts else None
