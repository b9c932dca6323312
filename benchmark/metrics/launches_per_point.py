"""launches_per_point (device trace): the kernel events of the traced
slice (copies and fills left out) over the slice's points."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["points"] or not tr["launches"]:
        return None
    return tr["launches"] / tr["points"]
