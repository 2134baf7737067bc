"""Share of the frames whose results came back in the window (every
stream counted) that the tracker reported tracking: the rest re-entered
tracking through relocalization or the motion model."""


def read(ctx):
    c = ctx["window_counts"]
    if not c.get("returned"):
        return None
    return 100.0 * c["tracked"] / c["returned"]
