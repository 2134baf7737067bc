"""Relocalizations applied in the window over the frames handed over in
it: how often tracking was lost and the place chain re-anchored it."""


def read(ctx):
    c = ctx["window_counts"]
    if "relocalizations" not in c or not ctx["window_frames"]:
        return None
    return 100.0 * c["relocalizations"] / ctx["window_frames"]
