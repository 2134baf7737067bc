"""Kernel launches in the profiled steps over the frames they handed
over: an exact count."""


def read(ctx):
    if not ctx["profile_frames"] or not ctx["profile"]["launches"]:
        return None
    return ctx["profile"]["launches"] / ctx["profile_frames"]
