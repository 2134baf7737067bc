"""Self time of the tracker (``tracker.track_batch`` / ``track_step`` /
``track_streams``, less the extraction inside them), a frame."""


def read(ctx):
    if not ctx["span_frames"] or "track" not in ctx["self_s"]:
        return None
    return ctx["self_s"]["track"] / ctx["span_frames"] * 1e3
