"""The tracker's RANSAC a frame: self time of the port tracer's
``track.ransac.fm``, ``track.ransac.pnp`` and ``track.ransac.anchor``
spans (minimal sets drawn, hypotheses solved and scored, the best
refined) over the traced session's frames
(``utils/profiling.TRACER.last_session()``)."""

SPANS = ("track.ransac.fm", "track.ransac.pnp", "track.ransac.anchor")


def read(ctx):
    try:
        from dynamic_visual_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    s = tracer.last_session() if tracer is not None else None
    if s is None or not s.frames:
        return None
    got = [s.spans[n]["self_s"] for n in SPANS if n in s.spans]
    if not got:
        return None
    return sum(got) / s.frames * 1e3
