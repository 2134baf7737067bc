"""``track_batch``'s sequential loop a frame, outside its matches and
RANSAC: self time of the port tracer's ``track.core`` span over the
traced session's frames (``utils/profiling.TRACER.last_session()``)."""


def read(ctx):
    try:
        from dynamic_visual_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    s = tracer.last_session() if tracer is not None else None
    if s is None or not s.frames or "track.core" not in s.spans:
        return None
    return s.spans["track.core"]["self_s"] / s.frames * 1e3
