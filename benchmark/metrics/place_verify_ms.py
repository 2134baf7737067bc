"""Geometric verification a frame: self time of the port tracer's
``place.verify`` spans (``verify_loop`` for loop candidates and
relocalizations: Hamming cross-check, F-RANSAC, PnP) over the traced
session's frames (``utils/profiling.TRACER.last_session()``)."""


def read(ctx):
    try:
        from dynamic_visual_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    s = tracer.last_session() if tracer is not None else None
    if s is None or not s.frames or "place.verify" not in s.spans:
        return None
    return s.spans["place.verify"]["self_s"] / s.frames * 1e3
