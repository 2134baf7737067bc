"""The share of verifications the host accepted: 100 times the port
tracer's ``place.verify.passed`` counter (a loop verdict that became a
loop candidate, a relocalization that re-anchored the tracker) over
``place.verify.dispatched`` (every ``verify_loop``), in the traced session
(``utils/profiling.TRACER.last_session()``)."""


def read(ctx):
    try:
        from dynamic_visual_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    s = tracer.last_session() if tracer is not None else None
    if s is None or not s.counters.get("place.verify.dispatched"):
        return None
    return 100.0 * s.counters.get("place.verify.passed", 0) \
        / s.counters["place.verify.dispatched"]
