"""Host synchronisations a frame: the port tracer's ``host.syncs`` counter
(each synchronising operation that ``torch.cuda.set_sync_debug_mode``
reports while the traced session records: a blocking copy, an
``.item()``, a ``nonzero``) over the session's frames
(``utils/profiling.TRACER.last_session()``)."""


def read(ctx):
    try:
        from dynamic_visual_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    s = tracer.last_session() if tracer is not None else None
    if s is None or not s.frames or "host.syncs" not in s.counters:
        return None
    return s.counters["host.syncs"] / s.frames
