"""The program's blocking reads a frame: self time of its ``pipeline.read``
spans (``SLAMSystem``'s one transfer a call, the place harvests' reads,
the BA telemetry) over the frames of the traced session, read from the
port's tracer (``utils/profiling.TRACER.last_session()``), which records
exactly the profiled steps.  Where the host waits on the card.  The
fleet's read is its caller's, outside the program."""


def read(ctx):
    try:
        from dynamic_visual_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    s = tracer.last_session() if tracer is not None else None
    if s is None or not s.frames or "pipeline.read" not in s.spans:
        return None
    return s.spans["pipeline.read"]["self_s"] / s.frames * 1e3
