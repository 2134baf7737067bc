"""Self time of the orchestration (``SLAMSystem.process`` /
``process_batch``, ``SLAMFleet.step_batch``) outside every other layer's
spans, a frame: the host read, emission, the BA tick's own work."""


def read(ctx):
    if not ctx["span_frames"] or "pipeline" not in ctx["self_s"]:
        return None
    return ctx["self_s"]["pipeline"] / ctx["span_frames"] * 1e3
