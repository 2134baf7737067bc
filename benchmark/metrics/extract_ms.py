"""Self time of ORB extraction (``orb.extract_batch``, which ``orb.extract``
calls), a frame, over the traced window's spans."""


def read(ctx):
    if not ctx["span_frames"] or "extract" not in ctx["self_s"]:
        return None
    return ctx["self_s"]["extract"] / ctx["span_frames"] * 1e3
