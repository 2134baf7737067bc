"""Wall time of ``YoloDetector.__call__``, a call: letterbox, YOLOv8n,
decode, NMS, the host read and the box tracks."""


def read(ctx):
    n = ctx["calls"].get("detector", 0)
    if not n:
        return None
    return ctx["total_s"]["detector"] / n * 1e3
