"""YOLOv8n's forward FLOPs at the running input size over the detector's
wall time a call, as a share of the H100's float32 peak (the port turns
TF32 off, so no tensor-core rate applies)."""

from benchlib import roofline


def read(ctx):
    n = ctx["calls"].get("detector", 0)
    if not n or not ctx["detector_size"]:
        return None
    per_call = ctx["total_s"]["detector"] / n
    return 100.0 * roofline.yolo_flops(ctx["detector_size"]) / per_call \
        / roofline.F32_PEAK
