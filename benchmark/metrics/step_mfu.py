"""The whole frame's share of the H100's float32 peak: the counted FLOPs
of a frame (YOLOv8n's forward, the one model in the path; the SLAM stages'
operations depend on the data and are not counted) over the traced
window's wall time a frame."""

from benchlib import roofline


def read(ctx):
    n = ctx["calls"].get("detector", 0)
    if not n or not ctx["detector_size"] or not ctx["span_frames"]:
        return None
    flops = roofline.yolo_flops(ctx["detector_size"]) * n
    return 100.0 * flops / ctx["span_wall_s"] / roofline.F32_PEAK
