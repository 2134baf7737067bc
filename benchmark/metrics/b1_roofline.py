"""Kernel B1 (``fast_score_kernel``, ``csrc/fast_score.cu``): its least
time at the launches' shapes over its device time in the profiled steps."""

from benchlib import roofline


def read(ctx):
    prof = ctx["profile"]
    n, t = roofline.kernel_time(prof, "fast_score")
    if not n or t <= 0:
        return None
    least = roofline.least_seconds(*roofline.b1_work(
        ctx["cfg"], ctx["extract_frames"]))
    return 100.0 * n * least / t
