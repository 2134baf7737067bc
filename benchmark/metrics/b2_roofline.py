"""Kernel B2 (``orb_desc_moments_kernel``, ``csrc/orb_desc_moments.cu``):
its least time (bytes-bound) at the launches' shapes over its device time
in the profiled steps."""

from benchlib import roofline


def read(ctx):
    prof = ctx["profile"]
    n, t = roofline.kernel_time(prof, "orb_desc_moments")
    if not n or t <= 0:
        return None
    least = roofline.least_seconds(*roofline.b2_work(
        ctx["cfg"], ctx["extract_frames"]))
    return 100.0 * n * least / t
