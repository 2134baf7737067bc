"""The yardstick's arithmetic: the H100's published peaks, and the
operations and bytes of kernels B1 and B2 and of YOLOv8n's forward pass,
counted from their shapes.

Peaks (NVIDIA's H100 SXM data sheet, dense): 67 TFLOP/s in float32 outside
the tensor cores (the port turns TF32 off), 3.35 TB/s of HBM3.  The 67
TFLOP/s count a fused multiply-add as two operations: 132 SMs x 128 float32
lanes x 1.98 GHz issue 33.5 T instructions a second, so operations that are
one instruction each (B1's and B2's min, max, subtractions, comparisons)
are held to 33.5 T/s.  A roofline share is the least time, the larger of
operations over their peak and bytes over the bandwidth, over the kernel's
measured device time.
"""

from __future__ import annotations

from typing import Dict, Tuple

F32_PEAK = 67e12          # FLOP/s, float32, no tensor cores (FMA = 2)
F32_ISSUE = F32_PEAK / 2  # float32 instructions/s, one operation each
HBM_PEAK = 3.35e12        # bytes/s

# B1: the FAST-9 arc test a pixel in its least form of two-input min/max
# (OpenCV's cornerScore<16>: 2-, 4- and 8-windows shared between arcs,
# 47 a polarity, and the max of the two polarities), plus the two
# subtractions against the centre; one float32 read and one written.
B1_OPS_PER_PX = 2 * 47 + 1 + 2
B1_BYTES_PER_PX = 4 + 4
# B2 a keypoint slot: the disc's raw pixels (float32) and the 512 blurred
# samples read once, the slot's (level, frame, y, x) int32 read, 256 bit
# bytes and two float32 moments written; operations: 2 multiplies and 2
# adds a disc pixel, about 8 a sample (rotation, rounding, address), one
# comparison a bit.
B2_SAMPLES = 512


def pyramid_pixels(cfg, frames: int) -> int:
    """Pixels of every level of ``frames`` frames' pyramids."""
    from slamref.ops.image import pyramid_shapes
    c, o = cfg.camera, cfg.orb
    return frames * sum(h * w for h, w in pyramid_shapes(
        c.height, c.width, o.n_levels, o.scale_factor))


def disc_pixels() -> int:
    from slamref.ops.descriptors import _disc_offsets
    return len(_disc_offsets()[0])


def b1_work(cfg, frames: int) -> Tuple[float, float]:
    """(operations, bytes) of one B1 launch over ``frames`` frames."""
    px = pyramid_pixels(cfg, frames)
    return float(B1_OPS_PER_PX * px), float(B1_BYTES_PER_PX * px)


def b2_work(cfg, frames: int) -> Tuple[float, float]:
    """(operations, bytes) of one B2 launch: every keypoint slot of
    ``frames`` frames (the kernel describes padding slots too)."""
    n_kp = frames * cfg.orb.max_keypoints
    d = disc_pixels()
    ops = n_kp * (4 * d + 8 * B2_SAMPLES + 256)
    nbytes = n_kp * (4 * d + 4 * B2_SAMPLES + 16 + 256 + 8)
    return float(ops), float(nbytes)


def least_seconds(ops: float, nbytes: float,
                  ops_peak: float = F32_ISSUE) -> float:
    """The larger of ``ops`` at ``ops_peak`` and ``nbytes`` at the HBM's
    bandwidth; the kernels' operations are single instructions."""
    return max(ops / ops_peak, nbytes / HBM_PEAK)


def yolo_flops(size: int, num_classes: int = 80) -> float:
    """Forward FLOPs of YOLOv8n on one size x size image: 2 a
    multiply-add of every convolution, from the shapes of a pass on the
    meta device (no arithmetic runs)."""
    import torch
    from slamref.models import yolov8
    model = yolov8.YOLOv8(num_classes).to("meta").eval()
    total = [0.0]

    def hook(mod, inp, out):
        w = mod.w
        n, _, h, wd = out.shape
        total[0] += 2.0 * n * h * wd * w.shape[0] * w.shape[1] \
            * w.shape[2] * w.shape[3]
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, yolov8.Conv)]
    with torch.no_grad():
        model(torch.zeros((1, 3, size, size), device="meta"))
    for h in hooks:
        h.remove()
    return total[0]


def kernel_time(profile: Dict, fragment: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``fragment``."""
    n, t = 0, 0.0
    for name, (k, s) in profile["kernels"].items():
        if fragment in name:
            n += int(k)
            t += float(s)
    return n, t
