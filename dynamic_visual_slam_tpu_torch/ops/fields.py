"""Dense frontend fields: FAST-9 scores of every pyramid level of a batch.

``fast_score_batch`` wraps kernel B1 (``csrc/fast_score.cu``): one launch
scores all B frames × all levels.  For CPU tensors it computes the plain
version, ``ops/fast.corner_score``, level by level; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from dynamic_visual_slam_tpu_torch import kernels
from dynamic_visual_slam_tpu_torch.ops.fast import corner_score

KERNEL = "fast_score"


def fast_score_batch(levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """FAST-9 score maps for B frames' full pyramids.

    levels: per pyramid level a (B, H_l, W_l) float32 contiguous tensor, all
    on one device.  → per level a (B, H_l, W_l) float32 score tensor."""
    if not levels:
        raise ValueError("fast_score_batch: no levels")
    dev = levels[0].device
    b = levels[0].shape[0]
    for lv in levels:
        if lv.device != dev or lv.dtype != torch.float32 or lv.ndim != 3 \
                or lv.shape[0] != b or not lv.is_contiguous():
            raise ValueError(
                "fast_score_batch: levels must be contiguous float32 "
                f"(B, H, W) tensors on one device; got {lv.dtype} "
                f"{tuple(lv.shape)} on {lv.device}")
    if dev.type == "cpu":
        return [corner_score(lv) for lv in levels]
    if dev.type != "cuda":
        raise ValueError(f"fast_score_batch: unsupported device {dev}")
    outs = [torch.empty_like(lv) for lv in levels]
    fn = kernels.entry(KERNEL)
    ins = kernels.pointer_array([lv.data_ptr() for lv in levels])
    ous = kernels.pointer_array([o.data_ptr() for o in outs])
    hs = kernels.int_array([lv.shape[1] for lv in levels])
    ws = kernels.int_array([lv.shape[2] for lv in levels])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(ctypes.cast(ins, ctypes.c_void_p),
                    ctypes.cast(ous, ctypes.c_void_p),
                    ctypes.cast(hs, ctypes.c_void_p),
                    ctypes.cast(ws, ctypes.c_void_p),
                    len(levels), b, stream)
    kernels.check(KERNEL, status)
    kernels.launches[KERNEL] += 1
    return outs
