"""ORB extractor: pyramid → FAST score → spread top-k → IC angle → rBRIEF,
fixed shapes, batched over frames.

Same algorithm as the reference package's ``frontend/orb.py`` (which follows
the ORB-SLAM extractor: 8-level x1.2 pyramid, per-35px-cell FAST th=20→7
fallback, spread top-k in place of the quadtree, intensity-centroid angle,
7x7 sigma=2 blur + 256-pair rotated BRIEF).  Three stages are the port's
hand-written CUDA kernels: B1 (FAST scores of all levels of all frames,
``ops/fields.fast_score_batch``), D1 (the spread keypoints of all levels
of all frames, ``ops/detect.detect_levels``) and B2 (moments + descriptor
bits of all keypoints, ``ops/descriptors.descriptors_moments``).

The 256-pair sampling pattern is the standard public ORB constant table,
stored as data in orb_pattern.npy (the package's own copy).
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, NamedTuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.config import ORBConfig
from dynamic_visual_slam_tpu_torch.core.containers import topk_stable
from dynamic_visual_slam_tpu_torch.ops import descriptors as desc_k
from dynamic_visual_slam_tpu_torch.ops import detect
from dynamic_visual_slam_tpu_torch.ops.detect import (  # noqa: F401
    detect_level, features_per_level)
from dynamic_visual_slam_tpu_torch.ops import hamming
from dynamic_visual_slam_tpu_torch.ops import image as imops
from dynamic_visual_slam_tpu_torch.ops.fields import fast_score_batch
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER

HALF_PATCH = 15
SAMPLE_PAD = 19   # covers the rotated-BRIEF reach (≤ |13|·√2)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set; arrays have leading dims (..., K)."""

    uv: torch.Tensor          # (..., K, 2) float32 — (x, y) level-0 pixels
    response: torch.Tensor    # (..., K)  float32 — FAST corner score
    angle: torch.Tensor       # (..., K)  float32 — radians, IC orientation
    octave: torch.Tensor      # (..., K)  int32   — pyramid level
    desc_bits: torch.Tensor   # (..., K, 256) uint8 {0,1}
    desc_packed: torch.Tensor  # (..., K, 32) uint8 — OpenCV wire layout
    mask: torch.Tensor        # (..., K) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1)


# --------------------------------------------------------------------------
# Constant tables (host-side, cached)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def brief_pattern() -> np.ndarray:
    """(256, 4) float32 — x1,y1,x2,y2 per comparison (public ORB constant)."""
    path = os.path.join(os.path.dirname(__file__), "orb_pattern.npy")
    pat = np.load(path)
    if pat.shape != (256, 4):
        raise ValueError(f"orb_pattern.npy has shape {pat.shape}")
    return pat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def ic_umax() -> np.ndarray:
    """Per-row max column offset of the radius-15 disc, with the symmetry
    correction of the ORB-SLAM extractor."""
    umax = np.zeros(HALF_PATCH + 2, dtype=np.int32)
    vmax = int(math.floor(HALF_PATCH * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF_PATCH * math.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:HALF_PATCH + 1]


# --------------------------------------------------------------------------
# Batched extractor
# --------------------------------------------------------------------------

def extract(img: torch.Tensor, cfg: ORBConfig) -> Keypoints:
    """One (H, W) grayscale frame → Keypoints with capacity
    cfg.max_keypoints: ``extract_batch`` on a batch of one, which the
    reference states gives the same keypoints as its per-frame extractor.
    One B1 and one B2 launch a frame."""
    return Keypoints(*(a[0] for a in extract_batch(img[None], cfg)))


def extract_batch(imgs: torch.Tensor, cfg: ORBConfig) -> Keypoints:
    """(B, H, W) grayscale stack (uint8 or float32 in [0, 255]) → Keypoints
    with leading dim B and capacity cfg.max_keypoints.

    One B1 launch scores all B × n_levels pyramid levels, one D1 call (two
    launches) detects their keypoints, one B2 launch describes all B ×
    max_keypoints keypoint slots; the rest is batched tensor code on the
    images' device.  Spans: ``extract``, and inside it ``extract.pyramid``,
    ``extract.b1`` (kernel B1), ``extract.detect`` (kernel D1) and
    ``extract.b2`` (kernel B2)."""
    with TRACER.span("extract"):
        with TRACER.span("extract.pyramid"):
            levels = imops.build_pyramid(imgs.to(torch.float32),
                                         cfg.n_levels, cfg.scale_factor)
        return extract_levels(levels, cfg)


class DescriptorInputs(NamedTuple):
    """Everything kernel B2 takes for one batch: per-level blurred and raw
    images reflect-padded by SAMPLE_PAD, and the K = B·capacity keypoint
    slots as flat int32 (level, frame, y, x)."""

    blur: List[torch.Tensor]     # per level (B, H_l + 38, W_l + 38) f32
    raw: List[torch.Tensor]
    level: torch.Tensor          # (K,) int32
    frame: torch.Tensor          # (K,) int32
    ys: torch.Tensor             # (K,) int32
    xs: torch.Tensor             # (K,) int32


def detect_batch(levels, scores, cfg: ORBConfig):
    """Detection (``ops/detect.detect_levels``) + blur for a batch → (slots,
    DescriptorInputs): slots is a dict of (B, capacity, ...) tensors (uv,
    response, ys, xs, octave, mask); the descriptor inputs cover every slot,
    padding included."""
    b = levels[0].shape[0]
    dev = levels[0].device
    with TRACER.span("extract.detect"):
        cat = detect.detect_levels(scores, detect.detect_spec(cfg))
    blur_levels, raw_levels = [], []
    for lv in levels:
        blurred = torch.clamp(torch.round(imops.gaussian_blur(lv, 7, 2.0)),
                              0.0, 255.0)
        blur_levels.append(imops.reflect_pad(blurred, SAMPLE_PAD).contiguous())
        raw_levels.append(imops.reflect_pad(lv, SAMPLE_PAD).contiguous())

    k_cap = cfg.max_keypoints
    if cat["mask"].shape[1] > k_cap:
        _, keep_idx = topk_stable(
            torch.where(cat["mask"], cat["response"], -1.0), k_cap)
        cat = {k: (torch.gather(v, 1, keep_idx) if v.ndim == 2 else
                   torch.gather(v, 1, keep_idx[..., None].expand(
                       -1, -1, v.shape[2])))
               for k, v in cat.items()}

    frame = torch.arange(b, dtype=torch.int32, device=dev)[:, None] \
        .expand(b, k_cap)
    flat = lambda t: t.reshape(-1).contiguous()  # noqa: E731
    inputs = DescriptorInputs(blur_levels, raw_levels, flat(cat["octave"]),
                              flat(frame), flat(cat["ys"]), flat(cat["xs"]))
    return cat, inputs


def extract_levels(levels, cfg: ORBConfig) -> Keypoints:
    """extract_batch from an already built pyramid: levels is the list of
    (B, H_l, W_l) float32 level stacks (level 0 = the frames)."""
    levels = [lv.contiguous() for lv in levels]
    b = levels[0].shape[0]
    k_cap = cfg.max_keypoints
    with TRACER.span("extract.b1"):
        scores = fast_score_batch(levels)
    cat, inputs = detect_batch(levels, scores, cfg)
    with TRACER.span("extract.b2"):
        bits, m10, m01 = desc_k.descriptors_moments(*inputs)
    bits = bits.reshape(b, k_cap, 256)
    return Keypoints(
        uv=cat["uv"], response=cat["response"],
        angle=torch.atan2(m01, m10).reshape(b, k_cap),
        octave=cat["octave"], desc_bits=bits,
        desc_packed=hamming.pack_bits(bits), mask=cat["mask"])
