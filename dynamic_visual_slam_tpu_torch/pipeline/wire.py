"""Keyframe wire format: a compact, versioned byte encoding of a
``KeyframeBlock`` for multi-process or logging deployments.

Port of the reference package's ``pipeline/wire.py``; the bytes are the
reference's, so either side reads the other's.

Layout (little-endian):
    magic  u32 = 0x4B46_5631 ("KFV1")
    frame_idx i32, timestamp f32
    q_wc 4*f32, t_wc 3*f32
    n u32 — number of VALID observations (compacted)
    uv        n*2*f32
    xyz_w     n*3*f32
    response  n*f32
    desc      n*32*u8  (packed OpenCV layout)
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.frontend.tracker import KeyframeBlock
from dynamic_visual_slam_tpu_torch.ops.hamming import unpack_bits
from dynamic_visual_slam_tpu_torch.pipeline.slam import resolve_device

MAGIC = 0x4B465631
HEAD_FMT = "<Iif4f3fI"


def encode(kf: KeyframeBlock) -> bytes:
    """One keyframe's valid observations → bytes."""
    m = kf.mask.cpu().numpy()
    uv = kf.uv.cpu().numpy().astype(np.float32)[m]
    xyz = kf.xyz_w.cpu().numpy().astype(np.float32)[m]
    resp = kf.response.cpu().numpy().astype(np.float32)[m]
    desc = kf.desc_packed.cpu().numpy().astype(np.uint8)[m]
    head = struct.pack(HEAD_FMT, MAGIC, int(kf.frame_idx),
                       float(kf.timestamp),
                       *kf.q_wc.cpu().numpy().astype(np.float32).tolist(),
                       *kf.t_wc.cpu().numpy().astype(np.float32).tolist(),
                       len(uv))
    return head + uv.tobytes() + xyz.tobytes() + resp.tobytes() + \
        desc.tobytes()


def decode(buf: bytes, capacity: int, device="cuda") -> KeyframeBlock:
    """→ KeyframeBlock with the given fixed capacity (padded + masked;
    observations past ``capacity`` are dropped) on ``device``."""
    dev = resolve_device(device)
    head_size = struct.calcsize(HEAD_FMT)
    vals = struct.unpack(HEAD_FMT, buf[:head_size])
    if vals[0] != MAGIC:
        raise ValueError(f"bad keyframe magic 0x{vals[0]:08x}")
    frame_idx, ts = vals[1], vals[2]
    n = vals[10]
    off = head_size
    uv = np.frombuffer(buf, np.float32, n * 2, off).reshape(n, 2)
    off += n * 8
    xyz = np.frombuffer(buf, np.float32, n * 3, off).reshape(n, 3)
    off += n * 12
    resp = np.frombuffer(buf, np.float32, n, off)
    off += n * 4
    desc = np.frombuffer(buf, np.uint8, n * 32, off).reshape(n, 32)

    def pad(a):
        out = np.zeros((capacity,) + a.shape[1:], a.dtype)
        out[:min(n, capacity)] = a[:capacity]
        return torch.from_numpy(out).to(dev)

    packed = pad(desc)
    return KeyframeBlock(
        q_wc=torch.tensor(vals[3:7], dtype=torch.float32, device=dev),
        t_wc=torch.tensor(vals[7:10], dtype=torch.float32, device=dev),
        uv=pad(uv), xyz_w=pad(xyz), desc_bits=unpack_bits(packed),
        desc_packed=packed, response=pad(resp),
        mask=torch.arange(capacity, device=dev) < n,
        frame_idx=torch.tensor(frame_idx, dtype=torch.int32, device=dev),
        timestamp=torch.tensor(ts, dtype=torch.float32, device=dev))
