"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the device stages of the main path free of host synchronisation.

These tests need an NVIDIA GPU and skip without one.  The file imports only
the port (no JAX), so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_kernels_cuda.py

Tolerance: none.  Scores, moments and descriptor bits are exact in both
versions (integer-valued inputs; the descriptor angle arithmetic is rounded
identically), so the kernels must equal the plain versions bit for bit.
``chip_smoke.py`` repeats the comparison at the main path's 720p shapes.
"""

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu_torch import kernels
from dynamic_visual_slam_tpu_torch.backend import ba, mapping
from dynamic_visual_slam_tpu_torch.config import (CameraConfig, ORBConfig,
                                                  SLAMConfig)
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.frontend import orb, tracker
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.ops import descriptors, fast, fields
from dynamic_visual_slam_tpu_torch.ops import image as imops
from dynamic_visual_slam_tpu_torch.semantic.classes import filtered_mask

torch.set_num_threads(2)
CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = ORBConfig()


@pytest.fixture(scope="module")
def sequence():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    seq = list(synthetic.generate_sequence(CAM, 4, seed=11,
                                           depth_noise=0.004))
    grays = torch.from_numpy(np.stack([f[0] for f in seq]).astype(np.float32))
    depths = torch.from_numpy(
        (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16))
    return grays, depths


@pytest.fixture(scope="module")
def frames(sequence):
    return sequence[0]


@pytest.mark.cuda
def test_fast_score_matches_corner_score(frames):
    levels = [lv.contiguous() for lv in imops.build_pyramid(
        frames.cuda(), CFG.n_levels, CFG.scale_factor)]
    before = kernels.launches["fast_score"]
    got = fields.fast_score_batch(levels)
    torch.cuda.synchronize()
    assert kernels.launches["fast_score"] == before + 1
    for g, lv in zip(got, levels):
        assert torch.equal(g, fast.corner_score(lv))


@pytest.mark.cuda
def test_descriptors_match_plain_version(frames):
    levels = [lv.contiguous() for lv in imops.build_pyramid(
        frames.cuda(), CFG.n_levels, CFG.scale_factor)]
    _, inputs = orb.detect_batch(levels, fields.fast_score_batch(levels), CFG)
    got = descriptors.descriptors_moments(*inputs)
    want = descriptors.descriptors_moments_plain(*inputs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_extract_batch_on_the_card_equals_the_cpu(frames):
    k_gpu = orb.extract_batch(frames.cuda(), CFG)
    k_cpu = orb.extract_batch(frames, CFG)
    for name in ("uv", "response", "octave", "mask", "desc_bits",
                 "desc_packed"):
        assert torch.equal(getattr(k_gpu, name).cpu(), getattr(k_cpu, name))
    # atan2 of identical moments in two libraries
    assert float((k_gpu.angle.cpu() - k_cpu.angle).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(frames):
    lv = frames.cuda()
    with pytest.raises(ValueError):
        fields.fast_score_batch([lv.double()])
    with pytest.raises(ValueError):
        fields.fast_score_batch([lv[:, :, ::2]])
    with pytest.raises(ValueError):
        fields.fast_score_batch([lv, lv.cpu()])


@pytest.mark.cuda
def test_device_stages_do_not_synchronise(sequence):
    """Extraction, tracker, keyframe insert and BA on the card with torch's
    sync debug mode set to raise: none of them waits for the device."""
    dev = torch.device("cuda")
    cfg = SLAMConfig().replace(camera=CAM)
    grays, depths = (t.to(dev) for t in sequence)
    stamps = torch.arange(len(grays), dtype=torch.float32, device=dev) / 30.0
    k = Intrinsics.from_config(cfg.camera)
    det = mapping.Detections.empty(cfg.semantic.max_detections, dev)
    filt = filtered_mask(cfg, dev)
    sampler = tracker.generator_sampler(
        torch.Generator(device=dev).manual_seed(0))
    state0, map0 = tracker.init_state(cfg, dev), mapping.init_map(cfg, dev)

    def run():
        kps = orb.extract_batch(grays, cfg.orb)
        _, out = tracker.track_batch(cfg, state0, kps, depths, stamps,
                                     sampler)
        state = map0
        for i in range(len(grays)):
            kf = tracker.KeyframeBlock(*(a[i] for a in out.keyframe))
            state, _ = mapping.insert_keyframe(cfg, state, kf, det, filt)
        state, res = ba.run_ba(cfg, k, state)
        return mapping.prune(cfg, state.landmarks, stamps[-1]), res

    run()                       # first use: builds, caches, library handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        landmarks, res = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(landmarks.active.any())
    assert float(res.final_cost) <= float(res.initial_cost)
