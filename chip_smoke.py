"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (one JSON line each, prefixed "phase"):
  device   the card's name, count and nvidia-smi name/power limit;
  build    nvcc builds of every CUDA kernel (csrc/*.cu), one process each,
           all started together;
  kernels  each kernel against its plain PyTorch version on the card at the
           main path's shapes (720p, batch 24, 8 levels, 1024 keypoints a
           frame; kernel B3 on one 1280x720 frame, and on a 479x641 frame
           and fractional input): results must be identical; device times
           by CUDA events; bounds from bytes and instruction counts at the
           rates scripts/issue_rates.py measured (ISSUE_RATES);
  small    the slice at 320x240 (the repository's pipeline fixture) on the
           card: extraction identical to the CPU plain path, ATE within the
           fixture's bound, BA fired and improved its cost;
  main     SLAMSystem(SLAMConfig()).process_batch on 720p synthetic frames in
           batches of 24 with BA on its 2 s input-time tick, place
           recognition off: 144 warm-up frames (BA must fire among them) and
           240 timed ones;
  place_small   SLAMSystem.process with place recognition on (online
           vocabulary) on the relocalization fixture of tests/test_reloc.py
           (160x120, a blackout, then a replay): it must relocalize and
           bring the replay's ATE below 0.15 m;
  place_frames  SLAMSystem(SLAMConfig()) with the shipped vocabulary and every
           default on, frame by frame through process() at 720p, on two
           orbits of a revisit trajectory with injected depth-scale drift
           (scripts/loop720p.py's fixture): at least one loop must be
           verified and applied;
  place_batch   bench.py's place stage on the port: the shipped vocabulary,
           place recognition on, the 6-frame 720p fixture cycled, 72
           warm-up frames then 240 timed ones in batches of 24;
  yolo     YoloDetector with the shipped weights on three rendered 720p
           walker frames, on the card and on the CPU, at 640 (the config's
           input size) and at 256 (the size the weights embed, which the
           detector honours): logits, NMS and detections held against the
           CPU (phase_yolo says how); ms a call (median of 20), the
           forward and NMS alone;
  dynamic_small  the reference's in-loop culling proof
           (semantic/train.in_loop_eval): 320x240, 180 frames, seed 0,
           default_walkers, process() with culling off, with ground-truth
           boxes and with the learned detector; tests/test_dynamic.py's
           limits on ATE and walker landmarks;
  dynamic_frames  cli.main(["run", "--source", "dynamic", "--detector",
           "yolov8", ...]) in-process at 720p with every default on: fps,
           the detector and frame stages, ATE, walker and person landmarks.
The kernels' launch counters are reset just before main, place_frames,
place_batch, dynamic_small and dynamic_frames are driven and read just
after; B1 and B2 must have launched in each.  Then the line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before the last
line.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch import cli, convert, kernels
from dynamic_visual_slam_tpu_torch.config import (CameraConfig, MapConfig,
                                                  SLAMConfig)
from dynamic_visual_slam_tpu_torch.frontend import orb
from dynamic_visual_slam_tpu_torch.io import synthetic, trajectory
from dynamic_visual_slam_tpu_torch.models import yolov8
from dynamic_visual_slam_tpu_torch.ops import descriptors, fast, fields
from dynamic_visual_slam_tpu_torch.ops import image as imops
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
from dynamic_visual_slam_tpu_torch.semantic.detector import (
    YoloDetector, boxes_to_detections)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# Kernel B1's (and B3's) instructions a pixel, by class, counted in
# csrc/fast_score.cu.  A tile whose pixels are all integers in [0, 255]
# (every level of the main path) takes the packed branch: two pixels share
# each min/max, 2 x 25 two-input and 2 x 11 three-input (DPX) over the arcs
# (arc_extreme) and the score's max.s16x2 a pair; the score's bias (OR),
# subtraction and unpacking permute are 3 integer instructions a pixel, and
# 1 add makes it a float again.  Any other tile takes the f32 branch:
# 2 x 47 + 1 min/max and 2 subtractions a pixel.
FAST_INSTR_PER_PX = {"min_s16x2": 51 / 2, "min3_s16x2": 22 / 2, "int32": 3,
                     "fadd": 1}
FAST_F32_INSTR_PER_PX = {"fmin": 2 * 47 + 1, "fadd": 2}
# Instructions a second of each class (one lane's instruction counted once)
# on an NVIDIA H100 80GB HBM3 at 700 W, from one run of
# scripts/issue_rates.py (PERF.md §6 has it): min/max of every kind and
# 32-bit logic issue at half the f32 add rate, so they are counted on one
# pipe.
ISSUE_RATES = {"fmin": 1.6668e13, "fadd": 3.2570e13, "min_s16x2": 1.6685e13,
               "int32": 1.6669e13, "min3_s16x2": 1.6100e13}
PIPE = {"fmin": "alu", "min_s16x2": "alu", "min3_s16x2": "alu",
        "int32": "alu", "fadd": "fma"}
HIDE_HOST_CYCLES = 40_000_000  # cuda_ms's wait: about 20 ms at 1.98 GHz
BATCH = 24
WARMUP_BATCHES = 6             # 144 frames as bench.py: keyframes and a BA round
TIMED_BATCHES = 10             # 240 frames, BA fires on its 2 s tick
ORBIT_FRAMES = 240             # place_frames: frames per orbit (two orbits)
PLACE_SYNC_EVERY = 3           # place_batch: bench.py's default
PLACE_TIMED = 240              # place_batch: timed frames, as bench.py
ROOT = os.path.dirname(os.path.abspath(__file__))
VOCAB = os.path.join(ROOT, "assets", "orbvoc_synth.npz")
YOLO_WEIGHTS = os.path.join(ROOT, "assets", "yolov8n_synth.npz")
# tests/test_torch_yolo.py's bounds: every candidate above the score
# threshold, anchor by anchor, by input size; a detection at 256 (its
# detect test); a detection at 640, where that test has no counterpart (the
# reference and the port keep other classes on some frames there), as the
# candidate it is
YOLO_CANDIDATE_TOL_PX = {256: 2.75, 640: 4.3}
YOLO_BOX_TOL_PX = {256: 1.5, 640: 4.3}
DYNAMIC_SMALL_FRAMES = 180     # semantic/train.in_loop_eval's default
DYNAMIC_FRAMES = 120           # dynamic_frames: 720p frames
T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps(dict(phase=phase, **kw,
                          elapsed_s=time.perf_counter() - T_START)),
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device milliseconds of fn() by CUDA events (after one warm
    call).  Each timed call is queued behind a device-side wait of about
    20 ms (``HIDE_HOST_CYCLES``), so the host's part of the call (argument
    checks, building the launch) runs while the card waits and the events
    bracket device work only; without it a call that launches one short
    kernel is timed at its wrapper's host cost."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HIDE_HOST_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: float, n_instr: dict):
    """(ms, "bytes" or "operations"): the least time the card could take,
    from the bytes moved and the instructions of each class (``n_instr``)
    at that class's measured rate (``ISSUE_RATES``, instructions a second);
    the classes of one pipe add up, the pipes run side by side."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    per_pipe = collections.Counter()
    for c, n in n_instr.items():
        per_pipe[PIPE[c]] += n / ISSUE_RATES[c]
    t_ops = max(per_pipe.values())
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def frames_720p():
    cam = SLAMConfig().camera
    out = []
    for gray, depth, _, t_gt, _ in synthetic.generate_sequence(cam, 6, seed=3):
        out.append((gray.astype(np.uint8), (depth * 1000.0).astype(np.uint16),
                    t_gt))
    return out


def batch_at(frames, i0: int):
    idx = [(i0 + j) % len(frames) for j in range(BATCH)]
    gs = np.stack([frames[i][0] for i in idx])
    ds = np.stack([frames[i][1] for i in idx])
    return gs, ds, (i0 + np.arange(BATCH)) / 30.0, [frames[i][2] for i in idx]


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit("device", kind=name, count=torch.cuda.device_count(),
         nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda)
    return name, smi_line


def phase_build():
    t0 = time.perf_counter()
    per_kernel = kernels.build()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=per_kernel,
         kernels=sorted(kernels.SOURCES))


def phase_kernels(frames, cfg: SLAMConfig):
    dev = torch.device("cuda")
    gs, _, _, _ = batch_at(frames, 0)
    imgs = torch.from_numpy(gs).to(dev).to(torch.float32)
    levels = [lv.contiguous() for lv in imops.build_pyramid(
        imgs, cfg.orb.n_levels, cfg.orb.scale_factor)]
    n_px = sum(lv.numel() for lv in levels)

    def fast_instr(imgs):
        """B1's instructions for these images: the packed branch's counts
        where every pixel is a byte (no tile then takes the f32 branch)."""
        per_px = FAST_INSTR_PER_PX if all(
            bool(((x >= 0) & (x <= 255) & (x == torch.round(x))).all())
            for x in imgs) else FAST_F32_INSTR_PER_PX
        n = sum(x.numel() for x in imgs)
        return {c: k * n for c, k in per_px.items()}

    # --- B1: FAST scores of all B x 8 levels -------------------------------
    got = fields.fast_score_batch(levels)
    want = [fast.corner_score(lv) for lv in levels]
    torch.cuda.synchronize()
    b1_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"fast_score differs from corner_score: max abs {b1_err}")
    b1_ms = cuda_ms(lambda: fields.fast_score_batch(levels))
    b1_plain = cuda_ms(lambda: [fast.corner_score(lv) for lv in levels])
    # one f32 read + one f32 written a pixel
    b1_bound, b1_by = bound(8 * n_px, fast_instr(levels))

    # --- B3: FAST scores of one frame (corner_score_auto) ------------------
    img = imgs[0].contiguous()
    rng = np.random.default_rng(0)
    odd = torch.from_numpy(rng.integers(0, 256, (479, 641)).astype(
        np.float32)).to(dev)
    frac = img + torch.from_numpy(rng.random(img.shape).astype(
        np.float32)).to(dev)
    b3_err = 0.0
    for what, x in (("1280x720", img), ("479x641", odd),
                    ("fractional 1280x720", frac)):
        got3 = fast.corner_score_auto(x)
        want3 = fast.corner_score(x)
        torch.cuda.synchronize()
        err = float((got3 - want3).abs().max())
        b3_err = max(b3_err, err)
        if not torch.equal(got3, want3):
            fail(f"corner_score_auto differs from corner_score on {what}: "
                 f"max abs {err}")
    b3_ms = cuda_ms(lambda: fast.corner_score_auto(img))
    b3_plain = cuda_ms(lambda: fast.corner_score(img))
    b3_bound, b3_by = bound(8 * img.numel(), fast_instr([img]))

    # --- B2: moments + rBRIEF bits of all B x 1024 keypoint slots ----------
    _, inputs = orb.detect_batch(levels, got, cfg.orb)
    bits, m10, m01 = descriptors.descriptors_moments(*inputs)
    pbits, pm10, pm01 = descriptors.descriptors_moments_plain(*inputs)
    torch.cuda.synchronize()
    b2_err = max(float((bits.int() - pbits.int()).abs().max()),
                 float((m10 - pm10).abs().max()),
                 float((m01 - pm01).abs().max()))
    if not (torch.equal(bits, pbits) and torch.equal(m10, pm10)
            and torch.equal(m01, pm01)):
        fail(f"orb_desc_moments differs from its plain version: "
             f"{int((bits != pbits).sum())} bits, max abs {b2_err}")
    b2_ms = cuda_ms(lambda: descriptors.descriptors_moments(*inputs))
    b2_plain = cuda_ms(lambda: descriptors.descriptors_moments_plain(*inputs))
    n_kp = int(inputs.level.numel())
    n_disc = len(descriptors._disc_offsets()[0])
    # per keypoint: the disc's raw pixels and the 512 blurred samples read
    # once, 16 bytes of (level, frame, y, x) read, 256 bits + 2 moments
    # written; f32 instructions (built with -fmad=false, so no FMA), at the
    # add rate: 2 multiplies and 2 adds a disc pixel, ~8 a sample, 1 a bit
    b2_bound, b2_by = bound(n_kp * (4 * n_disc + 4 * 512 + 16 + 256 + 8),
                            {"fadd": n_kp * (4 * n_disc + 8 * 512 + 256)})
    rows = [
        dict(name="fast_score", route="cuda",
             source="dynamic_visual_slam_tpu_torch/csrc/fast_score.cu",
             replaces="dynamic_visual_slam_tpu/ops/fields.py:130",
             max_abs_err=b1_err, ms=b1_ms, plain_ms=b1_plain,
             bound_ms=b1_bound, bound_by=b1_by, library_ms=None,
             shape=f"{BATCH} frames x {len(levels)} levels, {n_px} px"),
        dict(name="orb_desc_moments", route="cuda",
             source="dynamic_visual_slam_tpu_torch/csrc/orb_desc_moments.cu",
             replaces="dynamic_visual_slam_tpu/ops/descriptors.py:163",
             max_abs_err=b2_err, ms=b2_ms, plain_ms=b2_plain,
             bound_ms=b2_bound, bound_by=b2_by, library_ms=None,
             shape=f"{n_kp} keypoints"),
        dict(name=fast.B3_COUNTER, route="cuda",
             source="dynamic_visual_slam_tpu_torch/csrc/fast_score.cu",
             replaces="dynamic_visual_slam_tpu/ops/fast.py:111",
             max_abs_err=b3_err, ms=b3_ms, plain_ms=b3_plain,
             bound_ms=b3_bound, bound_by=b3_by, library_ms=None,
             shape="one 1280x720 frame (and 479x641, fractional)"),
    ]
    emit("kernels", kernels=rows, fast_instr=fast_instr(levels))
    return rows


def run_slice(slam: SLAMSystem, batches):
    for gs, ds, tss in batches:
        slam.process_batch(gs, ds, tss)
    slam.finalize()
    torch.cuda.synchronize()


def phase_small():
    """The repository's pipeline fixture (tests/test_pipeline.py: 320x240,
    70 frames, seed 11) through the port on the card, in batches of 7."""
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5)
    cfg = SLAMConfig().replace(camera=cam)
    seq = list(synthetic.generate_sequence(cam, 70, seed=11,
                                           depth_noise=0.004))
    gs = np.stack([f[0] for f in seq]).astype(np.uint8)
    ds = (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16)
    tss = np.asarray([f[4] for f in seq])
    gt = np.stack([f[3] for f in seq])

    # extraction on the card == the plain path on the CPU
    k_gpu = orb.extract_batch(torch.from_numpy(gs[:7]).cuda(), cfg.orb)
    k_cpu = orb.extract_batch(torch.from_numpy(gs[:7]), cfg.orb)
    for name in ("uv", "response", "octave", "mask", "desc_bits"):
        a, b = getattr(k_gpu, name).cpu(), getattr(k_cpu, name)
        if not torch.equal(a, b):
            fail(f"small: extract_batch.{name} differs between cuda and cpu")
    # atan2 of identical moments: CUDA's and the CPU's atan2 may differ
    # in the last ulp
    angle_err = float((k_gpu.angle.cpu() - k_cpu.angle).abs().max())
    if angle_err > 1e-5:
        fail(f"small: extract_batch.angle differs by {angle_err} rad")

    slam = SLAMSystem(cfg, ba_async=False, device="cuda")
    run_slice(slam, [(gs[i:i + 7], ds[i:i + 7], tss[i:i + 7])
                     for i in range(0, 70, 7)])
    _, _, est = slam.frontend_trajectory()
    if not np.isfinite(est).all():
        fail("small: non-finite poses")
    ate = trajectory.ate_rmse(est, gt)
    dist = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    bound = max(0.05, 0.06 * dist)
    if ate >= bound:
        fail(f"small: ATE {ate} >= {bound}")
    if slam.stats["ba_runs"] < 1 or not all(
            e["final_cost"] < e["initial_cost"] for e in slam.ba_log):
        fail(f"small: BA did not run or improve: {slam.ba_log}")
    emit("small", ate_m=ate, ate_bound_m=bound, angle_err_rad=angle_err,
         stats=slam.stats,
         ba_log=slam.ba_log)


def warm_up(slam: SLAMSystem, frames):
    """Batches 0 .. WARMUP_BATCHES-1 from host arrays, as bench.py does; BA
    must have fired, so no first-use cost lands in a timed window.  Returns
    their ground-truth poses."""
    warm, gts = [], []
    for i in range(WARMUP_BATCHES):
        gs, ds, tss, gt = batch_at(frames, i * BATCH)
        warm.append((gs, ds, tss))
        gts += gt
    run_slice(slam, warm)
    if slam.stats["ba_runs"] < 1:
        fail("main: BA never fired during warm-up")
    return gts


def stage(frames, first: int, n: int):
    """Batches first .. first+n-1 copied to the card, and their poses."""
    staged, gts = [], []
    for i in range(first, first + n):
        gs, ds, tss, gt = batch_at(frames, i * BATCH)
        staged.append((torch.from_numpy(gs).cuda(), torch.from_numpy(ds).cuda(),
                       tss))
        gts += gt
    torch.cuda.synchronize()
    return staged, gts


def phase_main(frames, cfg: SLAMConfig):
    slam = SLAMSystem(cfg, enable_place_recognition=False, device="cuda")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gts = warm_up(slam, frames)
    warm_s = time.perf_counter() - t0
    staged, gt_timed = stage(frames, WARMUP_BATCHES, TIMED_BATCHES)
    gts += gt_timed
    ba_before = slam.stats["ba_runs"]
    t1 = time.perf_counter()
    per_batch = []
    for gs, ds, tss in staged:
        tb = time.perf_counter()
        slam.process_batch(gs, ds, tss)
        per_batch.append((time.perf_counter() - tb) * 1e3)
    slam.finalize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = collections.Counter(kernels.launches)

    _, _, est = slam.frontend_trajectory()
    gt = np.stack(gts)
    if est.shape != gt.shape or not np.isfinite(est).all():
        fail(f"main: trajectory shape {est.shape} / finite "
             f"{np.isfinite(est).all()}")
    ate = trajectory.ate_rmse(est, gt)
    lms = slam.landmarks_world()
    n_frames = TIMED_BATCHES * BATCH
    emit("main", fps=n_frames / dt, ms_per_batch=dt * 1e3 / TIMED_BATCHES,
         ms_per_batch_host=per_batch, timed_frames=n_frames,
         warmup_s=warm_s, ba_runs=slam.stats["ba_runs"],
         ba_runs_timed=slam.stats["ba_runs"] - ba_before,
         keyframes=slam.stats["keyframes"], landmarks=int(len(lms["xyz"])),
         ate_m=ate, tracking_ok=float(np.mean([f.tracking_ok
                                               for f in slam.trajectory])),
         launches=dict(launches), ba_log=slam.ba_log[-3:],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if slam.stats["ba_runs"] == ba_before:
        fail("main: BA never fired in the timed window")
    if not all(e["final_cost"] <= e["initial_cost"] for e in slam.ba_log):
        fail(f"main: a BA round raised its cost: {slam.ba_log}")
    if not math.isfinite(ate):
        fail("main: ATE not finite")
    check_launches("main", launches)
    return launches


def check_launches(phase: str, launches) -> None:
    for name in kernels.SOURCES:
        if launches.get(name, 0) < 1:
            fail(f"{phase}: kernel {name} was not launched")


def phase_place_small():
    """tests/test_reloc.py's fixture and system arguments on the card: a
    wandering segment, 6 blank frames while the camera jumps back, then a
    replay of the segment from its 10th frame."""
    cam = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                       cx=79.5, cy=59.5)
    base = SLAMConfig()
    cfg = base.replace(
        camera=cam,
        keyframe=dataclasses.replace(base.keyframe, max_frames_between_kf=6),
        map=MapConfig(max_landmarks=1024, max_keyframes=8,
                      max_obs_per_landmark=6, max_obs_per_keyframe=256))
    seg = list(synthetic.generate_sequence(cam, 60, seed=5,
                                           depth_noise=0.004))
    blank = np.zeros((cam.height, cam.width), np.float32)
    frames = [(g, d, t) for g, d, _, t, _ in seg]
    frames += [(blank, np.ones_like(blank), None)] * 6
    frames += [(g, d, t) for g, d, _, t, _ in seg[10:]]
    slam = SLAMSystem(cfg, vocab_train_keyframes=3, loop_min_gap=4,
                      loop_min_score=0.08, loop_min_inliers=20,
                      loop_correction=False, device="cuda")
    t0 = time.perf_counter()
    for i, (g, d, _) in enumerate(frames):
        slam.process(g, d, i / 30.0)
    slam.finalize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    est = np.stack([f.t_wc for f in slam.trajectory])[66:]
    gt = np.stack([t for _, _, t in frames[66:]])
    ate = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
    emit("place_small", frames=len(frames), seconds=dt, replay_ate_m=ate,
         stats=slam.stats, reloc_log=slam.reloc_log,
         loop_candidates=len(slam.loop_candidates))
    if slam.stats["relocalizations"] < 1:
        fail(f"place_small: no relocalization: {slam.reloc_log}")
    if not ate < 0.15:
        fail(f"place_small: replay ATE {ate} >= 0.15")


def revisit_frames(cam: CameraConfig, n_orbit: int, drift: float = 0.35):
    """scripts/loop720p.py's fixture: the seed-5 scene, two orbits of
    loop_trajectory (radius 0.35, then 0.34), depth scaled by up to
    1 + drift over the run.  → [(gray u8, depth mm u16, t_gt)]."""
    scene = synthetic.SyntheticScene(cam, seed=5)
    poses = synthetic.loop_trajectory(n_orbit) + \
        synthetic.loop_trajectory(n_orbit, radius=0.34)
    out = []
    for i, (r, t) in enumerate(poses):
        gray, depth = scene.render(r, t)
        scale = 1.0 + drift * i / len(poses)
        out.append((gray.astype(np.uint8),
                    (depth * scale * 1000.0).astype(np.uint16), t))
    return out


def phase_place_frames(cfg: SLAMConfig):
    """Every default on, the shipped vocabulary, frame by frame."""
    cfg = cfg.replace(depth=dataclasses.replace(cfg.depth, max_depth=6.0))
    frames = revisit_frames(cfg.camera, ORBIT_FRAMES)
    slam = SLAMSystem(cfg, vocab_path=VOCAB, device="cuda")
    slam.warmup_place()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    per_frame = []
    t0 = time.perf_counter()
    for i, (g, d, _) in enumerate(frames):
        tf = time.perf_counter()
        slam.process(g, d, i / 30.0)
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - tf) * 1e3)
    slam.finalize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)
    _, _, est = slam.frontend_trajectory()
    gt = np.stack([t for _, _, t in frames])
    ate = trajectory.ate_rmse(est, gt) if est.shape == gt.shape else \
        float("nan")
    applied = slam.stats.get("loops_applied", 0)
    emit("place_frames", frames=len(frames), orbit_frames=ORBIT_FRAMES, fps=len(
        frames) / dt, ms_per_frame_median=statistics.median(per_frame),
        ms_per_frame_p90=float(np.percentile(per_frame, 90)),
        keyframes=slam.stats["keyframes"],
        loop_candidates=slam.stats["loop_candidates"], loops_applied=applied,
        relocalizations=slam.stats["relocalizations"],
        ba_runs=slam.stats["ba_runs"], ate_m=ate, launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        loops=[{k: r[k] for k in ("keyframe", "candidate", "inliers",
                                  "pnp_inliers") if k in r}
               for r in slam.loop_candidates[:12]])
    if est.shape != gt.shape or not np.isfinite(est).all():
        fail(f"place_frames: trajectory shape {est.shape} or not finite")
    if slam.stats["loop_candidates"] < 1 or applied < 1:
        fail(f"place_frames: {slam.stats['loop_candidates']} loops verified, "
             f"{applied} applied")
    check_launches("place_frames", launches)


def phase_place_batch(frames, cfg: SLAMConfig):
    """bench.py's _place_bench on the port, with its default sync_every."""
    slam = SLAMSystem(cfg, enable_place_recognition=True, vocab_path=VOCAB,
                      sync_every=PLACE_SYNC_EVERY, device="cuda")
    slam.warmup_place()
    kernels.reset_launch_counts()
    for i0 in range(0, 72, BATCH):
        gs, ds, tss, _ = batch_at(frames, i0)
        slam.process_batch(gs, ds, tss)
    slam.finalize()
    staged = []
    for i0 in range(72, 72 + PLACE_TIMED, BATCH):
        gs, ds, tss, _ = batch_at(frames, i0)
        staged.append((torch.from_numpy(gs).cuda(),
                       torch.from_numpy(ds).cuda(), tss))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for gs, ds, tss in staged:
        slam.process_batch(gs, ds, tss)
    slam.finalize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)
    emit("place_batch", fps_with_place=PLACE_TIMED / dt,
         timed_frames=PLACE_TIMED, sync_every=PLACE_SYNC_EVERY, keyframes=slam.stats["keyframes"],
         loop_checks=len(slam.loop_candidates) + len(slam.reloc_log),
         stats=slam.stats, launches=launches)
    if len(slam.trajectory) != 72 + PLACE_TIMED:
        fail(f"place_batch: {len(slam.trajectory)} frames emitted")
    check_launches("place_batch", launches)


def host_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of fn() on the host clock, each call ended by
    torch.cuda.synchronize() (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_yolo():
    """The detector on the card against the CPU on three 720p walker
    frames, at 640 (the config's input size) and at the weights' own size
    (256), both fed the CPU's letterbox: (a) every scale's logits within
    2 % of its largest magnitude (tests/test_torch_yolo.py's bound); (b) the
    card's NMS on the CPU's decoded candidates equal to the CPU's in every
    output; (c) the decoded boxes of every candidate above the score
    threshold, anchor by anchor, within YOLO_CANDIDATE_TOL_PX; (d) the
    whole detector, on frames whose margins are clear (no candidate's best
    score within 0.01 of the threshold): the same classes, and for each of
    the CPU's detections a card detection of its class within
    YOLO_BOX_TOL_PX of a member of its tied group (box_errors).  Scores
    saturate at 1.0 on these frames, and among boxes that tie, last-bit
    differences decide which one NMS keeps."""
    cam = SLAMConfig().camera
    rgbs = [np.stack([g] * 3, -1).astype(np.uint8) for g, *_ in
            synthetic.generate_dynamic_sequence(cam, 3, seed=0)]
    params = convert.load_params(YOLO_WEIGHTS)
    weights = {k: v for k, v in params.items() if k != "input_size"}
    base = SLAMConfig()
    sizes = {}
    for size in (640, int(params["input_size"])):
        cfg = base.replace(semantic=dataclasses.replace(base.semantic,
                                                        input_size=size))
        sc = cfg.semantic

        def nms(boxes, cls):
            return yolov8.nms(boxes, cls, sc.max_detections,
                              sc.score_threshold, sc.iou_threshold)

        gpu = YoloDetector(cfg, params=weights, device="cuda")
        cpu = YoloDetector(cfg, params=weights, device="cpu")
        r = dict(logit_err=0.0, letterbox_err=0.0, candidate_err_px=0.0,
                 candidates=0, box_err_px=0.0, frames_unclear=0,
                 frames_differing=0, detections=0, detections_tied=0)
        for rgb in rgbs:
            canvas = cpu.letterbox(rgb)[0]
            r["letterbox_err"] = max(r["letterbox_err"], float(
                (gpu.letterbox(rgb)[0].cpu() - canvas).abs().max()))
            x = canvas.permute(2, 0, 1)[None]
            with torch.inference_mode():
                want_out = cpu.model(x)
                got_out = gpu.model(x.cuda())
            for wo, go in zip(want_out, got_out):
                for w, g in zip(wo, go):
                    r["logit_err"] = max(r["logit_err"], float(
                        (g.cpu() - w).abs().max() / w.abs().max()))
            wb, wc = yolov8.decode(want_out)
            gb, gc = (t.cpu() for t in yolov8.decode(got_out))
            hot = wc.amax(1) > sc.score_threshold
            r["candidates"] += int(hot.sum())
            r["candidate_err_px"] = max(r["candidate_err_px"], float(
                (gb[hot] - wb[hot]).abs().max()))
            want = nms(wb, wc)
            same_in = yolov8.RawDetections(*(
                t.cpu() for t in nms(wb.cuda(), wc.cuda())))
            if not all(torch.equal(a, b) for a, b in zip(same_in, want)):
                fail(f"yolo at {size}: NMS on the card differs from the CPU "
                     "on the same candidates")
            top = torch.topk(wc.amax(1), min(256, len(wc))).values
            if bool(((top - sc.score_threshold).abs() < 0.01).any()):
                r["frames_unclear"] += 1
                continue
            got = yolov8.RawDetections(*(t.cpu() for t in nms(gb, gc)))
            gv, wv = got.valid, want.valid
            if sorted(got.classes[gv].tolist()) != \
                    sorted(want.classes[wv].tolist()):
                r["frames_differing"] += 1
                continue
            err, tied = box_errors(want, got, wb, wc, sc.iou_threshold)
            r["detections"] += len(err)
            r["detections_tied"] += sum(tied)
            r["box_err_px"] = max([r["box_err_px"]] + err)
        canvas = gpu.letterbox(rgbs[0])[0]
        x = canvas.permute(2, 0, 1)[None]
        with torch.inference_mode():
            boxes, cls = yolov8.decode(gpu.model(x))
            r.update(
                call_ms=host_ms(lambda: gpu(rgbs[0])),
                forward_ms=host_ms(lambda: gpu.model(x)),
                forward_device_ms=cuda_ms(lambda: gpu.model(x), reps=20),
                nms_ms=host_ms(lambda: nms(boxes, cls)),
                nms_device_ms=cuda_ms(lambda: nms(boxes, cls), reps=20))
        sizes[size] = r
        if r["logit_err"] > 0.02:
            fail(f"yolo at {size}: logits differ by {r['logit_err']:.4f} "
                 "of the largest magnitude (bound 0.02)")
        if r["candidate_err_px"] > YOLO_CANDIDATE_TOL_PX[size]:
            fail(f"yolo at {size}: candidate boxes differ by "
                 f"{r['candidate_err_px']} px (bound "
                 f"{YOLO_CANDIDATE_TOL_PX[size]})")
        if r["frames_differing"] or r["box_err_px"] > YOLO_BOX_TOL_PX[size] \
                or r["detections"] < 1:
            fail(f"yolo at {size}: {r['frames_differing']} frames with "
                 f"other classes, {r['detections']} detections, boxes "
                 f"within {r['box_err_px']} px (bound "
                 f"{YOLO_BOX_TOL_PX[size]})")
        if r["letterbox_err"] > 1e-5:
            fail(f"yolo at {size}: letterbox differs by {r['letterbox_err']}")
    emit("yolo", frames=len(rgbs), sizes=sizes)


def box_errors(want, got, boxes, cls, iou_thr: float):
    """For each valid detection of ``want`` (the CPU's): its tied group is
    its own box and the CPU's candidates (``boxes``, ``cls``) of its class
    that overlap it by more than iou_thr and score within 0.01 of it; its
    error is the distance in px (largest coordinate) from the nearest
    detection of ``got`` (the card's) of its class to the nearest member of
    the group.  → (errors, whether the group has another member)."""
    best, best_cls = cls.amax(1), cls.argmax(1)
    g_boxes, g_cls = got.boxes[got.valid], got.classes[got.valid]
    errs, tied = [], []
    for box, score, c in zip(want.boxes[want.valid], want.scores[want.valid],
                             want.classes[want.valid]):
        member = (yolov8._iou(box[None], boxes) > iou_thr) \
            & (best_cls == c) & ((best - score).abs() <= 0.01)
        group = torch.cat([box[None], boxes[member]])
        mine = g_boxes[g_cls == c]
        errs.append(float((mine[:, None] - group[None]).abs().amax(-1).min())
                    if len(mine) else float("inf"))
        tied.append(bool((member & ~(boxes == box).all(1)).any()))
    return errs, tied


def walker_landmarks(est_t, gt_t, xyz, n_obs, objects, duration_s):
    """semantic/train.in_loop_eval's count: landmarks in the estimated
    frame aligned onto the ground truth (the rigid alignment of ATE), then
    those inside a walker's swept volume → (confirmed ones with n_obs >= 2,
    all)."""
    r, t = trajectory.umeyama_alignment(np.asarray(est_t, np.float64),
                                        np.asarray(gt_t, np.float64))
    hits = synthetic.walker_swept_hits(
        np.asarray(xyz, np.float64) @ r.T + t, objects, duration_s)
    return int(np.sum(hits & (np.asarray(n_obs) >= 2))), int(np.sum(hits))


def run_dynamic_small(device, n_frames: int = DYNAMIC_SMALL_FRAMES):
    """semantic/train.in_loop_eval on the port: culling off, ground-truth
    boxes, the learned detector (the shipped weights at their 256)."""
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5)
    cfg = SLAMConfig().replace(camera=cam)
    objs = synthetic.default_walkers(n_frames)
    frames = list(synthetic.generate_dynamic_sequence(
        cam, n_frames, seed=0, objects=objs, depth_noise=0.004))
    gt_t = np.stack([f[3] for f in frames])
    detector = YoloDetector(cfg, weights_path=YOLO_WEIGHTS, device=device)
    cap = cfg.semantic.max_detections
    results = {}
    for cond in ("off", "gt", "learned"):
        slam = SLAMSystem(cfg, ba_async=False,
                          enable_place_recognition=False, device=device)
        kernels.reset_launch_counts()
        n_boxes = 0
        t0 = time.perf_counter()
        for gray, depth, _, _, ts, boxes in frames:
            det = None
            if cond == "gt":
                det = boxes_to_detections(boxes, cap, device=device)
            elif cond == "learned":
                det = detector(np.stack([gray] * 3, -1))
                n_boxes += int(det.mask.sum())
            slam.process(gray, depth, ts, detections=det)
        slam.finalize()
        seconds = time.perf_counter() - t0
        _, _, est_t = slam.frontend_trajectory()
        lms = slam.landmarks_world()
        confirmed, anywhere = walker_landmarks(est_t, gt_t, lms["xyz"],
                                               lms["n_obs"], objs,
                                               n_frames / 30.0)
        results[cond] = dict(
            ate_m=trajectory.ate_rmse(est_t, gt_t),
            walker_landmarks_confirmed=confirmed,
            walker_landmarks_any=anywhere,
            person_landmarks=int(np.sum(lms["category"] == 1)),
            landmarks=int(len(lms["xyz"])),
            keyframes=slam.stats["keyframes"], seconds=seconds,
            ms_per_frame=seconds * 1e3 / n_frames,
            launches=dict(kernels.launches))
        if cond == "learned":
            results[cond]["detections_total"] = n_boxes
    return results


def dynamic_small_failures(res):
    """tests/test_dynamic.py's limits on the three conditions."""
    off, gt, learned = res["off"], res["gt"], res["learned"]
    c_off = off["walker_landmarks_confirmed"]
    checks = [
        (c_off >= 8, f"off has {c_off} confirmed walker landmarks (< 8)"),
        (gt["walker_landmarks_confirmed"] <= max(2, c_off // 5),
         f"gt keeps {gt['walker_landmarks_confirmed']} confirmed walker "
         f"landmarks (> max(2, {c_off} // 5))"),
        (off["ate_m"] > 1.35 * gt["ate_m"],
         f"ATE off {off['ate_m']} not above 1.35 x gt {gt['ate_m']}"),
        (gt["person_landmarks"] == 0 and learned["person_landmarks"] == 0,
         "a landmark has the person category"),
        (learned["walker_landmarks_confirmed"] < c_off,
         f"learned keeps {learned['walker_landmarks_confirmed']} confirmed "
         f"walker landmarks, off {c_off}"),
    ]
    return [msg for ok, msg in checks if not ok]


def phase_dynamic_small():
    res = run_dynamic_small("cuda")
    emit("dynamic_small", frames=DYNAMIC_SMALL_FRAMES, **res)
    bad = dynamic_small_failures(res)
    if bad:
        fail("dynamic_small: " + "; ".join(bad))
    for cond, r in res.items():
        check_launches(f"dynamic_small/{cond}", r["launches"])


def run_dynamic_frames(device, n_frames: int = DYNAMIC_FRAMES,
                       width: int = 1280, height: int = 720, seed: int = 0):
    """cli run on the walker scene with the learned detector, every
    default on (place recognition with an online vocabulary, pose-graph
    loop correction, relocalization), in-process; returns its stats and the
    walker and person landmarks of the system it ran."""
    out_dir = os.path.join(ROOT, "build", f"dynamic_frames_{device}")
    argv = ["run", "--source", "dynamic", "--detector", "yolov8",
            "--weights", YOLO_WEIGHTS, "--frames", str(n_frames),
            "--width", str(width), "--height", str(height),
            "--seed", str(seed), "--device", device, "--out-dir", out_dir]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run = {}
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv, out=run)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if rc != 0:
        fail(f"dynamic_frames: cli run returned {rc}")
    slam, gt = run["system"], run["gt_positions"]
    stamps, _, est_t = slam.frontend_trajectory()
    if len(stamps) != len(gt):
        fail(f"dynamic_frames: {len(stamps)} frames for {len(gt)} stamps")
    gt_t = np.stack([gt[k] for k in sorted(gt)])
    lms = slam.landmarks_world()
    walkers, anywhere = walker_landmarks(
        est_t, gt_t, lms["xyz"], lms["n_obs"],
        synthetic.default_walkers(n_frames), n_frames / 30.0)
    return dict(argv=argv, seconds=seconds, launches=launches,
                walker_landmarks_confirmed=walkers,
                walker_landmarks_any=anywhere,
                person_landmarks=int(np.sum(lms["category"] == 1)),
                stats=run["stats"])


def phase_dynamic_frames():
    res = run_dynamic_frames("cuda")
    st = res["stats"]
    stages = {k: {m: v.get(m) for m in ("count", "first_ms", "median_ms",
                                         "p90_ms")}
              for k, v in st["stages"].items()}
    emit("dynamic_frames", frames=DYNAMIC_FRAMES, fps=st["fps"],
         wall_s=st["wall_s"], seconds=res["seconds"], stages=stages,
         ate_m=st.get("ate_rmse_m"),
         walker_landmarks_confirmed=res["walker_landmarks_confirmed"],
         walker_landmarks_any=res["walker_landmarks_any"],
         person_landmarks=res["person_landmarks"],
         landmarks=st["landmarks"], keyframes=st["keyframes"],
         loop_candidates=st["loop_candidates"],
         relocalizations=st["relocalizations"], ba_runs=st["ba_runs"],
         launches=res["launches"], argv=res["argv"][1:])
    ate = st.get("ate_rmse_m")
    if ate is None or not math.isfinite(ate):
        fail(f"dynamic_frames: ATE {ate}")
    if res["person_landmarks"] != 0:
        fail(f"dynamic_frames: {res['person_landmarks']} person landmarks")
    if st["frames"] != DYNAMIC_FRAMES:
        fail(f"dynamic_frames: {st['frames']} frames processed")
    check_launches("dynamic_frames", res["launches"])


def main() -> None:
    name, smi_line = phase_device()
    phase_build()
    cfg = SLAMConfig()
    frames = frames_720p()
    rows = phase_kernels(frames, cfg)
    phase_small()
    launches = phase_main(frames, cfg)
    phase_place_small()
    phase_place_frames(cfg)
    phase_place_batch(frames, cfg)
    phase_yolo()
    phase_dynamic_small()
    phase_dynamic_frames()
    for r in rows:
        # the main path's count; B3 (corner_score) has no caller there
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    emit("done", seconds=time.perf_counter() - T_START)
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
