"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (one JSON line each, prefixed "phase"):
  device   the card's name, count and nvidia-smi name/power limit;
  build    nvcc builds of every CUDA kernel of the main path (csrc/*.cu);
  kernels  each kernel against its plain PyTorch version on the card at the
           main path's shapes (720p, batch 24, 8 levels, 1024 keypoints a
           frame): results must be identical; times by CUDA events;
  small    the slice at 320x240 (the repository's pipeline fixture) on the
           card: extraction identical to the CPU plain path, ATE within the
           fixture's bound, BA fired and improved its cost;
  main     SLAMSystem(SLAMConfig()).process_batch on 720p synthetic frames in
           batches of 24 with BA on its 2 s input-time tick: 144 warm-up
           frames (BA must fire among them) and 240 timed ones; the kernels'
           launch counters are reset just before and read just after, and
           both must have grown.
Then the line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before the last
line.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch import kernels
from dynamic_visual_slam_tpu_torch.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu_torch.frontend import orb
from dynamic_visual_slam_tpu_torch.io import synthetic, trajectory
from dynamic_visual_slam_tpu_torch.ops import descriptors, fast, fields
from dynamic_visual_slam_tpu_torch.ops import image as imops
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# single f32 instructions (add, sub, min, max, mul) issue at most once per
# lane per clock: 132 SMs x 128 lanes x 1.98 GHz boost (H100 SXM), which is
# half the data sheet's 67 TFLOP/s, since that counts an FMA as two
F32_INSTR_PER_S = 132 * 128 * 1.98e9
BATCH = 24
WARMUP_BATCHES = 6             # 144 frames as bench.py: keyframes and a BA round
TIMED_BATCHES = 10             # 240 frames, BA fires on its 2 s tick
T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median milliseconds of fn() by CUDA events (after one warm call)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: float, n_instr: float):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_instr / F32_INSTR_PER_S
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

    # --- B1: FAST scores of all B x 8 levels -------------------------------
    got = fields.fast_score_batch(levels)
    want = [fast.corner_score(lv) for lv in levels]
    torch.cuda.synchronize()
    b1_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"fast_score differs from corner_score: max abs {b1_err}")
    b1_ms = cuda_ms(lambda: fields.fast_score_batch(levels))
    b1_plain = cuda_ms(lambda: [fast.corner_score(lv) for lv in levels])
    # one f32 read + one f32 written a pixel; ~175 f32 instructions a pixel
    # (16 differences, 2 x (64 window min/max + 15 arc max/min), 1 max)
    b1_bound, b1_by = bound(8 * n_px, 175 * n_px)

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
    # written; instructions (built with -fmad=false, so no FMA): 2 multiplies
    # and 2 adds a disc pixel, ~8 a sample, 1 a bit
    b2_bound, b2_by = bound(n_kp * (4 * n_disc + 4 * 512 + 16 + 256 + 8),
                            n_kp * (4 * n_disc + 8 * 512 + 256))
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
    ]
    emit("kernels", kernels=rows)
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
    launches = dict(kernels.launches)

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
         launches=launches, ba_log=slam.ba_log[-3:],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if slam.stats["ba_runs"] == ba_before:
        fail("main: BA never fired in the timed window")
    if not all(e["final_cost"] <= e["initial_cost"] for e in slam.ba_log):
        fail(f"main: a BA round raised its cost: {slam.ba_log}")
    if not math.isfinite(ate):
        fail("main: ATE not finite")
    for name in kernels.SOURCES:
        if launches.get(name, 0) < 1:
            fail(f"main: kernel {name} was not launched on the main path")
    return launches


def main() -> None:
    name, smi_line = phase_device()
    phase_build()
    cfg = SLAMConfig()
    frames = frames_720p()
    rows = phase_kernels(frames, cfg)
    phase_small()
    launches = phase_main(frames, cfg)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    emit("done", seconds=time.perf_counter() - T_START)
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
