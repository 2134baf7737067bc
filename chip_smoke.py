"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (one JSON line each, prefixed "phase"):
  device   the card's name, count and nvidia-smi name/power limit;
  build    nvcc builds of every CUDA kernel (csrc/*.cu), one process each,
           all started together;
  kernels  each kernel against its plain PyTorch version on the card at the
           main path's shapes (720p, batch 24, 8 levels, 1024 keypoints a
           frame; kernel B3 on one 1280x720 frame, and on a 479x641 frame
           and fractional input; orb_detect (D1) on B1's score maps at B =
           1, 8 and 24; pnp_ransac at the tracker's shapes, 1024
           slots, 192 hypotheses and a prior, at B = 1, 8 and 24): results
           must be identical; device times
           by CUDA events; bounds from bytes and instruction counts at the
           rates scripts/issue_rates.py measured (ISSUE_RATES);
  small    the slice at 320x240 (the repository's pipeline fixture) on the
           card: extraction identical to the CPU plain path, ATE within the
           fixture's bound, BA fired and improved its cost;
  main     SLAMSystem(SLAMConfig()).process_batch on 720p synthetic frames in
           batches of 24 with BA on its 2 s input-time tick, place
           recognition off, sync_every 3 (rs720.replay's): 144 frames, the
           first 4 batches from host arrays, the last 2 copied to the card
           before their calls; every frame must be emitted, BA must fire
           and no round may raise its cost, the ATE must be finite;
  place_batch  the same through process_batch with the shipped defaults:
           the shipped vocabulary, place recognition on, warmup_place,
           sync_every 3, 96 frames (the last batch on the card); every
           frame emitted, BA fired, every kernel but B3 launched;
  place_small   SLAMSystem.process with place recognition on (online
           vocabulary) on the relocalization fixture of tests/test_reloc.py
           (160x120, a blackout, then a replay): it must relocalize and
           bring the replay's ATE below 0.15 m;
  place_frames  SLAMSystem(SLAMConfig()) with the shipped vocabulary and every
           default on, frame by frame through process() at 720p, on two
           orbits of 180 frames (cut from 240 for the script's time
           limit) of a revisit trajectory with injected depth-scale drift
           (scripts/loop720p.py's fixture): at least one loop must be
           verified and applied;
  fleet_small  tests/test_parallel.py's fleet checks on the card (160x120,
           2 streams): stream 0 against a solo SLAMSystem.process run with
           the same draws (first 3 frames within 1e-5 m, all within 2 cm
           and 0.5 deg, keyframes within 1, landmarks within max(20,
           10 %)); step_batch against T step() calls (1e-6 m, flags equal,
           nothing dropped with kf_slots = T);
  fleet    bench.py's _fleet_bench set-up on the port:
           SLAMFleet(SLAMConfig()), 8 streams at 720p on make_mesh(min(8,
           cards)) as bench.py's (one shard on a one-card machine), each
           stream offset by its index in the 6-frame cycle: one step_batch
           call of 24 scan steps and one run_ba; BA rounds and per-stream
           counters; launches of one scan step (a step() call) under
           torch.profiler at B = 8 against B = 1 (stream 0's frame), which
           must stay below twice a shard's; B1, D1 and B2 must launch once
           a shard a scan step of the step_batch call;
  fleet_mesh  the fleet on a two-shard mesh (the first two cards, else
           ["cuda:0", "cuda:0"]: two shards, a thread each, on one card)
           against the one-device fleet, both on keyed draws: 2 streams at
           160x120 through step and step_batch (1e-6 m, flags equal); then
           SLAMConfig() at 720p, 8 streams as fleet, step_batch calls of 12
           scan steps (cut from 24 for the script's time limit), 1 warm-up
           and 1 timed a fleet, then run_ba: per
           stream tests/test_parallel.py's bounds (all 2 cm and 0.5 deg,
           keyframes within 1; the first 3 frames within 1.5e-4 m, 1.5
           times the card's measured split), BA costs finite, B1,
           D1 and B2 once a shard a scan step; aggregate fps of both fleets
           (does a thread a shard overlap the host's launch work?) and
           peak memory;
  snapshot place_small's fixture with place recognition on: the first
           half through process(), save(), restore() into a fresh system,
           both continue: flags equal, positions within 1e-6 m (else the
           first frame and output that differ); then cli run --save-state
           and --resume at 720p;
  yolo     YoloDetector with the shipped weights on three rendered 720p
           walker frames, on the card and on the CPU, at 640 (the config's
           input size) and at 256 (the size the weights embed, which the
           detector honours): logits, NMS and detections held against the
           CPU (phase_yolo says how); ms a call (median of 20), the
           forward and NMS alone;
  dynamic_small  the reference's in-loop culling proof, through the
           port's semantic/train.in_loop_eval, one call a condition:
           320x240, 180 frames, seed 0, default_walkers, process() with
           culling off, with ground-truth boxes and with the learned
           detector; tests/test_dynamic.py's limits on ATE and walker
           landmarks;
  dynamic_frames  cli.main(["run", "--source", "dynamic", "--detector",
           "yolov8", ...]) in-process at 720p with every default on, 16
           frames (cut from 120 for the script's time limit): every frame
           processed, ATE finite, no person landmark, walker landmarks;
  importers  an ultralytics-layout .pt with seeded random weights and
           BatchNorm statistics through YoloDetector(weights_path=...pt)
           against the converted tree on three 720p walker frames (equal
           detections), save_params → load_params bit for bit, the
           ORBvoc.txt fixture's descend on the card equal to the CPU's;
  train_vocab  place/pretrain.train_pretrained_vocabulary at the
           reference's width (k 10, depth 3, 500 a frame, 424x240, 12
           scenes, 8 frames each, cut from 24): B1, D1 and B2 once a frame,
           retrieval accuracy at least the reference's less one scene;
  train_detector  semantic/train.train of YOLOv8n at 256, batch 16, 200
           steps on 128 rendered images (cut from 1500 and 384): the loss
           falling, held-out mean best IoU at least 0.05 above the
           initialisation's; its own loop of train_step calls: ms a step,
           images/s, launches of one profiled step; peak memory; the loss
           and gradients on the card against the CPU within
           tests/test_torch_train.py's bounds at 128 and at 256, and the
           median leaf's within TRAIN_GRAD_MEDIAN_TOL at 256;
  tools    cli run --trace --serve 0 --serve-every 5 at 424x240 on 20
           frames between two runs without them (fps and frame ms of the
           three), the live view held 2 s (DVS_SERVE_HOLD_S) while a thread
           fetches /, /stats.json, /map.json and /frame.jpg: trace.json
           holds 20 "frame" begin/end pairs, /stats.json 20 frames,
           /frame.jpg a JPEG; B1, D1 and B2 once a frame; keyframes and
           positions (1e-6 m) equal to the command without --trace and
           --serve; then cli run --threaded at 720p on 12 frames, which must
           take the native runtime's NativeQueue (built with g++ on the
           host); NativeQueue.pop of one 720p frame against the
           reference's slice copy (ms, host clock);
  parity   cli parity at 424x240, 120 frames, seed 0, anchored: the
           port's ATE must be below the CPU oracle's (the reference's
           claim for its anchored cells); the oracle's ATE beside the one
           of the cached oracle trajectory (parity_sweep/oracle_cache),
           printed, not gated, with the fingerprint that file is keyed by
           and this run's config fingerprint: they differ, the cached
           oracle comes from an older config; B1, D1 and B2 once a frame; then
           backend/ba.optimize on the card against oracle/ba_cpu.solve
           (f64, CPU) at the shipped scale (8 keyframes, 512 landmarks,
           tests/test_ba.py::make_problem(20, ...) on the port's Lie
           helpers, priors off): cost within 1 %, camera centres within
           5 mm after the gauge alignment, rotations within 0.05 deg
           (tests/test_ba_oracle.py's bounds);
  sweep    evaluation/parity_sweep.main in-process at the matrix's full
           width, 640x480, one seed, 120 frames, both tracking modes, the
           oracle run fresh, into build/sweep_cuda/: the anchored cell's
           mean ATE at most the oracle's (the reference's claim for its
           anchored cells), the frame-to-frame cell printed, not gated;
           both cells with the keys of the reference's
           parity_sweep/cell_f120_640x480_anchored.json plus device and
           power_limit; B1, D1 and B2 once a frame of each run (2 x 120).
The kernels' launch counters are reset just before main, place_batch,
fleet_small, fleet, fleet_mesh (each fleet), snapshot, tools, parity, sweep,
place_frames, dynamic_small (each condition), dynamic_frames and
train_vocab are driven and read just after; every kernel but B3 must have
launched in each.  The script checks correctness; the port's speed is
measured by benchmark/run.py, and the times printed here are of kernels
alone or of paths no benchmark cell runs (yolo at 640, fleet_mesh, tools,
train_detector).  The kernels phase also holds B1, D1 and B2 at the fleet's
shape (8 frames) and prints how many blurred pixels differ between the
card and the CPU.  Then the line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before the last
line.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch import cli, convert, kernels, native
from dynamic_visual_slam_tpu_torch.backend import ba
from dynamic_visual_slam_tpu_torch.config import (CameraConfig, MapConfig,
                                                  SLAMConfig)
from dynamic_visual_slam_tpu_torch.core import lie
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.evaluation import parity_sweep
from dynamic_visual_slam_tpu_torch.frontend import orb, ransac
from dynamic_visual_slam_tpu_torch.io import synthetic, trajectory
from dynamic_visual_slam_tpu_torch.models import convert_ultralytics, yolov8
from dynamic_visual_slam_tpu_torch.ops import descriptors, detect, fast, fields
from dynamic_visual_slam_tpu_torch.ops import image as imops
from dynamic_visual_slam_tpu_torch.parallel.mesh import (SLAMFleet, _gather,
                                                         make_mesh,
                                                         shard_batch)
from dynamic_visual_slam_tpu_torch.pipeline import runner
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
from dynamic_visual_slam_tpu_torch.place import bow, pretrain
from dynamic_visual_slam_tpu_torch.semantic import train
from dynamic_visual_slam_tpu_torch.semantic.detector import YoloDetector
from dynamic_visual_slam_tpu_torch.utils import serve

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
# B1, D1 and B2 launch once a frame (a scan step, a shard) wherever ORB
# runs; kernel pnp_ransac once a PnP call: twice a tracked frame with the
# anchor (the fleet's), once without, and once a loop or relocalization check
FRAME_KERNELS = ("fast_score", "orb_detect", "orb_desc_moments")
PNP_PER_STEP = 2
# kernels phase, pnp_ransac: the tracker's shapes (1024 slots, 192
# hypotheses, a prior, 10 refinement steps a pass) at these batches
PNP_BATCHES = (1, 8, 24)
# kernels phase, orb_detect: 720p frames a call (1 as process, 8 as the
# fleet's scan step, 24 as process_batch)
DETECT_BATCHES = (1, 8, 24)
BATCH = 24
MAIN_BATCHES = 6               # main: 144 frames, BA fires once
PLACE_BATCHES = 4              # place_batch: 96 frames, BA fires once
ON_CARD_BATCHES = {"main": 2, "place_batch": 1}  # the last ones, on the card
SYNC_EVERY = 3                 # rs720.replay's sync_every
ORBIT_FRAMES = 180             # place_frames: frames per orbit, two orbits
                               # (loop720p.py: 240)
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
DYNAMIC_FRAMES = 16            # dynamic_frames: 720p frames (cli run: 120)
FLEET_STREAMS = 8              # fleet: bench.py's _fleet_bench
FLEET_T = 24                   # fleet: scan steps a step_batch call
FLEET_SMALL_FRAMES = 14        # fleet_small: tests/test_parallel.py's
FLEET_MESH_TIMED = 1           # fleet_mesh: timed step_batch calls a fleet
FLEET_MESH_T = 12              # fleet_mesh: scan steps a 720p call (fleet: 24)
#                                (cut from 2 for the script's time limit)
# fleet_mesh at 720p, the first 3 scan steps: 1.5 x the 9.64e-5 m measured
# on an H100 (scripts/torch_mesh_split.py: the tracker's batched arithmetic
# at 4 streams a shard against 8 moves an F-RANSAC inlier at step 1)
FLEET_MESH_FIRST3_M = 1.5e-4
SNAPSHOT_CLI_FRAMES = 6        # snapshot: 720p frames a cli run
TOOLS_FRAMES = 20              # tools: cli run --trace --serve, 424x240
TOOLS_SERVE_EVERY = 5
TOOLS_HOLD_S = 2.0             # DVS_SERVE_HOLD_S while the view is fetched
THREADED_FRAMES = 12           # tools: cli run --threaded at 720p
PARITY_FRAMES = 120            # parity: 424x240, seed 0, as the cached cell
PARITY_CACHE = os.path.join(
    ROOT, "parity_sweep", "oracle_cache",
    "oracle_424x240_seed0_f480_59748861b52657b3.npz")
SWEEP_FRAMES = 120             # sweep: 640x480, one seed, both modes
SWEEP_REFERENCE_CELL = os.path.join(
    ROOT, "parity_sweep", "cell_f120_640x480_anchored.json")
# tests/test_ba_oracle.py::test_matches_f64_oracle_shipped_scale: the
# problem (tests/test_ba.py::make_problem's arguments) and its bounds
BA_SHIPPED = dict(seed=20, w=8, l=512, noise_px=0.2, drop_frac=0.15)
BA_COST_REL = 0.01
BA_CENTRE_M = 5e-3
BA_ROT_DEG = 0.05
VOCAB_SCENES = 12              # train_vocab: the reference's 12 scenes,
VOCAB_FRAMES = 8               # 8 frames each (cut from 24)
# scene_retrieval_accuracy of the JAX package's
# place/pretrain.train_pretrained_vocabulary at these settings (k 10, depth
# 3, 500 a frame, 424x240, seed 0), measured on the CPU: 11 of 12 scenes;
# the phase allows one scene less
REF_VOCAB_ACCURACY = 0.9167
TRAIN_SIZE = 256               # train_detector: the shipped weights' size
TRAIN_BATCH = 16               # the reference's default batch
TRAIN_POOL = 128               # rendered images (cut from 384)
TRAIN_STEPS = 200              # steps (cut from 1500)
TRAIN_WARMUP = 5               # steps left out of the step times
TRAIN_TIMED = 40               # timed steps
TRAIN_EVAL_IMAGES = 16         # held-out images (the reference's cli: 48)
RENDER_WORKERS = 8             # render_pool's choice on an 8-core host
# tests/test_torch_train.py's bounds on detection_loss and its gradients
# (the port against the reference on the CPU, 4 images at 128): the loss's
# relative error, and each leaf's gradient, as the norm of the difference
# over the norm; the card is held to them against the CPU at that shape
TRAIN_LOSS_REL_TOL = 7.9e-7
TRAIN_GRAD_REL_TOL = 0.0515
# the median leaf's relative gradient difference, card against CPU, at the
# timed shape (16 images at 256; the bounds above hold there too): 1.5
# times the most scripts/torch_train_determinism.py measured (NVIDIA H100
# 80GB HBM3, 700.00 W: 0.0009967 with cuDNN's default algorithms,
# 0.0010383 with the deterministic ones train_step runs)
TRAIN_GRAD_MEDIAN_TOL = 0.00156
T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps(dict(phase=phase, **kw,
                          elapsed_s=time.perf_counter() - T_START)),
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU, where phases are rehearsed)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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


def pnp_problems(k: Intrinsics, b: int, n: int, seed: int):
    """b PnP problems of n slots on the card, as the tracker hands them
    over: points 1 to 6 m ahead, their noisy pixels in a second view, a
    quarter moved far off, 40 % of the slots masked out; the true motion as
    the prior."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -1.5, 1.0], [2, 1.5, 6.0], (b, n, 3)).astype(
        np.float32)
    rv = torch.from_numpy((rng.normal(size=(b, 3)) * 0.05).astype(np.float32))
    tv = (rng.normal(size=(b, 3)) * 0.1).astype(np.float32)
    cam = np.einsum("bij,bnj->bni", lie.rodrigues(rv).numpy(), pts) \
        + tv[:, None]
    kk = np.array([[k.fx, 0, k.cx], [0, k.fy, k.cy], [0, 0, 1]])
    uv = ((cam / cam[..., 2:]) @ kk.T)[..., :2] \
        + rng.normal(size=(b, n, 2)) * 0.5
    off = rng.random((b, n)) < 0.25
    uv[off] += rng.uniform(10, 200, size=(int(off.sum()), 2))
    dev = torch.device("cuda")
    return (torch.from_numpy(pts).to(dev),
            torch.from_numpy(uv.astype(np.float32)).to(dev),
            torch.from_numpy(rng.random((b, n)) < 0.6).to(dev),
            lie.so3_exp(rv).to(dev), torch.from_numpy(tv).to(dev))


def pnp_instr(b: int, n: int, n_hyp: int, iters: int) -> dict:
    """pnp_ransac's float32 operations (an FMA one, a float64 one one) from
    its formulas: a DLT hypothesis about 26,400 (the 12 x 12 Gram, 8
    normalised squarings, 4 matrix-vector products, two 12 x 13
    Gauss-Jordan solves, the 3 x 3 SVD), 27 a point under each of the
    n_hyp + 2 hypotheses, about 116 a point a Gauss-Newton step and 27 a
    point in each of three reprojections."""
    dlt = 1728 + 8 * (1728 + 288) + 4 * 144 + 2 * 12 * 156 * 2 + 500
    per = n_hyp * dlt + (n_hyp + 2) * n * 27 + 2 * iters * n * 116 \
        + 3 * n * 27
    return {"fadd": b * per}


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
         cuda=torch.version.cuda,
         cv2_installed=importlib.util.find_spec("cv2") is not None,
         scipy_installed=importlib.util.find_spec("scipy") is not None)
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

    # --- D1: the keypoints of all B x 8 levels, at B = 1, 8 and 24 ---------
    spec = detect.detect_spec(cfg.orb)
    d1_rows, d1_err = {}, 0.0
    for b in DETECT_BATCHES:
        sc = [s[:b].contiguous() for s in got]
        got_d = detect.detect_levels(sc, spec)
        want_d = detect.detect_levels_plain(sc, spec)
        torch.cuda.synchronize()
        for key in detect.SLOT_KEYS:
            g, w = got_d[key], want_d[key]
            d1_err = max(d1_err, float((g.double() - w.double()).abs().max()))
            if not torch.equal(g, w):
                fail(f"orb_detect differs from its plain version at B = {b}: "
                     f"{key}, {int((g != w).sum())} values")
        n_px_b = sum(s.numel() for s in sc)
        # the score maps read once; 25 bytes a slot written (uv 8, response,
        # ys, xs, octave 4 each, mask 1); one comparison a pixel
        bnd, by = bound(4 * n_px_b + 25 * b * spec.n_out, {"fadd": n_px_b})
        d1_rows[b] = dict(
            max_abs_err=d1_err, keypoints=int(got_d["mask"].sum()),
            ms=cuda_ms(lambda: detect.detect_levels(sc, spec)),
            plain_ms=cuda_ms(lambda: detect.detect_levels_plain(sc, spec)),
            bound_ms=bnd, bound_by=by)

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
    # --- pnp_ransac: the tracker's PnP at B = 1, 8 and 24 ------------------
    k = Intrinsics.from_config(cfg.camera)
    rc = cfg.ransac
    n_slot, n_hyp = cfg.orb.max_keypoints, rc.pnp_iterations
    gen = torch.Generator(device=dev).manual_seed(0)
    pnp_rows = {}
    for b in PNP_BATCHES:
        xyz, uv, m, q, t = pnp_problems(k, b, n_slot, seed=b)
        smp = ransac.sample_indices(gen, n_hyp, 6, m.sum(-1))
        kw = dict(threshold=rc.pnp_threshold_px,
                  min_inliers=rc.min_pnp_matches,
                  refine_iters=rc.refine_iterations, prior_q=q, prior_t=t)
        got_p = ransac.pnp_ransac(k, xyz, uv, m, samples=smp, **kw)
        want_p = ransac.pnp_ransac_plain(k, xyz, uv, m, smp, **kw)
        torch.cuda.synchronize()
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got_p, want_p))
        if not all(torch.equal(g, w) for g, w in zip(got_p, want_p)):
            fail(f"pnp_ransac differs from its plain version at B = {b}: "
                 f"max abs {err}")
        bnd, by = bound(b * (21 * n_slot + 48 * n_hyp + 28 + n_slot + 37),
                        pnp_instr(b, n_slot, n_hyp, rc.refine_iterations))
        pnp_rows[b] = dict(
            max_abs_err=err, valid=int(got_p.valid.sum()),
            ms=cuda_ms(lambda: ransac.pnp_ransac(k, xyz, uv, m, samples=smp,
                                                 **kw)),
            plain_ms=cuda_ms(lambda: ransac.pnp_ransac_plain(
                k, xyz, uv, m, smp, **kw)),
            bound_ms=bnd, bound_by=by)
    # --- B1 and B2 at the fleet's shape: 8 frames a launch ----------------
    lv8 = [lv[:FLEET_STREAMS].contiguous() for lv in levels]
    got8 = fields.fast_score_batch(lv8)
    _, in8 = orb.detect_batch(lv8, got8, cfg.orb)
    ok8 = all(torch.equal(g, fast.corner_score(lv)) for g, lv in
              zip(got8, lv8)) and all(torch.equal(a, b) for a, b in zip(
                  descriptors.descriptors_moments(*in8),
                  descriptors.descriptors_moments_plain(*in8)))
    if not ok8:
        fail("kernels: B1 or B2 differs from its plain version at the "
             f"fleet's shape ({FLEET_STREAMS} frames)")
    fleet_shape = dict(
        frames=FLEET_STREAMS, px=sum(lv.numel() for lv in lv8),
        slots=int(in8.level.numel()),
        fast_score_ms=cuda_ms(lambda: fields.fast_score_batch(lv8)),
        orb_detect_ms=d1_rows[FLEET_STREAMS]["ms"],
        orb_desc_moments_ms=cuda_ms(
            lambda: descriptors.descriptors_moments(*in8)))
    # --- the rounded blur (torch.matmul): card against the CPU -------------
    blur_raw = blur_round = 0
    for lv in levels:
        g = imops.gaussian_blur(lv, 7, 2.0).cpu()
        c = imops.gaussian_blur(lv.cpu(), 7, 2.0)
        blur_raw += int((g != c).sum())
        blur_round += int((torch.clamp(torch.round(g), 0, 255)
                           != torch.clamp(torch.round(c), 0, 255)).sum())
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
        dict(name=detect.KERNEL, route="cuda",
             source="dynamic_visual_slam_tpu_torch/csrc/orb_detect.cu",
             replaces="none: dynamic_visual_slam_tpu/frontend/orb.py "
                      "detect_level is plain jnp",
             max_abs_err=d1_err, ms=d1_rows[BATCH]["ms"],
             plain_ms=d1_rows[BATCH]["plain_ms"],
             bound_ms=d1_rows[BATCH]["bound_ms"],
             bound_by=d1_rows[BATCH]["bound_by"], library_ms=None,
             shape=f"{BATCH} frames x {len(levels)} levels of scores, "
                   f"{spec.n_out} slots a frame"),
        dict(name=ransac.KERNEL, route="cuda",
             source="dynamic_visual_slam_tpu_torch/csrc/pnp_ransac.cu",
             replaces="none: dynamic_visual_slam_tpu/frontend/ransac.py "
                      "pnp_ransac is plain jnp",
             max_abs_err=max(r["max_abs_err"] for r in pnp_rows.values()),
             ms=pnp_rows[BATCH]["ms"], plain_ms=pnp_rows[BATCH]["plain_ms"],
             bound_ms=pnp_rows[BATCH]["bound_ms"],
             bound_by=pnp_rows[BATCH]["bound_by"], library_ms=None,
             shape=f"{BATCH} problems x {n_slot} slots, {n_hyp} hypotheses "
                   "and a prior"),
        dict(name=fast.B3_COUNTER, route="cuda",
             source="dynamic_visual_slam_tpu_torch/csrc/fast_score.cu",
             replaces="dynamic_visual_slam_tpu/ops/fast.py:111",
             max_abs_err=b3_err, ms=b3_ms, plain_ms=b3_plain,
             bound_ms=b3_bound, bound_by=b3_by, library_ms=None,
             shape="one 1280x720 frame (and 479x641, fractional)"),
    ]
    emit("kernels", kernels=rows, fast_instr=fast_instr(levels),
         fleet_shape=fleet_shape, pnp_ransac_by_batch=pnp_rows,
         orb_detect_by_batch=d1_rows,
         blur_card_vs_cpu=dict(pixels=n_px, differ=blur_raw,
                               differ_rounded=blur_round))
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


def run_batches(phase: str, slam: SLAMSystem, frames, n_batches: int):
    """Batches 0 .. n_batches-1 through process_batch, the last
    ON_CARD_BATCHES[phase] copied to the card first, then finalize; every
    frame must be emitted and BA must have fired.  Returns the launches and
    the batches' ground-truth poses."""
    kernels.reset_launch_counts()
    n_card = ON_CARD_BATCHES[phase]
    batches, gts = [], []
    for i in range(n_batches):
        gs, ds, tss, gt = batch_at(frames, i * BATCH)
        if i >= n_batches - n_card:
            gs, ds = torch.from_numpy(gs).cuda(), torch.from_numpy(ds).cuda()
        batches.append((gs, ds, tss))
        gts += gt
    returned = sum(len(slam.process_batch(*b)) for b in batches)
    slam.finalize()
    torch.cuda.synchronize()
    launches = collections.Counter(kernels.launches)
    stamps = [f.timestamp for f in slam.trajectory]
    want = list(np.concatenate([b[2] for b in batches]))
    if stamps != want:
        fail(f"{phase}: {len(stamps)} frames emitted ({returned} before "
             f"finalize), want {len(want)} in order")
    if slam.stats["ba_runs"] < 1:
        fail(f"{phase}: BA never fired")
    return launches, gts


def phase_main(frames, cfg: SLAMConfig):
    """MAIN_BATCHES batches of 24 at sync_every 3; BA must fire among them
    and lower or keep its cost, every kernel must launch."""
    slam = SLAMSystem(cfg, enable_place_recognition=False,
                      sync_every=SYNC_EVERY, device="cuda")
    launches, gts = run_batches("main", slam, frames, MAIN_BATCHES)

    _, _, est = slam.frontend_trajectory()
    gt = np.stack(gts)
    if est.shape != gt.shape or not np.isfinite(est).all():
        fail(f"main: trajectory shape {est.shape} / finite "
             f"{np.isfinite(est).all()}")
    ate = trajectory.ate_rmse(est, gt)
    lms = slam.landmarks_world()
    emit("main", frames=MAIN_BATCHES * BATCH, sync_every=SYNC_EVERY,
         on_card_batches=ON_CARD_BATCHES["main"],
         ba_runs=slam.stats["ba_runs"],
         keyframes=slam.stats["keyframes"], landmarks=int(len(lms["xyz"])),
         ate_m=ate, tracking_ok=float(np.mean([f.tracking_ok
                                               for f in slam.trajectory])),
         launches=dict(launches), ba_log=slam.ba_log[-3:],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not all(e["final_cost"] <= e["initial_cost"] for e in slam.ba_log):
        fail(f"main: a BA round raised its cost: {slam.ba_log}")
    if not math.isfinite(ate):
        fail("main: ATE not finite")
    check_launches("main", launches)
    return launches


def phase_place_batch(frames, cfg: SLAMConfig):
    """The shipped defaults through process_batch: the shipped vocabulary,
    place recognition on, warmup_place, PLACE_BATCHES batches at
    sync_every 3."""
    slam = SLAMSystem(cfg, vocab_path=VOCAB, sync_every=SYNC_EVERY,
                      device="cuda")
    slam.warmup_place()
    launches, _ = run_batches("place_batch", slam, frames, PLACE_BATCHES)
    _, _, est = slam.frontend_trajectory()
    emit("place_batch", frames=PLACE_BATCHES * BATCH, sync_every=SYNC_EVERY,
         on_card_batches=ON_CARD_BATCHES["place_batch"],
         ba_runs=slam.stats["ba_runs"], keyframes=slam.stats["keyframes"],
         loop_checks=len(slam.loop_candidates) + len(slam.reloc_log),
         launches=dict(launches))
    if not np.isfinite(est).all():
        fail("place_batch: non-finite poses")
    check_launches("place_batch", launches)


def check_launches(phase: str, launches) -> None:
    for name in kernels.SOURCES:
        if launches.get(name, 0) < 1:
            fail(f"{phase}: kernel {name} was not launched")


def place_small_setup():
    """tests/test_reloc.py's fixture and system arguments: a wandering
    segment, 6 blank frames while the camera jumps back, then a replay of
    the segment from its 10th frame.  → (config, [(gray, depth, t_gt)],
    SLAMSystem keyword arguments)."""
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
    return cfg, frames, dict(vocab_train_keyframes=3, loop_min_gap=4,
                             loop_min_score=0.08, loop_min_inliers=20,
                             loop_correction=False)


def phase_place_small():
    """place_small_setup's run on the card: it must relocalize."""
    cfg, frames, kw = place_small_setup()
    slam = SLAMSystem(cfg, device="cuda", **kw)
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


def _render_revisit(cam: CameraConfig, first: int, poses, n_total: int,
                    drift: float):
    """Frames first .. first+len(poses)-1 of revisit_frames (a worker's
    share)."""
    scene = synthetic.SyntheticScene(cam, seed=5)
    out = []
    for i, (r, t) in enumerate(poses, start=first):
        gray, depth = scene.render(r, t)
        scale = 1.0 + drift * i / n_total
        out.append((gray.astype(np.uint8),
                    (depth * scale * 1000.0).astype(np.uint16), t))
    return out


def revisit_frames(cam: CameraConfig, n_orbit: int, drift: float = 0.35):
    """scripts/loop720p.py's fixture: the seed-5 scene, two orbits of
    loop_trajectory (radius 0.35, then 0.34), depth scaled by up to
    1 + drift over the run.  → [(gray u8, depth mm u16, t_gt)].  The host
    renders a 720p frame in about half a second, so contiguous shares of
    the frames render in worker processes (spawned; the same scene in
    each)."""
    poses = synthetic.loop_trajectory(n_orbit) + \
        synthetic.loop_trajectory(n_orbit, radius=0.34)
    n = len(poses)
    k = max(1, min(8, os.cpu_count() or 1, n))
    cuts = [n * j // k for j in range(k + 1)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(k, mp_context=ctx) as pool:
        parts = list(pool.map(
            _render_revisit, [cam] * k, cuts[:-1],
            [poses[a:b] for a, b in zip(cuts, cuts[1:])], [n] * k,
            [drift] * k))
    return [f for part in parts for f in part]


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


def run_dynamic_small(device, n_frames: int = DYNAMIC_SMALL_FRAMES):
    """semantic/train.in_loop_eval on the port, one call a condition
    (culling off, ground-truth boxes, the learned detector: the shipped
    weights at their 256), the launch counters reset just before each call
    and read just after → {condition: in_loop_eval's report, with the
    call's ``launches`` and ``call_s`` (the call's seconds, its 180 frames'
    rendering included)}."""
    params = convert.load_params(YOLO_WEIGHTS)
    results = {}
    for cond in ("off", "gt", "learned"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = train.in_loop_eval(params, n_frames=n_frames,
                                 conditions=(cond,), verbose=False,
                                 device=device)[cond]
        sync(device)
        results[cond] = dict(res, launches=dict(kernels.launches),
                             call_s=time.perf_counter() - t0)
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
    run = {}
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv, out=run)
    launches = dict(kernels.launches)
    if rc != 0:
        fail(f"dynamic_frames: cli run returned {rc}")
    slam, gt = run["system"], run["gt_positions"]
    stamps, _, est_t = slam.frontend_trajectory()
    if len(stamps) != len(gt):
        fail(f"dynamic_frames: {len(stamps)} frames for {len(gt)} stamps")
    gt_t = np.stack([gt[k] for k in sorted(gt)])
    lms = slam.landmarks_world()
    walkers, anywhere = train.walker_landmarks(
        est_t, gt_t, lms["xyz"], lms["n_obs"],
        synthetic.default_walkers(n_frames), n_frames / 30.0)
    return dict(argv=argv, launches=launches,
                walker_landmarks_confirmed=walkers,
                walker_landmarks_any=anywhere,
                person_landmarks=int(np.sum(lms["category"] == 1)),
                stats=run["stats"])


def phase_dynamic_frames():
    res = run_dynamic_frames("cuda")
    st = res["stats"]
    emit("dynamic_frames", frames=DYNAMIC_FRAMES, ate_m=st.get("ate_rmse_m"),
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


def fake_ultralytics(shapes):
    """A torch module tree in the ultralytics YOLOv8 layout (``model.<idx>``
    Conv+BN modules, C2f m-chains, the detect head ``model.22``'s
    ``cv2``/``cv3``) with the shapes of ``shapes`` (a parameter tree, HWIO
    ``w``) and seeded random weights and BatchNorm statistics; as
    tests/test_importers.py builds it."""
    nn = torch.nn
    g = torch.Generator().manual_seed(0)

    def conv_bn(leaf):
        kh, kw, cin, cout = leaf["w"].shape
        m = nn.Module()
        m.conv = nn.Conv2d(cin, cout, (kh, kw), bias=False)
        m.bn = nn.BatchNorm2d(cout, eps=1e-3)
        with torch.no_grad():
            m.conv.weight.copy_(torch.randn(m.conv.weight.shape,
                                            generator=g) * 0.2)
            m.bn.weight.copy_(torch.rand(cout, generator=g) + 0.5)
            m.bn.bias.copy_(torch.randn(cout, generator=g) * 0.1)
            m.bn.running_mean.copy_(torch.randn(cout, generator=g) * 0.1)
            m.bn.running_var.copy_(torch.rand(cout, generator=g) + 0.5)
        return m

    def plain_conv(leaf):
        kh, kw, cin, cout = leaf["w"].shape
        c = nn.Conv2d(cin, cout, (kh, kw), bias=True)
        with torch.no_grad():
            c.weight.copy_(torch.randn(c.weight.shape, generator=g) * 0.2)
            c.bias.copy_(torch.randn(cout, generator=g) * 0.1)
        return c

    def pair(node):
        m = nn.Module()
        m.cv1 = conv_bn(node["cv1"])
        m.cv2 = conv_bn(node["cv2"])
        return m

    def c2f(node):
        m = pair(node)
        m.m = nn.Sequential(*[pair(b) for b in node["m"]])
        return m

    inner = nn.Module()
    for idx, name in convert_ultralytics._BACKBONE:
        node = shapes[name]
        if name.startswith(("c2f", "up_c2f", "down_c2f")):
            inner.add_module(idx, c2f(node))
        elif name == "sppf":
            inner.add_module(idx, pair(node))
        else:
            inner.add_module(idx, conv_bn(node))
    det = nn.Module()
    det.cv2 = nn.ModuleList(nn.Sequential(
        conv_bn(h["box1"]), conv_bn(h["box2"]), plain_conv(h["box3"]))
        for h in shapes["heads"])
    det.cv3 = nn.ModuleList(nn.Sequential(
        conv_bn(h["cls1"]), conv_bn(h["cls2"]), plain_conv(h["cls3"]))
        for h in shapes["heads"])
    inner.add_module("22", det)
    root = nn.Module()
    root.add_module("model", inner)
    return root


def write_orbvoc(path: str, k: int = 2, depth: int = 3) -> None:
    """tests/test_importers.py's tiny DBoW2 text vocabulary: k 2, L 3, one
    shallow leaf (node 2, a leaf at level 0)."""
    nodes = [(0, 0, 0x00, 0.0), (0, 1, 0xFF, 0.7), (1, 0, 0x0F, 0.0),
             (1, 0, 0xF0, 0.0), (3, 1, 0x0F, 0.5), (3, 1, 0x1F, 0.4),
             (4, 1, 0xF0, 0.3), (4, 1, 0xF8, 0.2)]
    lines = [f"{k} {depth} 0 0"]
    for parent, leaf, byte, w in nodes:
        lines.append(f"{parent} {leaf} " + " ".join([str(byte)] * 32)
                     + f" {w}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def tree_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def phase_importers(device="cuda"):
    """The asset importers: an ultralytics-layout .pt with seeded random
    weights and BatchNorm statistics (its shapes from yolov8.init_params)
    through YoloDetector(weights_path=...pt) against
    YoloDetector(params=convert(...)) on three 720p walker frames (equal
    detections); save_params → load_params bit for bit; the ORBvoc text
    fixture through load_orbvoc_text, descend of 4,096 seeded random
    descriptors on the device equal to the CPU's."""
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", f"importers_{device}")
    os.makedirs(out_dir, exist_ok=True)
    pt = os.path.join(out_dir, "fake_yolov8n.pt")
    torch.save({"model": fake_ultralytics(yolov8.init_params(
        torch.Generator().manual_seed(0)))}, pt)
    params = convert_ultralytics.convert(pt)
    cfg = SLAMConfig()
    from_pt = YoloDetector(cfg, weights_path=pt, device=device)
    from_tree = YoloDetector(cfg, params=params, device=device)
    n_det, n_differ = 0, 0
    for g, *_ in synthetic.generate_dynamic_sequence(cfg.camera, 3, seed=0):
        rgb = np.stack([g] * 3, -1).astype(np.uint8)
        a, b = from_pt(rgb), from_tree(rgb)
        n_differ += not all(torch.equal(x, y) for x, y in zip(a, b))
        n_det += int(a.mask.sum())
    npz = os.path.join(out_dir, "params.npz")
    convert_ultralytics.save_params(params, npz)
    back = dict(tree_leaves(convert_ultralytics.load_params(npz)))
    leaves = dict(tree_leaves(params))
    round_trip = back.keys() == leaves.keys() and all(
        np.array_equal(np.asarray(leaves[k], np.float32),
                       np.asarray(back[k], np.float32)) for k in leaves)
    voc_path = os.path.join(out_dir, "ORBvoc_tiny.txt")
    write_orbvoc(voc_path)
    desc = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, (4096, 256), dtype=np.uint8))
    words = bow.descend(bow.load_orbvoc_text(voc_path, device),
                        desc.to(device)).cpu()
    want = bow.descend(bow.load_orbvoc_text(voc_path, "cpu"), desc)
    sync(device)
    emit("importers", seconds=time.perf_counter() - t0, frames=3,
         input_size=from_pt.size, detections=n_det, frames_differing=n_differ,
         leaves=len(leaves), round_trip=round_trip,
         descend_equal=bool(torch.equal(words, want)),
         words_hit=int(torch.unique(want).numel()))
    if n_differ or not round_trip or not torch.equal(words, want):
        fail(f"importers: {n_differ} frames differ between the .pt and the "
             f"converted tree, save/load round trip {round_trip}, descend "
             f"equal {torch.equal(words, want)}")


def phase_train_vocab(device="cuda"):
    """place/pretrain.train_pretrained_vocabulary at the reference's width
    (k 10, depth 3, 500 descriptors a frame, 424x240, 12 scenes) with 8
    frames a scene (cut from 24): one B1 and one B2 launch a frame; the
    self-check's retrieval accuracy at least the reference's at the same
    settings less one scene."""
    out = os.path.join(ROOT, "build", f"train_vocab_{device}", "orbvoc.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    n_frames = VOCAB_SCENES * VOCAB_FRAMES
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = pretrain.train_pretrained_vocabulary(
        out, k=10, depth=3, n_scenes=VOCAB_SCENES,
        frames_per_scene=VOCAB_FRAMES, per_frame=500, seed=0, verbose=False,
        device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    floor = REF_VOCAB_ACCURACY - 1.0 / VOCAB_SCENES
    emit("train_vocab", cut=dict(scenes=VOCAB_SCENES,
                                 frames_per_scene=[VOCAB_FRAMES, 24]),
         frames=n_frames, seconds=seconds, launches=launches,
         reference_accuracy=REF_VOCAB_ACCURACY, **report)
    if report["scene_retrieval_accuracy"] < floor - 1e-9:
        fail(f"train_vocab: retrieval accuracy "
             f"{report['scene_retrieval_accuracy']} below {floor:.4f} (the "
             f"reference's {REF_VOCAB_ACCURACY} less one scene)")
    if device == "cuda" and (any(launches.get(name, 0) != n_frames
                                 for name in FRAME_KERNELS)
                             or launches.get(ransac.KERNEL, 0)):
        fail(f"train_vocab: launches {launches} for {n_frames} frames")
    return launches


def grads_against_cpu(init, batch, size, device):
    """detection_loss and backward on ``batch`` (imgs, boxes, mask) at
    ``size`` from ``init``, on ``device`` and on the CPU, the convolutions
    deterministic as in train_step → (losses, the
    loss's relative difference, each leaf's relative difference: norm of
    the difference over the norm)."""
    loss, grads = {}, {}
    for dev in (device, "cpu"):
        model = train.trainable_model(init, dev)
        with train.deterministic_convolutions():      # as train_step
            lv, _ = train.detection_loss(model, *(t.to(dev) for t in batch),
                                         size)
            lv.backward()
        loss[dev] = float(lv.detach())
        grads[dev] = {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()}
    rel = {n: float((grads[device][n] - g).norm() / max(float(g.norm()),
                                                       1e-30))
           for n, g in grads["cpu"].items()}
    return loss, abs(loss[device] - loss["cpu"]) / abs(loss["cpu"]), rel


def phase_train_detector(device="cuda"):
    """semantic/train.train of YOLOv8n at full width, the shipped weights'
    input size 256, batch 16, from a fixed initialisation
    (yolov8.init_params of seed 0), on a pool of TRAIN_POOL rendered images
    for TRAIN_STEPS steps (cut from 384 and 1500), timed as a whole; first
    and last loss, peak memory; evaluate on 16 held-out images (pool seed
    991, as cli train-detector's) against the initialisation.  Before it,
    on the held-out images: launches and busy share of one profiled
    train_step, then ms a step (median and p90 of TRAIN_TIMED steps after
    TRAIN_WARMUP, each synchronised, batches gathered by index as train
    does) and images/s; the held-out pool rendered in RENDER_WORKERS
    processes (render_scenes) must equal render_pool's serial render.
    detection_loss and its gradients on the card against the CPU on
    tests/test_torch_train.py's batch (4 images at 128, pool seed 1; the
    test's bounds on the loss and the worst leaf) and on the 16 held-out
    images at 256 (the timed shape; the same bounds, and one on the median
    leaf)."""
    t0 = time.perf_counter()
    parts = {}
    init = yolov8.init_params(torch.Generator().manual_seed(0))
    held_out = train.render_pool(TRAIN_EVAL_IMAGES, TRAIN_SIZE, seed=991)
    in_workers = train.render_scenes(
        train.POOL_CAMERA, TRAIN_SIZE,
        train.pool_plan(TRAIN_EVAL_IMAGES, 991), RENDER_WORKERS)
    pool_equal = len(in_workers) == TRAIN_EVAL_IMAGES and all(
        np.array_equal(img, held_out[0][i])
        and np.array_equal(bb[:train.MAX_GT], held_out[1][i][:len(bb)])
        and int(held_out[2][i].sum()) == min(len(bb), train.MAX_GT)
        for i, (img, bb) in enumerate(in_workers))
    if not pool_equal:
        fail("train_detector: the pool rendered in workers differs from "
             "the serial render")
    parts["render_held_out_s"] = time.perf_counter() - t0
    # card against CPU: one detection_loss + backward, same params
    small = [torch.from_numpy(a) for a in train.render_pool(4, 128, seed=1)]
    loss, loss_rel, rel = grads_against_cpu(init, small, 128, device)
    grad_rel = max(rel.values())
    held = [torch.from_numpy(a) for a in held_out]
    loss_256, loss_rel_256, rel_256 = grads_against_cpu(init, held,
                                                        TRAIN_SIZE, device)
    worst_256 = max(rel_256, key=rel_256.get)
    median_256 = statistics.median(rel_256.values())
    parts["card_vs_cpu_s"] = time.perf_counter() - t0 - sum(parts.values())
    # one profiled step, then the timed steps, on the held-out images
    model = train.trainable_model(init, device)
    opt = train.OptaxAdamW(model.parameters(), 1e-3, TRAIN_STEPS)
    pool = [t.to(device) for t in held]
    rng = np.random.default_rng(1)

    def step():
        idx = torch.from_numpy(rng.integers(0, TRAIN_EVAL_IMAGES,
                                            TRAIN_BATCH)).to(device)
        train.train_step(model, opt, *(t[idx] for t in pool), TRAIN_SIZE)
    for _ in range(2):
        step()
    sync(device)
    step_launches, step_dev_ms, step_wall_ms = profile_launches(step, device)
    times = []
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        t1 = time.perf_counter()
        step()
        sync(device)
        times.append((time.perf_counter() - t1) * 1e3)
    steady = np.asarray(times[TRAIN_WARMUP:])
    ms = float(np.median(steady))
    del model, opt, pool
    parts["profiled_and_timed_steps_s"] = time.perf_counter() - t0 \
        - sum(parts.values())
    # the run
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_train = time.perf_counter()
    params, history = train.train(
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, input_size=TRAIN_SIZE,
        pool_images=TRAIN_POOL, lr=1e-3, seed=0, params=init,
        log_every=TRAIN_STEPS // 10, verbose=False, device=device)
    train_s = time.perf_counter() - t_train
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" \
        else None
    parts["train_s"] = train_s
    trained = train.evaluate_pool(params, *held_out, device=device)
    base = train.evaluate_pool(init, *held_out, device=device)
    parts["evaluate_s"] = time.perf_counter() - t0 - sum(parts.values())
    emit("train_detector",
         cut=dict(pool=[TRAIN_POOL, 384], steps=[TRAIN_STEPS, 1500]),
         input_size=TRAIN_SIZE, batch=TRAIN_BATCH, train_s=train_s,
         ms_per_step=ms, ms_per_step_p90=float(np.percentile(steady, 90)),
         timed_steps=TRAIN_TIMED, images_per_s=TRAIN_BATCH * 1e3 / ms,
         peak_mem_gb=peak,
         profiled_step=dict(launches=step_launches, device_ms=step_dev_ms,
                            wall_ms=step_wall_ms,
                            busy_share=step_dev_ms / step_wall_ms),
         loss_first=history[0], loss_last=history[-1], history=history,
         evaluate=trained, evaluate_init=base,
         card_vs_cpu=dict(loss=loss, loss_rel=loss_rel, grad_rel=grad_rel,
                          bounds=[TRAIN_LOSS_REL_TOL, TRAIN_GRAD_REL_TOL]),
         card_vs_cpu_256=dict(loss=loss_256, loss_rel=loss_rel_256,
                              worst_leaf=worst_256,
                              worst=rel_256[worst_256], median=median_256,
                              median_bound=TRAIN_GRAD_MEDIAN_TOL),
         pool_workers_equal=pool_equal, parts=parts,
         seconds=time.perf_counter() - t0)
    if not history[-1] < history[0]:
        fail(f"train_detector: loss {history[0]} → {history[-1]} did not "
             "fall")
    if not trained["mean_best_iou"] >= base["mean_best_iou"] + 0.05:
        fail(f"train_detector: mean best IoU {trained['mean_best_iou']} "
             f"against {base['mean_best_iou']} at initialisation (needs "
             "+0.05)")
    if loss_rel > TRAIN_LOSS_REL_TOL or grad_rel > TRAIN_GRAD_REL_TOL:
        fail(f"train_detector: the card's loss differs from the CPU's by "
             f"{loss_rel:.3g} and a gradient by {grad_rel:.3g} (bounds "
             f"{TRAIN_LOSS_REL_TOL}, {TRAIN_GRAD_REL_TOL})")
    if loss_rel_256 > TRAIN_LOSS_REL_TOL or rel_256[worst_256] > \
            TRAIN_GRAD_REL_TOL or median_256 > TRAIN_GRAD_MEDIAN_TOL:
        fail(f"train_detector: at {TRAIN_BATCH} images of {TRAIN_SIZE} the "
             f"card's loss differs from the CPU's by {loss_rel_256:.3g}, "
             f"the worst leaf's gradient by {rel_256[worst_256]:.3g} and "
             f"the median leaf's by {median_256:.3g} (bounds "
             f"{TRAIN_LOSS_REL_TOL}, {TRAIN_GRAD_REL_TOL}, "
             f"{TRAIN_GRAD_MEDIAN_TOL})")


def fleet_config() -> SLAMConfig:
    """tests/test_parallel.py's fleet fixture: 160x120, a small map."""
    cam = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                       cx=79.5, cy=59.5)
    return SLAMConfig().replace(
        camera=cam, map=MapConfig(max_landmarks=256, max_keyframes=8,
                                  max_obs_per_landmark=4,
                                  max_obs_per_keyframe=128))


STAGES = ("fm", "pnp", "anchor")


def keyed_draws(device):
    """(fleet sampler, solo sampler of stream 0): the minimal sets of
    (stream, frame, stage) drawn from a generator seeded with that key, so
    a fleet's stream and a solo system on its frames draw the same sets.
    One generator a draw: the shards of a mesh call it from a thread
    each."""
    def draw(stream, frame, stage, n_hyp, size, count):
        gen = torch.Generator(device=count.device)
        gen.manual_seed((stream * 1_000_003 + frame) * len(STAGES)
                        + STAGES.index(stage))
        return ransac.sample_indices(gen, n_hyp, size, count)

    def fleet(stage, streams, frame_ids, n_hyp, size, count):
        return torch.cat([draw(s, f, stage, n_hyp, size, count[i:i + 1])
                          for i, (s, f) in enumerate(zip(
                              streams.tolist(), frame_ids.tolist()))])

    def solo(stage, frame_ids, n_hyp, size, count):
        return draw(0, int(frame_ids[0]), stage, n_hyp, size, count)
    return fleet, solo


def phase_fleet_small(device="cuda"):
    """tests/test_parallel.py's fleet checks on the card: 2 streams (seeds
    3 and 7) at 160x120; stream 0 against a solo SLAMSystem.process run on
    its frames with the same draws (place recognition off), with that
    test's bounds; then step_batch against T step() calls."""
    cfg = fleet_config()
    n = FLEET_SMALL_FRAMES
    grays, depths, stamps = fleet_small_frames(n)
    fleet_draws, solo_draws = keyed_draws(device)
    fleet = SLAMFleet(cfg, 2, device=device, sampler=fleet_draws)
    solo = SLAMSystem(cfg, enable_place_recognition=False, device=device,
                      sampler=solo_draws)
    kernels.reset_launch_counts()
    rows = []
    for i in range(n):
        out = fleet.step(grays[i], depths[i], stamps[i], auto_ba=False)
        rows.append((out.t_wc[0].cpu().numpy(), out.q_wc[0].cpu().numpy()))
        solo.process(grays[i, 0], depths[i, 0], float(stamps[i, 0]))
    solo.finalize()
    sync(device)
    launches = dict(kernels.launches)
    t_f = np.stack([r[0] for r in rows])
    t_s = np.stack([f.t_wc for f in solo.trajectory])
    err = np.linalg.norm(t_f - t_s, axis=1)
    dots = np.abs(np.sum(np.stack([r[1] for r in rows])
                         * np.stack([f.q_wc for f in solo.trajectory]), 1))
    ang = float(np.degrees(2 * np.arccos(np.clip(dots, -1, 1))).max())
    st = fleet.stats()
    lm_solo = int(solo.map_state.landmarks.active.sum())
    # step_batch against T step() calls (default draws, the same order)
    f1 = SLAMFleet(cfg, 2, kf_slots=n, device=device)
    telems = f1.step_batch(grays, depths, stamps, auto_ba=False).cpu().numpy()
    f2 = SLAMFleet(cfg, 2, device=device)
    outs = [f2.step(grays[i], depths[i], stamps[i], auto_ba=False)
            for i in range(n)]
    t_step = np.stack([o.t_wc.cpu().numpy() for o in outs])
    kf_step = np.stack([o.is_keyframe.cpu().numpy() for o in outs])
    batch_err = float(np.linalg.norm(t_step - telems[..., 4:7], axis=-1).max())
    dropped = f1.stats()["keyframes_dropped"]
    emit("fleet_small", frames=n, streams=2, pos_err_m=err.tolist(),
         rot_err_deg=ang, keyframes_fleet=st["keyframes"][0],
         keyframes_solo=solo.stats["keyframes"],
         landmarks_fleet=st["landmarks_active"][0], landmarks_solo=lm_solo,
         step_batch_err_m=batch_err, step_batch_dropped=dropped,
         launches=launches)
    checks = [
        (err[:3].max() < 1e-5, f"first 3 frames {err[:3].max()} m >= 1e-5"),
        (err.max() < 2e-2, f"positions {err.max()} m >= 0.02"),
        (ang < 0.5, f"rotations {ang} deg >= 0.5"),
        (abs(st["keyframes"][0] - solo.stats["keyframes"]) <= 1,
         f"keyframes {st['keyframes'][0]} vs {solo.stats['keyframes']}"),
        (abs(st["landmarks_active"][0] - lm_solo) <= max(20, lm_solo // 10),
         f"landmarks {st['landmarks_active'][0]} vs {lm_solo}"),
        (batch_err < 1e-6, f"step_batch vs step {batch_err} m >= 1e-6"),
        (np.array_equal(kf_step, telems[..., 8] > 0.5),
         "step_batch keyframe flags differ from step's"),
        (dropped == [0, 0], f"step_batch dropped {dropped}"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        fail("fleet_small: " + "; ".join(bad))
    check_launches("fleet_small", launches)


def fleet_batch(frames, i0: int, streams: int, device="cuda",
                steps: int = FLEET_T):
    """bench.py's _fleet_bench input: ``steps`` scan steps of ``streams``
    720p streams, stream s offset by s frames in the 6-frame cycle, on the
    card; stamps (i0 + t) / 30."""
    idx = [[(i0 + t + s) % len(frames) for s in range(streams)]
           for t in range(steps)]
    gs = torch.from_numpy(np.stack([[frames[j][0] for j in r] for r in idx]))
    ds = torch.from_numpy(np.stack([[frames[j][1] for j in r] for r in idx]))
    ts = np.repeat(((i0 + np.arange(steps)) / 30.0)[:, None], streams, 1)
    return gs.to(device), ds.to(device), ts


def profile_launches(fn, device="cuda"):
    """(kernel launches, device ms, wall ms) of fn() under torch.profiler,
    ended by sync(device)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    launches, device_us = 0, 0.0
    for ev in prof.key_averages():
        if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += ev.count
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev = getattr(ev, "self_device_time_total", None)
            device_us += ev.self_cuda_time_total if dev is None else dev
    return launches, device_us / 1e3, wall


def fleet_mesh_size(streams: int) -> int:
    """bench.py's min(streams, device count), down to a count that divides
    the streams."""
    n = min(streams, torch.cuda.device_count())
    return max(d for d in range(1, n + 1) if streams % d == 0)


def phase_fleet(frames, cfg: SLAMConfig, device="cuda"):
    """bench.py's _fleet_bench set-up on the port: 8 streams at 720p over
    make_mesh(min(8, cards)) as bench.py's, one step_batch call of 24 scan
    steps (its launches counted) and one run_ba.  Then launches a scan
    step under torch.profiler at B = 8 and at B = 1 (stream 0's
    frames)."""
    b = FLEET_STREAMS
    mesh = make_mesh(fleet_mesh_size(b)) if device == "cuda" \
        else make_mesh(devices=[device])
    fleet = SLAMFleet(cfg, b, mesh)
    shards = mesh.size
    kernels.reset_launch_counts()
    telems = fleet.step_batch(*fleet_batch(frames, 0, b, device))
    sync(device)
    launches = dict(kernels.launches)
    fleet.run_ba(float(FLEET_T - 1) / 30.0)
    st = fleet.stats()
    finite = bool(torch.isfinite(telems).all()) and all(
        np.isfinite(st.get("last_ba_costs", [0.0])))
    # launches a scan step (one step(): extraction, tracker and masked
    # insert for every stream), B = 8 against B = 1 on stream 0's frame, in
    # this run; a step, not a whole step_batch call, keeps the profiler's
    # bookkeeping to some 12,000 launches
    gs, ds, ts = fleet_batch(frames, FLEET_T, b, device)
    n8 = profile_launches(
        lambda: fleet.step(gs[0], ds[0], ts[0], auto_ba=False), device)[0]
    solo = SLAMFleet(cfg, 1, device=device)
    solo.step_batch(*fleet_batch(frames, 0, 1, device), auto_ba=False)
    n1 = profile_launches(
        lambda: solo.step(gs[0, :1], ds[0, :1], ts[0, :1], auto_ba=False),
        device)[0]
    emit("fleet", streams=b, shards=shards,
         mesh=[str(d) for d in mesh.devices], scan_steps=FLEET_T,
         ba_runs=fleet.ba_runs, keyframes=st["keyframes"],
         landmarks=st["landmarks_active"],
         keyframes_dropped=st["keyframes_dropped"],
         last_ba_costs=st.get("last_ba_costs"), launches=launches,
         launches_per_scan_step={f"B{b}": n8, "B1": n1},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
         if device == "cuda" else None)
    if not finite:
        fail("fleet: a pose or BA cost is not finite")
    for name in kernels.SOURCES:
        per = PNP_PER_STEP if name == ransac.KERNEL else 1
        if launches.get(name, 0) != per * shards * FLEET_T:
            fail(f"fleet: kernel {name} launched {launches.get(name, 0)} "
                 f"times for {shards} shards x {FLEET_T} scan steps")
    if fleet.ba_runs < 1:
        fail("fleet: no BA round ran")
    if not n8 < 2 * shards * n1:
        fail(f"fleet: {n8} launches a scan step at B = {b} over {shards} "
             f"shards, {n1} at B = 1 (must stay below twice a shard's)")
    return launches


def fleet_small_frames(n: int):
    """fleet_config()'s 2 streams, sequence seeds 3 and 7, n frames: grays,
    depths (N, 2, H, W), stamps (N, 2)."""
    cam = fleet_config().camera
    seqs = [list(synthetic.generate_sequence(cam, n, seed=s))
            for s in (3, 7)]
    grays = np.stack([[q[i][0] for q in seqs] for i in range(n)]
                     ).astype(np.uint8)
    depths = np.stack([[q[i][1] for q in seqs] for i in range(n)]
                      ).astype(np.float32)
    stamps = np.asarray([[q[i][4] for q in seqs] for i in range(n)],
                        np.float32)
    return grays, depths, stamps


def two_shard_mesh(device="cuda"):
    """The machine's first two cards when it has them, else its one card
    listed twice (two shards, a thread each, on one card)."""
    if device != "cuda":
        return make_mesh(devices=[device] * 2)
    if torch.cuda.device_count() >= 2:
        return make_mesh(2)
    return make_mesh(devices=["cuda:0"] * 2)


def gather_cost(out, mesh, reps: int = 50):
    """(host ms, leaves) of the mesh fleet's output gather: a step's
    TrackOutput split over ``mesh`` by shard_batch, concatenated on
    devices[0] as step does (mean of ``reps``, each synchronised)."""
    parts = shard_batch(out, mesh)
    leaves = sum(torch.is_tensor(x)
                 for x in torch.utils._pytree.tree_leaves(out))
    _gather(parts, mesh.devices[0])
    sync(mesh.devices[0])
    t0 = time.perf_counter()
    for _ in range(reps):
        _gather(parts, mesh.devices[0])
        sync(mesh.devices[0])
    return (time.perf_counter() - t0) * 1e3 / reps, leaves


def phase_fleet_mesh(frames, cfg: SLAMConfig, device="cuda"):
    """The fleet split over a two-shard mesh against the one-device fleet,
    both on keyed_draws: (a) fleet_small's 2 streams at 160x120, 14
    frames, through step and then step_batch: positions within 1e-6 m,
    keyframe flags equal; (b) SLAMConfig() at 720p, 8 streams as
    fleet_batch, step_batch calls of FLEET_MESH_T scan steps, one warm-up call
    and FLEET_MESH_TIMED timed ones (host clock, synchronised) a fleet,
    then run_ba: per stream, positions within tests/test_parallel.py's
    bounds (all 2 cm, 0.5 deg; its first 3 frames' 1e-5 m becomes
    FLEET_MESH_FIRST3_M on the card, where the split changes the tracker's
    batched arithmetic), keyframes within 1,
    BA costs finite; the mesh fleet's B1, D1 and B2 each once a shard a scan
    step; aggregate fps of both fleets and the peak memory."""
    mesh = two_shard_mesh(device)
    shards = mesh.size
    fleet_draws, _ = keyed_draws(device)
    # (a) small, step then step_batch
    cfg_s = fleet_config()
    n = FLEET_SMALL_FRAMES
    grays, depths, stamps = fleet_small_frames(n)
    small = {}
    for name, kw in (("one", dict(device=device)), ("mesh", dict(mesh=mesh))):
        f = SLAMFleet(cfg_s, 2, sampler=fleet_draws, **kw)
        outs = [f.step(grays[i], depths[i], stamps[i], auto_ba=False)
                for i in range(n)]
        fb = SLAMFleet(cfg_s, 2, kf_slots=n, sampler=fleet_draws, **kw)
        if name == "one":
            gather_ms, gather_leaves = gather_cost(outs[-1], mesh)
        small[name] = (
            np.stack([o.t_wc.cpu().numpy() for o in outs]),
            np.stack([o.is_keyframe.cpu().numpy() for o in outs]),
            fb.step_batch(grays, depths, stamps, auto_ba=False).cpu().numpy())
    (t1, k1, tb1), (t2, k2, tb2) = small["one"], small["mesh"]
    small_step_err = float(np.linalg.norm(t2 - t1, axis=-1).max())
    small_batch_err = float(np.linalg.norm(tb2[..., 4:7] - tb1[..., 4:7],
                                           axis=-1).max())
    small_flags = bool(np.array_equal(k1, k2)) and bool(
        np.array_equal(tb1[..., 8], tb2[..., 8]))
    # (b) full width
    b = FLEET_STREAMS
    calls = [fleet_batch(frames, k * FLEET_MESH_T, b, device, FLEET_MESH_T)
             for k in range(1 + FLEET_MESH_TIMED)]
    sync(device)
    cards = sorted({d.index for d in mesh.devices}) if device == "cuda" \
        else []
    runs = {}
    for name, kw in (("one", dict(device=device)), ("mesh", dict(mesh=mesh))):
        fleet = telems = None     # the first fleet's memory, freed
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        fleet = SLAMFleet(cfg, b, sampler=fleet_draws, **kw)
        kernels.reset_launch_counts()
        telems, per_call = [], []
        for k, (gs, ds, ts) in enumerate(calls):
            t0 = time.perf_counter()
            telems.append(fleet.step_batch(gs, ds, ts, auto_ba=False))
            sync(device)
            per_call.append(time.perf_counter() - t0)
        launches = dict(kernels.launches)
        costs = fleet.run_ba(float(len(calls) * FLEET_MESH_T - 1) / 30.0)
        st = fleet.stats()
        runs[name] = dict(
            telems=torch.cat(telems).cpu().numpy(), launches=launches,
            fps=FLEET_MESH_TIMED * FLEET_MESH_T * b / sum(per_call[1:]),
            ms_per_call=[x * 1e3 for x in per_call],
            costs=costs.cpu().numpy(), keyframes=st["keyframes"],
            peak_mem_gb=[torch.cuda.max_memory_allocated(c) / 1e9
                         for c in cards])
    one, two = runs["one"], runs["mesh"]
    err = np.linalg.norm(two["telems"][..., 4:7] - one["telems"][..., 4:7],
                         axis=-1)                         # (T, B)
    dots = np.abs(np.sum(two["telems"][..., 0:4] * one["telems"][..., 0:4],
                         -1))
    ang = float(np.degrees(2 * np.arccos(np.clip(dots, -1, 1))).max())
    kf_diff = int(np.abs(np.asarray(two["keyframes"])
                         - np.asarray(one["keyframes"])).max())
    steps = len(calls) * FLEET_MESH_T
    emit("fleet_mesh", mesh=[str(d) for d in mesh.devices],
         distinct_cards=len(set(mesh.devices)),
         small=dict(frames=n, streams=2, step_err_m=small_step_err,
                    step_batch_err_m=small_batch_err,
                    flags_equal=small_flags),
         gather_step_output_ms=gather_ms, gather_leaves=gather_leaves,
         streams=b, scan_steps=steps, timed_calls=FLEET_MESH_TIMED,
         pos_err_first3_m=float(err[:3].max()), pos_err_m=float(err.max()),
         rot_err_deg=ang, keyframes_one=one["keyframes"],
         keyframes_mesh=two["keyframes"],
         ba_costs_one=one["costs"].tolist(),
         ba_costs_mesh=two["costs"].tolist(),
         aggregate_fps_one=one["fps"], aggregate_fps_mesh=two["fps"],
         ms_per_call_one=one["ms_per_call"],
         ms_per_call_mesh=two["ms_per_call"],
         launches=two["launches"], peak_mem_gb_one=one["peak_mem_gb"],
         peak_mem_gb_mesh=two["peak_mem_gb"])
    checks = [
        (small_step_err < 1e-6, f"small: step {small_step_err} m >= 1e-6"),
        (small_batch_err < 1e-6,
         f"small: step_batch {small_batch_err} m >= 1e-6"),
        (small_flags, "small: keyframe flags differ"),
        (err[:3].max() < FLEET_MESH_FIRST3_M,
         f"first 3 frames {err[:3].max()} m >= {FLEET_MESH_FIRST3_M}"),
        (err.max() < 2e-2, f"positions {err.max()} m >= 0.02"),
        (ang < 0.5, f"rotations {ang} deg >= 0.5"),
        (kf_diff <= 1, f"keyframes {two['keyframes']} vs "
         f"{one['keyframes']}"),
        (bool(np.isfinite(two["costs"]).all()
              and np.isfinite(one["costs"]).all()), "a BA cost not finite"),
    ]
    for name in kernels.SOURCES:
        got = two["launches"].get(name, 0)
        per = PNP_PER_STEP if name == ransac.KERNEL else 1
        checks.append((got == per * shards * steps,
                       f"kernel {name} launched {got} times for {shards} "
                       f"shards x {steps} scan steps"))
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        fail("fleet_mesh: " + "; ".join(bad))
    return two["launches"]


def first_divergence(ra, rb):
    """The first frame where two runs' FrameResults differ, and the first
    output that differs there, in stage order."""
    for i, (fa, fb) in enumerate(zip(ra, rb)):
        for name in ("n_features", "n_matches", "n_inliers", "tracking_ok",
                     "is_keyframe", "t_wc", "q_wc"):
            if not np.array_equal(getattr(fa, name), getattr(fb, name)):
                return dict(frame=i, output=name)
    return None


def phase_snapshot(device="cuda"):
    """place_small's fixture with place recognition on: process the first
    half, save, restore into a fresh system, continue both; then cli run
    --save-state and --resume at 720p."""
    cfg, frames, kw = place_small_setup()
    half = len(frames) // 2
    a = SLAMSystem(cfg, device=device, **kw)
    for i, (g, d, _) in enumerate(frames[:half]):
        a.process(g, d, i / 30.0)
    path = os.path.join(ROOT, "build", f"snapshot_{device}", "ckpt.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    a.save(path)
    b = SLAMSystem(cfg, device=device, **kw)
    b.restore(path)
    kernels.reset_launch_counts()
    ra, rb = [], []
    for i, (g, d, _) in enumerate(frames[half:], start=half):
        ra.append(a.process(g, d, i / 30.0))
        rb.append(b.process(g, d, i / 30.0))
    a.finalize()
    b.finalize()
    sync(device)
    launches = dict(kernels.launches)
    flags_eq = all((x.is_keyframe, x.tracking_ok) == (y.is_keyframe,
                                                      y.tracking_ok)
                   for x, y in zip(ra, rb))
    pos_err = float(max(np.abs(x.t_wc - y.t_wc).max()
                        for x, y in zip(ra, rb)))
    # cli run --save-state, then --resume, at 720p
    out_dir = os.path.dirname(path)
    argv = ["run", "--source", "synthetic", "--width", "1280", "--height",
            "720", "--frames", str(SNAPSHOT_CLI_FRAMES), "--device", device]
    ckpt = os.path.join(out_dir, "cli_state")
    first, second = {}, {}
    with contextlib.redirect_stdout(io.StringIO()):
        rc1 = cli.main(argv + ["--out-dir", os.path.join(out_dir, "a"),
                               "--save-state", ckpt], out=first)
        rc2 = cli.main(argv + ["--out-dir", os.path.join(out_dir, "b"),
                               "--resume", ckpt + ".npz"], out=second)
    emit("snapshot", frames=len(frames), saved_after=half,
         flags_equal=flags_eq, max_pos_diff_m=pos_err,
         first_divergence=first_divergence(ra, rb), stats_a=a.stats,
         stats_b=b.stats, relocalizations=a.stats["relocalizations"],
         launches=launches, cli_rc=[rc1, rc2],
         cli_frames=[first.get("stats", {}).get("frames"),
                     second.get("stats", {}).get("frames")],
         cli_keyframes=[first.get("stats", {}).get("keyframes"),
                        second.get("stats", {}).get("keyframes")])
    if not flags_eq or not pos_err <= 1e-6:
        fail(f"snapshot: resumed run differs (flags equal {flags_eq}, "
             f"positions {pos_err} m): {first_divergence(ra, rb)}")
    if (rc1, rc2) != (0, 0) or second["stats"]["frames"] != \
            2 * SNAPSHOT_CLI_FRAMES:
        fail(f"snapshot: cli --save-state / --resume returned {rc1}, {rc2}")
    check_launches("snapshot", launches)

def _run_cli(argv, out=None):
    """cli.main in-process with its stdout kept out of this script's."""
    res = {} if out is None else out
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv, out=res)
    return rc, res


def _fetch_live(views, n_frames: int, got: dict) -> None:
    """Wait for the recorded LiveView to hold ``n_frames`` frames (the
    run's last refresh; read in memory, so that no request competes with
    the timed frames), then fetch its four pages into ``got``."""
    deadline = time.monotonic() + 600
    try:
        while time.monotonic() < deadline and not (
                views and views[0]._stats.get("frames") == n_frames):
            time.sleep(0.05)
        base = f"http://127.0.0.1:{views[0].port}"
        for path in ("/", "/stats.json", "/map.json", "/frame.jpg"):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                got[path] = r.read()
    except Exception as e:  # noqa: BLE001 - reported by phase_tools
        got["error"] = repr(e)


def phase_tools(device="cuda"):
    """cli run --trace --serve 0 --serve-every 5 at 424x240 on 20 frames,
    the view held DVS_SERVE_HOLD_S after the run while a thread fetches
    its pages, against the same command without --trace and --serve, run
    before and after it (fps and the frame stage's median of all three);
    then cli run --threaded at 720p on 12 frames, which must take the
    native runtime's NativeQueue; NativeQueue.pop of one 720p frame on this
    host."""
    out_dir = os.path.join(ROOT, "build", f"tools_{device}")
    argv = ["run", "--device", device, "--source", "synthetic", "--width",
            "424", "--height", "240", "--frames", str(TOOLS_FRAMES)]
    t0 = time.perf_counter()
    rc0, plain = _run_cli(argv + ["--out-dir", os.path.join(out_dir, "a")])
    views, got = [], {}

    class Recorded(serve.LiveView):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            views.append(self)

    fetcher = threading.Thread(target=_fetch_live,
                               args=(views, TOOLS_FRAMES, got), daemon=True)
    saved = serve.LiveView, os.environ.get("DVS_SERVE_HOLD_S")
    serve.LiveView = Recorded
    os.environ["DVS_SERVE_HOLD_S"] = str(TOOLS_HOLD_S)
    kernels.reset_launch_counts()
    fetcher.start()
    try:
        rc1, tooled = _run_cli(argv + [
            "--out-dir", os.path.join(out_dir, "b"), "--trace", "--serve",
            "0", "--serve-every", str(TOOLS_SERVE_EVERY)])
    finally:
        serve.LiveView = saved[0]
        if saved[1] is None:
            os.environ.pop("DVS_SERVE_HOLD_S")
        else:
            os.environ["DVS_SERVE_HOLD_S"] = saved[1]
    sync(device)
    launches = dict(kernels.launches)
    fetcher.join(timeout=60)
    rc2, plain2 = _run_cli(argv + ["--out-dir", os.path.join(out_dir, "c")])
    seconds = time.perf_counter() - t0
    if (rc0, rc1, rc2) != (0, 0, 0):
        fail(f"tools: cli run returned {rc0}, {rc1}, {rc2}")
    events = json.load(open(os.path.join(out_dir, "b", "trace.json")))[
        "traceEvents"]
    pairs = sum(e["ph"] == "B" and e["name"] == "frame" for e in events)
    ends = sum(e["ph"] == "E" and e["name"] == "frame" for e in events)
    live_stats = json.loads(got.get("/stats.json", b"{}"))
    jpeg = got.get("/frame.jpg", b"")
    _, _, t_a = plain["system"].frontend_trajectory()
    _, _, t_b = tooled["system"].frontend_trajectory()
    pos_err = float(np.abs(t_a - t_b).max()) if t_a.shape == t_b.shape \
        else math.inf
    # the threaded runner at 720p: which queue it takes
    queues = []
    make_queue = runner._make_queue

    def recorded_queue(*a, **k):
        queues.append(make_queue(*a, **k))
        return queues[-1]

    runner._make_queue = recorded_queue
    t1 = time.perf_counter()
    try:
        rc3, threaded = _run_cli([
            "run", "--device", device, "--source", "synthetic", "--width",
            "1280", "--height", "720", "--frames", str(THREADED_FRAMES),
            "--threaded", "--out-dir", os.path.join(out_dir, "threaded")])
    finally:
        runner._make_queue = make_queue
    threaded_s = time.perf_counter() - t1
    n = 1280 * 720 * 3
    q = native.NativeQueue(depth=2, max_item=n + 64)
    payload = np.random.default_rng(0).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()
    pop_ms, slice_ms = [], []
    for _ in range(20):
        q.push(0.0, payload)
        ta = time.perf_counter()
        item = q.pop(1.0)
        pop_ms.append((time.perf_counter() - ta) * 1e3)
        ta = time.perf_counter()
        bytes(q._buf[:n])          # the reference's copy, for comparison
        slice_ms.append((time.perf_counter() - ta) * 1e3)
    pop_equal = item[1] == payload
    st = tooled["stats"]
    runs = (plain, tooled, plain2)
    emit("tools", frames=TOOLS_FRAMES, seconds=seconds, rc=[rc0, rc1, rc2],
         trace_begin=pairs, trace_end=ends, live_error=got.get("error"),
         live_frames=live_stats.get("frames"), live_page_bytes={
             k: len(v) for k, v in got.items() if k != "error"},
         jpeg_soi=jpeg[:3] == b"\xff\xd8\xff", launches=launches,
         keyframes=[plain["stats"]["keyframes"], st["keyframes"]],
         max_pos_diff_m=pos_err,
         fps_plain_tools_plain=[r["stats"]["fps"] for r in runs],
         frame_median_ms_plain_tools_plain=[
             r["stats"]["stages"]["frame"]["median_ms"] for r in runs],
         native_available=native.available(),
         threaded_queues=[type(x).__name__ for x in queues],
         threaded_rc=rc3, threaded_seconds=threaded_s,
         frames_processed=threaded.get("stats", {}).get("frames"),
         queue_dropped=threaded.get("stats", {}).get("queue_dropped"),
         frames_in=threaded.get("stats", {}).get("frames_in"),
         pop_720p_ms=statistics.median(pop_ms),
         slice_copy_720p_ms=statistics.median(slice_ms),
         pop_bytes_equal=pop_equal)
    if pairs != TOOLS_FRAMES or ends != TOOLS_FRAMES:
        fail(f"tools: trace.json holds {pairs} / {ends} frame begin / end "
             f"events for {TOOLS_FRAMES} frames")
    if live_stats.get("frames") != TOOLS_FRAMES:
        fail(f"tools: /stats.json reports {live_stats.get('frames')} frames "
             f"({got.get('error')})")
    if jpeg[:3] != b"\xff\xd8\xff" or not got.get("/") \
            or not got.get("/map.json"):
        fail(f"tools: live view pages {sorted(got)} (JPEG SOI "
             f"{jpeg[:3]!r}, {got.get('error')})")
    if st["keyframes"] != plain["stats"]["keyframes"] \
            or not pos_err <= 1e-6:
        fail(f"tools: --trace --serve changed the run: keyframes "
             f"{st['keyframes']} against {plain['stats']['keyframes']}, "
             f"positions {pos_err} m")
    if device == "cuda" and (any(launches.get(name, 0) != TOOLS_FRAMES
                                 for name in FRAME_KERNELS)
                             or launches.get(ransac.KERNEL, 0) < TOOLS_FRAMES):
        fail(f"tools: launches {launches} for {TOOLS_FRAMES} frames")
    if not native.available():
        fail(f"tools: native runtime not built: {native.error()}")
    if rc3 != 0 or not queues or not all(
            isinstance(x, native.NativeQueue) for x in queues):
        fail(f"tools: --threaded returned {rc3} and took "
             f"{[type(x).__name__ for x in queues]}")
    if not pop_equal:
        fail("tools: NativeQueue.pop changed a 720p payload")
    return launches


def ba_window_problem(seed=0, w=8, l=200, noise_px=0.3, pose_pert=0.02,
                      point_pert=0.05, outlier_frac=0.0, drop_frac=0.2):
    """tests/test_ba.py::make_problem on the port's Lie helpers (float32,
    CPU): the same draws in the same order.  → (numpy dict of the BAProblem
    fields, Intrinsics of the tum_fr3 preset)."""
    k = Intrinsics.from_config(SLAMConfig.preset("tum_fr3").camera)
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def so3_exp(v):
        return lie.so3_exp(torch.from_numpy(np.asarray(v, f32))).numpy()

    xyz_gt = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 6], (l, 3)).astype(f32)
    qs, ts, uvs, valids = [], [], [], []
    for _ in range(w):
        q = so3_exp(rng.normal(size=3) * 0.05)
        t = (rng.normal(size=3) * 0.2).astype(f32)
        xc = (xyz_gt - t) @ lie.quat_to_mat(torch.from_numpy(q)).numpy()
        uv = np.stack([f32(k.fx) * xc[:, 0] / xc[:, 2] + f32(k.cx),
                       f32(k.fy) * xc[:, 1] / xc[:, 2] + f32(k.cy)], -1)
        uv += rng.normal(size=uv.shape) * noise_px
        valid = (xc[:, 2] > 0.3) & (rng.random(l) > drop_frac)
        if outlier_frac > 0:
            out = rng.random(l) < outlier_frac
            uv[out] += rng.uniform(5, 25, size=(out.sum(), 2)) * \
                rng.choice([-1, 1], size=(out.sum(), 2))
        qs.append(q)
        ts.append(t)
        uvs.append(uv)
        valids.append(valid)
    q_gt, t_gt = np.stack(qs), np.stack(ts)
    q0, t0 = q_gt.copy(), t_gt.copy()
    for i in range(1, w):
        dq = so3_exp(rng.normal(size=3).astype(f32) * pose_pert)
        q0[i] = lie.quat_mul(torch.from_numpy(dq),
                             torch.from_numpy(q_gt[i])).numpy()
        t0[i] = t_gt[i] + rng.normal(size=3).astype(f32) * pose_pert * 5
    xyz0 = xyz_gt + rng.normal(size=(l, 3)).astype(f32) * point_pert
    return dict(q_wc=q0, t_wc=t0, kf_active=np.ones(w, bool), xyz=xyz0,
                lm_active=np.ones(l, bool),
                uv=np.stack(uvs, axis=1).astype(f32),
                valid=np.stack(valids, axis=1)), k


def gauge_aligned_diff(res, orc):
    """tests/test_ba_oracle.py's comparison: map the solver's cameras into
    the oracle's gauge (one scale about the fixed first camera centre),
    then camera centre distances (m) and rotation angles (degrees)."""
    c0 = orc.t_wc[0]
    x_est = np.asarray(res.xyz.cpu(), np.float64) - c0
    x_orc = orc.xyz - c0
    s = float(np.sum(x_est * x_orc) / max(np.sum(x_est * x_est), 1e-30))
    t_al = s * (np.asarray(res.t_wc.cpu(), np.float64) - c0) + c0
    t_diff = np.linalg.norm(t_al - orc.t_wc, axis=1)
    dots = np.abs(np.sum(np.asarray(res.q_wc.cpu(), np.float64) * orc.q_wc,
                         axis=1))
    return t_diff, 2 * np.degrees(np.arccos(np.clip(dots, -1, 1)))


def phase_parity(device="cuda"):
    """cli parity at 424x240 on 120 frames, seed 0, anchored (the default):
    the port's ATE must be below the oracle's, the reference's claim for
    its anchored cells (parity_sweep/sweep.json); whether the oracle's ATE
    equals the cached oracle trajectory's is printed, not gated, beside
    the config fingerprint the cache file is keyed by and this run's: the
    cached oracle comes from an older config than today's (the
    fingerprints differ), so the two ATEs need not agree.  Then
    backend/ba.optimize on the card against oracle/ba_cpu.solve at the
    shipped scale, with test_ba_oracle.py's bounds."""
    try:
        from dynamic_visual_slam_tpu_torch.oracle import ba_cpu
    except ImportError as e:
        fail(f"parity: the oracle needs scipy: {e}")
    if importlib.util.find_spec("cv2") is None:
        fail("parity: the oracle needs OpenCV (cv2)")
    import cv2
    import scipy
    out_dir = os.path.join(ROOT, "build", f"parity_{device}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, res = _run_cli(["parity", "--device", device, "--frames",
                        str(PARITY_FRAMES), "--width", "424", "--height",
                        "240", "--seed", "0", "--out-dir", out_dir])
    sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if rc != 0:
        fail(f"parity: cli parity returned {rc}")
    run = res["report"]["runs"][0]
    gt_t = np.stack([t for _, t in synthetic.orbit_trajectory(
        PARITY_FRAMES, seed=1)])
    cached = np.load(PARITY_CACHE)
    cached_ate = round(float(trajectory.ate_rmse(
        cached["t"][:PARITY_FRAMES], gt_t)), 5)
    cache_fp = os.path.splitext(PARITY_CACHE)[0].rsplit("_", 1)[1]
    base = SLAMConfig()
    run_fp = parity_sweep.cfg_fingerprint(
        base.replace(camera=base.camera.scaled(424, 240)))
    # the window BA at the shipped scale, priors off
    problem, k = ba_window_problem(**BA_SHIPPED)
    cfg_ba = dataclasses.replace(
        SLAMConfig.preset("tum_fr3").ba, pose_prior_sigma_rot=0.0,
        pose_prior_sigma_t=0.0, point_prior_sigma=0.0, max_iterations=40)
    t1 = time.perf_counter()
    got = ba.optimize(k, convert.ba_problem(problem, device), cfg_ba)
    sync(device)
    ba_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    orc = ba_cpu.solve(problem["q_wc"], problem["t_wc"], problem["xyz"],
                       problem["uv"], problem["valid"], k.fx, k.fy, k.cx,
                       k.cy, sigma=cfg_ba.sigma_px,
                       huber_delta=cfg_ba.huber_delta)
    oracle_s = time.perf_counter() - t1
    cost_rel = abs(float(got.final_cost) - orc.cost) / orc.cost
    t_diff, ang = gauge_aligned_diff(got, orc)
    emit("parity", frames=PARITY_FRAMES, seconds=seconds,
         cv2=cv2.__version__, scipy=scipy.__version__,
         tpu_ate_m=run["tpu_ate_m"], oracle_ate_m=run["oracle_ate_m"],
         ate_ratio=run["ate_ratio"],
         tpu_vs_oracle_ate_m=run["tpu_vs_oracle_ate_m"],
         tpu_keyframes=run["tpu_keyframes"],
         oracle_keyframes=run["oracle_keyframes"],
         oracle_ba_rounds=run["oracle_ba_rounds"],
         cached_oracle_ate_m=cached_ate,
         oracle_equals_cache=cached_ate == run["oracle_ate_m"],
         cache_fingerprint=cache_fp, config_fingerprint=run_fp,
         fingerprints_match=cache_fp == run_fp,
         launches=launches, ba_problem=BA_SHIPPED,
         ba_final_cost=float(got.final_cost),
         ba_initial_cost=float(got.initial_cost),
         ba_iterations=int(got.iterations), oracle_cost=orc.cost,
         oracle_irls=orc.n_irls, ba_cost_rel=cost_rel,
         ba_max_centre_m=float(t_diff.max()),
         ba_max_rot_deg=float(ang.max()), ba_seconds=ba_s,
         oracle_seconds=oracle_s)
    if not run["tpu_ate_m"] < run["oracle_ate_m"]:
        fail(f"parity: ATE {run['tpu_ate_m']} m, not below the oracle's "
             f"{run['oracle_ate_m']} m")
    if device == "cuda" and (any(launches.get(name, 0) != PARITY_FRAMES
                                 for name in FRAME_KERNELS)
                             or launches.get(ransac.KERNEL, 0) < PARITY_FRAMES):
        fail(f"parity: launches {launches} for {PARITY_FRAMES} frames")
    if not cost_rel < BA_COST_REL:
        fail(f"parity: BA cost {float(got.final_cost)} against the "
             f"oracle's {orc.cost}")
    if not t_diff.max() < BA_CENTRE_M or not ang.max() < BA_ROT_DEG:
        fail(f"parity: BA cameras {t_diff.max()} m, {ang.max()} deg from "
             f"the oracle's")
    return launches


def phase_sweep(device="cuda"):
    """evaluation/parity_sweep.main at 640x480, one seed, 120 frames, both
    modes, into a fresh build/sweep_<device>/: the anchored cell's mean
    ATE at most the oracle's, both cells with the reference cell's keys
    plus device and power_limit, B1, D1 and B2 once a frame of each run."""
    out_dir = os.path.join(ROOT, "build", f"sweep_{device}")
    shutil.rmtree(out_dir, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = parity_sweep.main([
            "--device", device, "--res-list", "640x480", "--seeds", "1",
            "--frames-list", str(SWEEP_FRAMES), "--out", out_dir])
    sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if rc != 0:
        fail(f"sweep: parity_sweep.main returned {rc}")
    with open(SWEEP_REFERENCE_CELL) as f:
        want_keys = set(json.load(f)) | {"device", "power_limit"}
    cells = {}
    for mode in parity_sweep.MODES:
        with open(os.path.join(out_dir, f"cell_f{SWEEP_FRAMES}_640x480_"
                               f"{mode}.json")) as f:
            cells[mode] = json.load(f)
    emit("sweep", frames=SWEEP_FRAMES, seconds=seconds, launches=launches,
         cells={m: {k: v for k, v in c.items() if k != "provenance"}
                for m, c in cells.items()})
    for mode, cell in cells.items():
        if set(cell) != want_keys:
            fail(f"sweep: {mode} cell keys {sorted(cell)} are not the "
                 f"reference's {sorted(want_keys)}")
    anchored = cells["anchored"]
    if not anchored["tpu_ate_mean_m"] <= anchored["oracle_ate_mean_m"]:
        fail(f"sweep: anchored ATE {anchored['tpu_ate_mean_m']} m above the "
             f"oracle's {anchored['oracle_ate_mean_m']} m")
    runs = 2 * SWEEP_FRAMES
    if device == "cuda" and (any(launches.get(name, 0) != runs
                                 for name in FRAME_KERNELS)
                             or launches.get(ransac.KERNEL, 0) < runs):
        fail(f"sweep: launches {launches} for 2 runs of {SWEEP_FRAMES} "
             "frames")
    return launches


def main() -> None:
    name, smi_line = phase_device()
    phase_build()
    cfg = SLAMConfig()
    frames = frames_720p()
    rows = phase_kernels(frames, cfg)
    phase_small()
    launches = phase_main(frames, cfg)
    phase_place_batch(frames, cfg)
    phase_fleet_small()
    fleet_launches = phase_fleet(frames, cfg)
    fleet_mesh_launches = phase_fleet_mesh(frames, cfg)
    phase_place_small()
    phase_snapshot()
    tools_launches = phase_tools()
    parity_launches = phase_parity()
    sweep_launches = phase_sweep()
    phase_place_frames(cfg)
    phase_yolo()
    phase_dynamic_small()
    phase_dynamic_frames()
    phase_importers()
    vocab_launches = phase_train_vocab()
    phase_train_detector()
    for r in rows:
        # the main path's count; B3 (corner_score) has no caller there
        r["launches"] = launches[r["name"]]
        r["fleet_launches"] = fleet_launches.get(r["name"], 0)
        r["fleet_mesh_launches"] = fleet_mesh_launches.get(r["name"], 0)
        r["train_vocab_launches"] = vocab_launches.get(r["name"], 0)
        r["tools_launches"] = tools_launches.get(r["name"], 0)
        r["parity_launches"] = parity_launches.get(r["name"], 0)
        r["sweep_launches"] = sweep_launches.get(r["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches",
            "fleet_launches", "fleet_mesh_launches", "train_vocab_launches",
            "tools_launches", "parity_launches", "sweep_launches",
            "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    emit("done", seconds=time.perf_counter() - T_START)
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
