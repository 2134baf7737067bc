"""Command-line entry point of the PyTorch port: the reference package's
``run``, ``parity``, ``info``, ``train-detector`` and ``train-vocab``
(the reference's ``bench`` is not ported: ``benchmark/run.py`` measures
the port).

    python -m dynamic_visual_slam_tpu_torch.cli run --source synthetic \
        --frames 120
    python -m dynamic_visual_slam_tpu_torch.cli run --source dynamic \
        --detector yolov8 --weights assets/yolov8n_synth.npz
    python -m dynamic_visual_slam_tpu_torch.cli run --source /data/tum_fr3 \
        --preset tum_fr3 --detector none
    python -m dynamic_visual_slam_tpu_torch.cli run --trace --serve 8080
    python -m dynamic_visual_slam_tpu_torch.cli parity --frames 240 --seeds 5

    python -m dynamic_visual_slam_tpu_torch.cli info --preset tum_fr3
    python -m dynamic_visual_slam_tpu_torch.cli train-detector --steps 1500 \
        --out yolov8n_synth.npz
    python -m dynamic_visual_slam_tpu_torch.cli train-vocab \
        --out orbvoc_synth.npz

``run``, ``parity``, ``train-detector`` and ``train-vocab`` run on the
card (``--device cuda``, the default; they raise without one) unless
``--device cpu`` is given.  ``train-detector`` writes the reference's YOLOv8 npz with
the input size embedded (its training images render in up to 8 worker
processes), ``train-vocab`` its vocabulary npz; both packages read both.
``run`` writes (``--out-dir``) frontend and
keyframe trajectories (TUM format), landmark and trajectory PLYs, and the
stats JSON (the system's counters, ``fps``, ``wall_s``, ``landmarks``,
per-stage timings, ``ate_rmse_m`` on synthetic sources), and with
``--trace`` a chrome trace (``trace.json``, ``utils/profiling.TRACER``'s
session): on the per-frame path a "frame" span a frame with the layer and
stage spans of ``process`` inside it, and under ``otherData`` the whole
session's spans and counters (``--batch``'s and ``--threaded``'s calls,
the threaded runner's ``queue.wait`` and ``queue.dropped``).
``--serve [PORT]`` serves a live view on 127.0.0.1 while it runs
(``utils/serve.LiveView``), refreshed every ``--serve-every`` frames;
``DVS_SERVE_HOLD_S`` keeps it up that many seconds after the run.
``--save-state`` writes a checkpoint of the final state and ``--resume``
starts from one (a missing checkpoint or another config exits with code
2).  ``main(argv, out=...)`` also hands an in-process caller the run's
system.
``parity`` runs the port's pipeline and the CPU oracle (OpenCV ORB and PnP,
f64 scipy BA) on the same frames and writes ``parity.json``; its ``tpu_``
keys, kept from the reference's reports (``parity_sweep/``), name the
pipeline under test, here the port's on ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.config import SLAMConfig


def _build_config(args) -> SLAMConfig:
    cfg = SLAMConfig.preset(args.preset) if args.preset else SLAMConfig()
    if args.width and args.height:
        cfg = cfg.replace(camera=cfg.camera.scaled(args.width, args.height))
    if getattr(args, "anchor", None) is not None:
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, anchor_to_keyframe=args.anchor))
    return cfg


def cmd_run(args, out: Optional[dict] = None) -> int:
    from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
    from dynamic_visual_slam_tpu_torch.utils import profiling

    cfg = _build_config(args)
    os.makedirs(args.out_dir, exist_ok=True)

    detector = None
    if args.detector == "yolov8":
        from dynamic_visual_slam_tpu_torch.semantic.detector import (
            YoloDetector)
        detector = YoloDetector(cfg, weights_path=args.weights,
                                device=args.device)
        if not args.weights:
            print("warning: no detector weights given — random init "
                  "(detections will be meaningless)", file=sys.stderr)
    elif args.detector == "gt":
        # ground-truth bboxes from the dynamic synthetic world
        from dynamic_visual_slam_tpu_torch.semantic.detector import GTDetector
        if args.source != "dynamic":
            print("error: --detector gt requires --source dynamic",
                  file=sys.stderr)
            return 2
        detector = GTDetector(cfg, device=args.device)

    if args.vocab and not os.path.exists(args.vocab):
        print(f"error: vocabulary '{args.vocab}' not found", file=sys.stderr)
        return 2
    slam = SLAMSystem(cfg, loop_pgo=args.loop_pgo,
                      vocab_path=args.vocab or None,
                      enable_relocalization=not args.no_reloc,
                      device=args.device)
    if slam.enable_place_recognition:
        # build the place chain's programs before the first frame
        slam.warmup_place()
    if args.resume:
        resume = args.resume
        if not os.path.exists(resume) and os.path.exists(resume + ".npz"):
            resume += ".npz"      # np.savez appends the extension on save
        if not os.path.exists(resume):
            print(f"error: checkpoint '{args.resume}' not found",
                  file=sys.stderr)
            return 2
        try:
            slam.restore(resume)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"resumed from {resume} "
              f"({int(slam.map_state.keyframes.count)} keyframes)",
              file=sys.stderr)
    timer = profiling.StageTimer()
    tracer = profiling.TRACER if args.trace else None
    if tracer:
        tracer.enable()

    live = None
    if args.serve is not None:
        from dynamic_visual_slam_tpu_torch.utils.serve import LiveView
        live = LiveView(port=args.serve)
        print(f"live view at http://127.0.0.1:{live.port}/",
              file=sys.stderr)
    try:
        return _run_frames(args, cfg, slam, detector, timer, tracer, live,
                           out)
    finally:
        if tracer:
            tracer.disable()
        if live is not None:
            live.close()


def _run_frames(args, cfg, slam, detector, timer, tracer, live,
                out: Optional[dict]) -> int:
    from dynamic_visual_slam_tpu_torch.backend.mapping import Detections
    from dynamic_visual_slam_tpu_torch.io import synthetic, trajectory, tum
    from dynamic_visual_slam_tpu_torch.utils import profiling, viz

    if args.source == "synthetic":
        frames = synthetic.generate_sequence(cfg.camera, args.frames,
                                             seed=args.seed,
                                             depth_noise=0.004)
        gt = []
    elif args.source == "dynamic":
        # moving-object scene; GT bboxes feed the gt detector if selected
        def _dyn():
            for g, d, r, t, ts, boxes in synthetic.generate_dynamic_sequence(
                    cfg.camera, args.frames, seed=args.seed,
                    depth_noise=0.004):
                if detector is not None and hasattr(detector, "record"):
                    detector.record(ts, boxes)
                yield g, d, r, t, ts
        frames = _dyn()
        gt = []
    else:
        if not os.path.exists(os.path.join(args.source, "rgb.txt")):
            print(f"error: '{args.source}' is not a TUM RGB-D directory "
                  "(rgb.txt not found); use --source synthetic or a dataset "
                  "root containing rgb.txt/depth.txt", file=sys.stderr)
            return 2
        ds = tum.TUMDataset(args.source)
        frames = ((g, d, None, None, ts) for g, d, ts in
                  ds.frames(limit=args.frames or None))
        gt = ds

    # Ground truth keyed by frame timestamp: under --threaded the
    # drop-oldest queue means not every yielded frame is processed, so gt
    # must be aligned to the trajectory stamps afterwards, never zipped
    # positionally with the input stream.
    gt_map = {}
    runner_stats = None
    t_start = time.perf_counter()
    n = 0

    def _detect(gray, ts):
        """Run the detector for one frame (stamp-aware detectors get ts)."""
        rgb = np.stack([gray] * 3, axis=-1)
        if hasattr(detector, "record"):
            return detector(rgb, ts)
        return detector(rgb)

    def _live_update(gray=None, final=False):
        """Publish a live-view snapshot (annotated frame, stat tiles,
        top-down map): the one place the live view reads the card.  Each
        refresh reads the current keypoint block (``--serve-every`` sets
        the cadence); the landmark cloud, a bigger read, refreshes at 1/6
        of that cadence."""
        if live is None:
            return
        uv = None
        if gray is not None:
            kp = slam.tracker_state.prev
            uv = kp.uv.cpu().numpy()[kp.mask.cpu().numpy()]
        st = dict(slam.stats)
        if slam.trajectory:
            fr = slam.trajectory[-1]
            st.update(x=round(float(fr.t_wc[0]), 4),
                      y=round(float(fr.t_wc[1]), 4),
                      z=round(float(fr.t_wc[2]), 4),
                      tracking_ok=bool(fr.tracking_ok))
        st["fps"] = round(n / max(time.perf_counter() - t_start, 1e-9), 2)
        traj = np.stack([f.t_wc for f in slam.trajectory]) \
            if slam.trajectory else None
        lms = None
        if final or (n // max(1, args.serve_every)) % 6 == 0:
            lms = slam.landmarks_world()["xyz"]
        live.update(gray, uv, st, traj, lms)

    if args.batch and not args.threaded:
        # offline throughput mode: frames through process_batch in batches
        # of B; a detector runs per frame and its Detections are stacked
        b = args.batch
        buf, det_buf = [], []
        for gray, depth, r_gt, t_gt, ts in frames:
            if t_gt is not None:
                gt_map[float(ts)] = t_gt
            if detector is not None:
                with timer.stage("detector"):
                    det_buf.append(_detect(np.asarray(gray), float(ts)))
            buf.append((np.asarray(gray), np.asarray(depth), float(ts)))
            n += 1
            if len(buf) == b:
                dets = Detections(*(torch.stack(xs) for xs in zip(
                    *det_buf))) if det_buf else None
                last_gray = buf[-1][0]
                with timer.stage("batch"):
                    slam.process_batch(
                        np.stack([x[0] for x in buf]),
                        np.stack([x[1] for x in buf]),
                        np.asarray([x[2] for x in buf]),
                        detections=dets)
                buf, det_buf = [], []
                _live_update(last_gray)
        for i, (gray, depth, ts) in enumerate(buf):  # tail < one batch
            det = det_buf[i] if det_buf else None
            slam.process(gray, depth, ts, detections=det)
        slam.finalize()
        wall = time.perf_counter() - t_start
    elif args.threaded:
        # middleware transport: IO thread → bounded queue →
        # ApproximateTime → device loop (pipeline/runner.py)
        from dynamic_visual_slam_tpu_torch.pipeline.runner import (
            ThreadedPipeline)

        def gen():
            nonlocal n
            for gray, depth, r_gt, t_gt, ts in frames:
                if t_gt is not None:
                    gt_map[float(ts)] = t_gt
                n += 1
                yield gray, depth, ts

        runner = ThreadedPipeline(slam, detector=detector)
        runner_stats = runner.run(gen())
        wall = time.perf_counter() - t_start
    else:
        debug_every = args.debug_images
        if debug_every:
            os.makedirs(os.path.join(args.out_dir, "debug"), exist_ok=True)
        for gray, depth, r_gt, t_gt, ts in frames:
            det = None
            if detector is not None:
                with timer.stage("detector"):
                    det = _detect(np.asarray(gray), float(ts))
            with profiling.TRACER.span("frame"), timer.stage("frame"):
                slam.process(gray, depth, ts, detections=det)
            if debug_every and n % debug_every == 0:
                # annotated feature image, the reference's per-frame
                # /feature_detector/features_image (frontend.cpp:1229-1232)
                kp = slam.tracker_state.prev
                m = kp.mask.cpu().numpy()
                img = viz.annotate_features(np.asarray(gray),
                                            kp.uv.cpu().numpy()[m])
                path = os.path.join(args.out_dir, "debug",
                                    f"frame_{n:05d}.png")
                if not viz.save_image(path, img):
                    np.save(path.replace(".png", ".npy"), img)
            if t_gt is not None:
                gt_map[float(ts)] = t_gt
            n += 1
            if live is not None and n % max(1, args.serve_every) == 0:
                _live_update(np.asarray(gray))
        slam.finalize()
        wall = time.perf_counter() - t_start

    # exports
    stamps, rs, ts_arr = slam.frontend_trajectory()
    trajectory.write_tum(os.path.join(args.out_dir, "frontend.tum"),
                         stamps, list(zip(rs, ts_arr)))
    kf_stamps, kf_rs, kf_ts = slam.keyframe_trajectory()
    trajectory.write_tum(os.path.join(args.out_dir, "keyframes.tum"),
                         kf_stamps, list(zip(kf_rs, kf_ts)))
    lms = slam.landmarks_world()
    viz.landmarks_to_ply(os.path.join(args.out_dir, "landmarks.ply"),
                         lms["xyz"], lms["n_obs"])
    viz.trajectory_to_ply(os.path.join(args.out_dir, "trajectory.ply"),
                          ts_arr)
    if tracer:
        profiling.write_chrome_trace(tracer.disable(),
                                     os.path.join(args.out_dir, "trace.json"))
    if args.save_state:
        # np.savez appends .npz when absent; normalise so the printed path
        # and a later --resume both name the file written
        ckpt = args.save_state if args.save_state.endswith(".npz") \
            else args.save_state + ".npz"
        slam.save(ckpt)
        print(f"checkpoint written to {ckpt}", file=sys.stderr)

    n_done = runner_stats["frames_processed"] if runner_stats else n
    stats = dict(slam.stats, fps=round(n_done / max(wall, 1e-9), 2),
                 wall_s=round(wall, 2), landmarks=int(len(lms["xyz"])),
                 stages=timer.summary())
    if runner_stats:
        stats["queue_dropped"] = runner_stats.get("queue_dropped", 0)
        stats["frames_in"] = runner_stats.get("frames_in", n)
    if args.source in ("synthetic", "dynamic") and gt_map:
        # align gt by trajectory stamp (processed frames only)
        keys = np.asarray(sorted(gt_map))
        sel_est, sel_gt = [], []
        for i, s in enumerate(stamps):
            j = int(np.clip(np.searchsorted(keys, s), 0, len(keys) - 1))
            jb = j - 1 if j > 0 and abs(keys[j - 1] - s) < abs(keys[j] - s) \
                else j
            if abs(keys[jb] - s) < 1e-3:
                sel_est.append(ts_arr[i])
                sel_gt.append(gt_map[float(keys[jb])])
        if sel_est:
            ate = trajectory.ate_rmse(np.stack(sel_est), np.stack(sel_gt))
            stats["ate_rmse_m"] = round(float(ate), 5)
    elif args.source not in ("synthetic", "dynamic"):
        gt_pos = gt.gt_positions_at(stamps)
        if gt_pos is not None:
            stats["ate_rmse_m"] = round(
                float(trajectory.ate_rmse(ts_arr, gt_pos)), 5)
    with open(os.path.join(args.out_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats, indent=2))
    if out is not None:
        out.update(system=slam, stats=stats, gt_positions=gt_map)
    if live is not None:
        _live_update(final=True)
        hold = float(os.environ.get("DVS_SERVE_HOLD_S", "0"))
        if hold > 0:          # keep the console up after the run
            print(f"holding live view {hold:.0f}s "
                  f"(http://127.0.0.1:{live.port}/)", file=sys.stderr)
            time.sleep(hold)
    return 0


def _parity_once(cfg, frames, gt_t, source_name, device) -> dict:
    """One run of the port's pipeline and one of the CPU oracle on a shared
    frame list → report dict (the reference's keys; ``tpu_`` names the
    pipeline under test)."""
    from dynamic_visual_slam_tpu_torch.io import trajectory
    from dynamic_visual_slam_tpu_torch.oracle.pipeline_cpu import OracleSLAM
    from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem

    slam = SLAMSystem(cfg, enable_place_recognition=False, device=device)
    for gray, depth, _, _, ts in frames:
        slam.process(gray, depth, ts)
    slam.finalize()
    _, _, tpu_t = slam.frontend_trajectory()

    orc = OracleSLAM(cfg, run_ba=True)
    for gray, depth, _, _, ts in frames:
        orc.process(gray, depth, ts)
    _, _, orc_t = orc.frontend_trajectory()

    report = dict(
        source=source_name, frames=len(frames),
        tpu_keyframes=slam.stats["keyframes"],
        oracle_keyframes=len(orc.keyframes),
        oracle_ba_rounds=orc.ba_rounds,
        tpu_vs_oracle_ate_m=round(
            float(trajectory.ate_rmse(tpu_t, orc_t)), 5))
    if gt_t is not None:
        tpu_ate = float(trajectory.ate_rmse(tpu_t, gt_t))
        orc_ate = float(trajectory.ate_rmse(orc_t, gt_t))
        report.update(
            tpu_ate_m=round(tpu_ate, 5), oracle_ate_m=round(orc_ate, 5),
            ate_ratio=round(tpu_ate / max(orc_ate, 1e-9), 4))
    return report


def cmd_parity(args, out: Optional[dict] = None) -> int:
    """Trajectory parity: run the port's pipeline (on ``--device``) and the
    CPU oracle pipeline (cv2 ORB + BFMatcher + solvePnPRansac + f64 scipy
    BA, the reference algorithm on the reference's own libraries) on the
    same frames; report the ATE of each against ground truth and against
    each other.  With --seeds N, run N seeds and report the distribution of
    the ATE ratio (mean, median, worst).  OpenCV and scipy must be
    installed: their absence raises."""
    import cv2  # noqa: F401 - the oracle's; fail before any frame runs

    from dynamic_visual_slam_tpu_torch.io import synthetic, tum
    from dynamic_visual_slam_tpu_torch.oracle import ba_cpu  # noqa: F401

    cfg = _build_config(args)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.source != "synthetic":
        if not os.path.exists(os.path.join(args.source, "rgb.txt")):
            print(f"error: '{args.source}' is not a TUM RGB-D directory",
                  file=sys.stderr)
            return 2
        ds = tum.TUMDataset(args.source)
        frames = [(g, d, None, None, ts)
                  for g, d, ts in ds.frames(limit=args.frames or None)]
        stamps = np.asarray([f[4] for f in frames])
        report = _parity_once(cfg, frames, ds.gt_positions_at(stamps),
                              args.source, args.device)
    else:
        runs = []
        for seed in range(args.seed, args.seed + max(args.seeds, 1)):
            frames = list(synthetic.generate_sequence(
                cfg.camera, args.frames, seed=seed, depth_noise=0.004))
            gt_t = np.stack([f[3] for f in frames])
            rep = _parity_once(cfg, frames, gt_t, f"synthetic(seed={seed})",
                               args.device)
            rep["seed"] = seed
            runs.append(rep)
            print(json.dumps(rep), flush=True)
        report = dict(runs=runs)
        ratios = [r["ate_ratio"] for r in runs]
        report["summary"] = dict(
            n=len(ratios),
            frames=args.frames,
            resolution=f"{cfg.camera.width}x{cfg.camera.height}",
            ate_ratio_mean=round(float(np.mean(ratios)), 4),
            ate_ratio_median=round(float(np.median(ratios)), 4),
            ate_ratio_worst=round(float(np.max(ratios)), 4),
            tpu_ate_mean_m=round(float(np.mean(
                [r["tpu_ate_m"] for r in runs])), 5),
            oracle_ate_mean_m=round(float(np.mean(
                [r["oracle_ate_m"] for r in runs])), 5))
    with open(os.path.join(args.out_dir, "parity.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report.get("summary", report), indent=2))
    if out is not None:
        out.update(report=report)
    return 0


def cmd_info(args, out: Optional[dict] = None) -> int:
    print(_build_config(args).to_json())
    return 0


def cmd_train_detector(args, out: Optional[dict] = None) -> int:
    """Train YOLOv8n on the synthetic dynamic world, evaluate it on held-out
    scenes, and save weights ``run --detector yolov8 --weights`` loads."""
    from dynamic_visual_slam_tpu_torch.models.convert_ultralytics import (
        save_params)
    from dynamic_visual_slam_tpu_torch.semantic import train as T

    params, history = T.train(
        steps=args.steps, batch=args.train_batch,
        input_size=args.input_size, pool_images=args.pool,
        lr=args.lr, seed=args.seed, device=args.device)
    metrics = T.evaluate(params, input_size=args.input_size,
                         n_images=args.eval_images, seed=args.seed + 991,
                         device=args.device)
    # the native input size, which YoloDetector adopts on load
    params["input_size"] = int(args.input_size)
    save_params(params, args.out)
    report = dict(weights=args.out, steps=args.steps,
                  input_size=args.input_size,
                  loss_first=history[0], loss_last=history[-1],
                  **{k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in metrics.items()})
    if args.in_loop_frames > 0:
        # culling off against GT boxes against this detector, the same
        # dynamic sequence: ATE and walker landmarks
        report["in_loop"] = T.in_loop_eval(
            params, n_frames=args.in_loop_frames, seed=args.seed,
            device=args.device)
    print(json.dumps(report, indent=2))
    print(f"use: dynamic_visual_slam_tpu_torch run --detector yolov8 "
          f"--weights {args.out}")
    if out is not None:
        out.update(report=report, params=params, history=history)
    return 0


def cmd_train_vocab(args, out: Optional[dict] = None) -> int:
    """Train the pretrained BoW vocabulary asset from synthetic worlds and
    the port's ORB extractor."""
    from dynamic_visual_slam_tpu_torch.place.pretrain import (
        train_pretrained_vocabulary)

    report = train_pretrained_vocabulary(
        args.out, k=args.branching, depth=args.depth,
        n_scenes=args.scenes, frames_per_scene=args.frames_per_scene,
        per_frame=args.per_frame, seed=args.seed, device=args.device)
    print(json.dumps(report, indent=2))
    print(f"use: dynamic_visual_slam_tpu_torch run --vocab {report['path']}")
    if out is not None:
        out.update(report=report)
    return 0


def main(argv: Optional[list] = None, out: Optional[dict] = None) -> int:
    """Parse ``argv`` and run the subcommand.  ``out``, a dict, receives
    ``system`` (the run's SLAMSystem), ``stats`` and ``gt_positions`` (the
    synthetic sources' ground-truth positions by frame stamp)."""
    p = argparse.ArgumentParser(
        prog="dynamic_visual_slam_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run the SLAM pipeline")
    pr.add_argument("--source", default="synthetic",
                    help="'synthetic', 'dynamic' (moving objects + GT "
                         "bboxes), or a TUM RGB-D directory")
    pr.add_argument("--preset", default=None,
                    choices=[None, "camera", "camera_rviz", "yolo_slam",
                             "bag_playback", "tum_fr3"],
                    help="launch-file-equivalent preset")
    pr.add_argument("--frames", type=int, default=90)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--width", type=int, default=424)
    pr.add_argument("--height", type=int, default=240)
    pr.add_argument("--detector", default="none",
                    choices=["none", "yolov8", "gt"])
    pr.add_argument("--weights", default=None,
                    help="YOLOv8 weights: the reference's .npz or an "
                         "ultralytics .pt (none: random init)")
    pr.add_argument("--out-dir", default="slam_out")
    pr.add_argument("--trace", action="store_true",
                    help="write a chrome trace of the per-frame process "
                         "calls to OUT_DIR/trace.json (native runtime, "
                         "built with g++ at first use; exit code 2 when it "
                         "cannot be built)")
    pr.add_argument("--batch", type=int, default=0, metavar="B",
                    help="offline throughput mode: frames through "
                         "process_batch in batches of B")
    pr.add_argument("--debug-images", type=int, default=0, metavar="N",
                    help="write an annotated feature image every N frames "
                         "to OUT_DIR/debug/")
    pr.add_argument("--threaded", action="store_true",
                    help="route frames through the bounded-queue/"
                         "ApproximateTime middleware (IO thread + device "
                         "loop)")
    pr.add_argument("--loop-pgo", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="consume loop closures through the pose-graph "
                         "solve over the keyframe ring; --no-loop-pgo "
                         "selects the age-interpolated correction")
    pr.add_argument("--no-reloc", action="store_true",
                    help="disable BoW relocalization after tracking loss")
    pr.add_argument("--serve", type=int, nargs="?", const=8080, default=None,
                    metavar="PORT",
                    help="serve a live operator view (annotated frame, "
                         "stats, top-down map) at http://127.0.0.1:PORT "
                         "while running (default port 8080; 0 picks a free "
                         "one)")
    pr.add_argument("--serve-every", type=int, default=5, metavar="N",
                    help="refresh the live view every N frames (each "
                         "refresh reads the current keypoint block off the "
                         "card)")
    pr.add_argument("--anchor", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="keyframe-anchored tracking (on by default, "
                         "cfg.tracking.anchor_to_keyframe); --no-anchor "
                         "selects the frame-to-frame chain")
    pr.add_argument("--vocab", default=None, metavar="NPZ",
                    help="pretrained BoW vocabulary (e.g. "
                         "assets/orbvoc_synth.npz); else one is trained "
                         "online")
    pr.add_argument("--resume", default=None, metavar="CKPT",
                    help="restore a --save-state checkpoint (tracker + map "
                         "+ place database) before the first frame")
    pr.add_argument("--save-state", default=None, metavar="CKPT",
                    help="write a checkpoint of the final system state "
                         "(resumable with --resume)")
    pr.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    pr.set_defaults(fn=cmd_run)

    pp = sub.add_parser(
        "parity", help="the port's pipeline against the CPU oracle "
                       "(trajectory parity; the report's tpu_ keys name the "
                       "pipeline under test)")
    pp.add_argument("--source", default="synthetic",
                    help="'synthetic' or a TUM RGB-D directory")
    pp.add_argument("--preset", default=None)
    pp.add_argument("--frames", type=int, default=240)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--seeds", type=int, default=1, metavar="N",
                    help="run N consecutive seeds (synthetic only) and "
                         "report the ATE-ratio distribution")
    pp.add_argument("--width", type=int, default=424)
    pp.add_argument("--height", type=int, default=240)
    pp.add_argument("--anchor", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="keyframe-anchored tracking in the pipeline under "
                         "test (default: the config's, on)")
    pp.add_argument("--out-dir", default="parity_out")
    pp.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    pp.set_defaults(fn=cmd_parity)

    pt = sub.add_parser("train-detector",
                        help="train YOLOv8n on the synthetic dynamic world "
                             "(no pretrained weights needed)")
    pt.add_argument("--steps", type=int, default=1500)
    pt.add_argument("--train-batch", type=int, default=16)
    pt.add_argument("--input-size", type=int, default=256)
    pt.add_argument("--pool", type=int, default=384,
                    help="rendered training images")
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--eval-images", type=int, default=48)
    pt.add_argument("--in-loop-frames", type=int, default=0, metavar="N",
                    help="after training, run the N-frame dynamic walker "
                         "sequence with culling off / GT bboxes / this "
                         "detector and report ATE + walker-landmark counts")
    pt.add_argument("--out", default="yolov8n_synth.npz")
    pt.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    pt.set_defaults(fn=cmd_train_detector)

    pv = sub.add_parser("train-vocab",
                        help="train the pretrained BoW vocabulary asset "
                             "(ORBvoc.txt equivalent, no downloads)")
    pv.add_argument("--branching", type=int, default=10)
    pv.add_argument("--depth", type=int, default=3)
    pv.add_argument("--scenes", type=int, default=12)
    pv.add_argument("--frames-per-scene", type=int, default=24)
    pv.add_argument("--per-frame", type=int, default=500,
                    help="descriptors sampled per frame")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--out", default="assets/orbvoc_synth.npz")
    pv.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    pv.set_defaults(fn=cmd_train_vocab)

    pi = sub.add_parser("info", help="print the resolved config")
    pi.add_argument("--preset", default=None)
    pi.add_argument("--width", type=int, default=None)
    pi.add_argument("--height", type=int, default=None)
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args, out)


if __name__ == "__main__":
    raise SystemExit(main())
