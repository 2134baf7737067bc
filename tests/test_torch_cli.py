"""The port's command line, ``cli run``, ``parity``, ``info``,
``train-detector`` and ``train-vocab``, on the CPU, and the host modules
its outputs go through, against the JAX package.

- ``cli run --source dynamic --detector gt`` at 160x120 writes the
  trajectory that SLAMSystem gives on the same frames and detections, frame
  by frame, with ``--batch 4`` and with ``--threaded``; without ``--device
  cpu`` and without a card it raises.  Tolerance: none.  The command line
  drives the same system on the same inputs, and the TUM file prints each
  pose to 6 decimals.
- Beside the reference's ``cli run`` (per frame, 24 frames at 160x120,
  seed 3, GT boxes, every default on) with the reference's RANSAC draws fed
  to the port (torch_parity.JaxSampler; the port extracts its own
  keypoints, whose pyramid equals the reference's): the stats carry the
  same keys and the same counters (landmarks within 2 %, the dynamic
  per-frame slice's bound), the stages the same names and counts, the TUM
  files the same stamps, and every frontend and keyframe position lies
  within 6 mm of the reference's, the dynamic per-frame slice's bound
  (tests/test_torch_dynamic.py), with the RMS within 2 mm and the ATE
  within 1 mm (measurements in ``test_run_matches_the_reference_cli``).
- ``--save-state`` then ``--resume``: the checkpoint restores the saved
  map exactly and the resumed run carries on from its counters; a missing
  checkpoint or another config exits with 2.
- ``info`` prints the reference's JSON to the byte; ``train-vocab`` and
  ``train-detector`` at toy size write files the reference's loaders read
  (the vocabulary's tables and the detector's weights and input size
  exactly); ``run --detector yolov8`` without ``--weights`` runs on a
  random initialisation and warns; the training commands default to the
  card.
- The operator's tools: ``--trace --serve 0 --serve-every 2`` through the
  reference's ``cli run`` and the port's, both on a stand-in system
  (``FakeSystem``), per frame, ``--batch 4`` and ``--threaded``: the live
  view gets the same updates and trace.json the same events; on the port's
  system ``--trace`` (a "frame" tree a frame, the layers' stage spans
  inside it) and ``--serve`` (N // 2 + 1
  updates) leave the trajectory and the stats but for their timings as
  without them; ``--threaded`` moves the frames through the native
  runtime's NativeQueue byte for byte; ``parity --seeds 2`` reports the
  direct runs of the port's SLAMSystem and OracleSLAM, with the
  reference's keys, and defaults to the card.
- The host modules the outputs go through are numpy copies of the
  reference's: TUM trajectory files (``quat_from_mat``, ``write_tum``,
  ``read_tum``), the ATE (``umeyama_alignment``, ``ate_rmse``; 1e-12),
  the PLY writers, the feature image, ``io/tum.TUMDataset`` and
  ``StageTimer.summary`` (on the same clock): equal to the byte, but for
  the port's two extra stage keys (``median_ms``, ``p90_ms``).
"""

import json
import time
import types

import numpy as np
import pytest
import torch

from torch_parity import JaxSampler, Pacer

from dynamic_visual_slam_tpu import cli as jcli
from dynamic_visual_slam_tpu.io import trajectory as jtraj
from dynamic_visual_slam_tpu.io import tum as jtum
from dynamic_visual_slam_tpu.utils import profiling as jprof
from dynamic_visual_slam_tpu.utils import viz as jviz
from dynamic_visual_slam_tpu_torch import cli, convert
from dynamic_visual_slam_tpu_torch.backend.mapping import Detections
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.io import synthetic, trajectory, tum
from dynamic_visual_slam_tpu_torch.pipeline import slam as pslam
from dynamic_visual_slam_tpu_torch.pipeline.runner import (_pack_frame,
                                                           _unpack_frame)
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
from dynamic_visual_slam_tpu_torch.semantic.detector import (
    GTDetector, boxes_to_detections)
from dynamic_visual_slam_tpu_torch.utils import profiling, viz

torch.set_num_threads(2)
N = 12
ARGS = ["run", "--device", "cpu", "--source", "dynamic", "--detector", "gt",
        "--width", "160", "--height", "120", "--frames", str(N),
        "--seed", "3"]
N_REF = 24
REF_ARGS = ["run", "--source", "dynamic", "--detector", "gt", "--width",
            "160", "--height", "120", "--frames", str(N_REF), "--seed", "3"]
POS_MAX_M = 6e-3
POS_RMS_M = 2e-3
ATE_M = 1e-3


def _direct(batch: int, wire: bool):
    """The system on the command's frames; ``wire``: through the threaded
    transport's u8 gray / u16 millimetre payloads, as --threaded feeds it."""
    cfg = SLAMConfig().replace(camera=SLAMConfig().camera.scaled(160, 120))
    frames = list(synthetic.generate_dynamic_sequence(
        cfg.camera, N, seed=3, depth_noise=0.004))
    if wire:
        frames = [_unpack_frame(_pack_frame(g, d), 120, 160) + tuple(f)
                  for g, d, *f in frames]
    cap = cfg.semantic.max_detections
    dets = [boxes_to_detections(f[5], cap, device="cpu") for f in frames]
    slam = SLAMSystem(cfg, device="cpu")
    slam.warmup_place()
    n_full = N - N % batch if batch else 0
    for i0 in range(0, n_full, max(batch, 1)):
        chunk = frames[i0:i0 + batch]
        slam.process_batch(
            np.stack([f[0] for f in chunk]), np.stack([f[1] for f in chunk]),
            np.asarray([f[4] for f in chunk]),
            detections=Detections(*(torch.stack(xs) for xs in
                                    zip(*dets[i0:i0 + batch]))))
    for f, det in zip(frames[n_full:], dets[n_full:]):
        slam.process(f[0], f[1], f[4], detections=det)
    slam.finalize()
    return slam


def _tum_lines(slam, tmp_path):
    stamps, rs, ts = slam.frontend_trajectory()
    path = tmp_path / "direct.tum"
    trajectory.write_tum(str(path), stamps, list(zip(rs, ts)))
    return path.read_text().splitlines()


@pytest.mark.parametrize("mode", ["frames", "batch", "threaded"])
def test_run_writes_the_systems_trajectory(tmp_path, monkeypatch, mode):
    """Under --threaded the frames are paced (torch_parity.Pacer), so that
    every frame pairs with its detection as in the direct run."""
    extra = {"frames": [], "batch": ["--batch", "4"],
             "threaded": ["--threaded"]}[mode]
    if mode == "threaded":
        pacer = Pacer()
        gen = synthetic.generate_dynamic_sequence
        monkeypatch.setattr(GTDetector, "__call__",
                            pacer.wrap(GTDetector.__call__))
        monkeypatch.setattr(synthetic, "generate_dynamic_sequence",
                            lambda *a, **k: pacer.frames(gen(*a, **k)))
    out_dir = tmp_path / "out"
    res = {}
    assert cli.main(ARGS + extra + ["--out-dir", str(out_dir)], out=res) == 0
    monkeypatch.undo()
    slam = _direct(4 if mode == "batch" else 0, mode == "threaded")
    got = (out_dir / "frontend.tum").read_text().splitlines()
    assert len(got) == N
    assert got == _tum_lines(slam, tmp_path)
    stats = json.loads((out_dir / "stats.json").read_text())
    assert stats == res["stats"]
    assert stats["frames"] == N
    assert not np.any(res["system"].landmarks_world()["category"] == 1)
    assert stats["keyframes"] == slam.stats["keyframes"]
    assert np.isfinite(stats["ate_rmse_m"])
    for name in ("keyframes.tum", "landmarks.ply", "trajectory.ply"):
        assert (out_dir / name).stat().st_size > 0
    if mode == "frames":
        assert set(stats["stages"]) == {"detector", "frame"}
        assert stats["stages"]["frame"]["count"] == N
        assert stats["stages"]["frame"]["median_ms"] > 0
    if mode == "threaded":
        assert stats["queue_dropped"] == 0


def test_run_matches_the_reference_cli(tmp_path, monkeypatch):
    """Measured on an AVX-512 host, this comparison run alone under
    MKL_CBWR AVX2, AVX512 and COMPATIBLE, each with ATEN_CPU_CAPABILITY
    default and avx2: frontend positions RMS 1.168 mm and worst 1.376 mm
    (frame 23), keyframe positions RMS 1.132 mm and worst 1.381 mm, under
    every one of them; ATE 0.05893 m against the reference's 0.05923 m;
    2,388 landmarks against 2,387; 20 keyframes in both."""
    monkeypatch.setattr(jcli, "_enable_compilation_cache", lambda: None)
    assert jcli.main(["--platform", "cpu"] + REF_ARGS
                     + ["--out-dir", str(tmp_path / "ref")]) == 0

    class Drawn(SLAMSystem):
        def __init__(self, *a, **k):
            super().__init__(*a, sampler=JaxSampler(N_REF), **k)

    monkeypatch.setattr(pslam, "SLAMSystem", Drawn)
    assert cli.main(REF_ARGS + ["--device", "cpu", "--out-dir",
                                str(tmp_path / "port")]) == 0
    want = json.loads((tmp_path / "ref" / "stats.json").read_text())
    got = json.loads((tmp_path / "port" / "stats.json").read_text())
    assert set(got) == set(want)
    for key in ("frames", "keyframes", "loop_candidates", "relocalizations",
                "ba_runs", "ba_converged"):
        assert got[key] == want[key], key
    assert abs(got["landmarks"] - want["landmarks"]) <= 0.02 * want[
        "landmarks"]
    assert got["frames"] == N_REF
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) <= ATE_M
    assert set(got["stages"]) == set(want["stages"]) == {"detector",
                                                         "frame"}
    for name, entry in want["stages"].items():
        assert set(got["stages"][name]) == set(entry) | {"median_ms",
                                                         "p90_ms"}
        assert got["stages"][name]["count"] == entry["count"] == N_REF
    for name in ("frontend.tum", "keyframes.tum"):
        w_st, w_t = jtraj.read_tum(str(tmp_path / "ref" / name))
        g_st, g_t = trajectory.read_tum(str(tmp_path / "port" / name))
        np.testing.assert_array_equal(g_st, w_st)
        err = np.linalg.norm(g_t - w_t, axis=1)
        assert err.max() <= POS_MAX_M, (name, err.max(), err.argmax())
        assert np.sqrt(np.mean(err ** 2)) <= POS_RMS_M, name


def test_run_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([a for a in ARGS if a not in ("--device", "cpu")]
                 + ["--out-dir", str(tmp_path)])


def test_save_state_then_resume(tmp_path, capsys):
    """``--save-state`` writes the reference's checkpoint (``.npz``
    appended when absent, the place database beside it); ``--resume``
    starts the next run from it: the saved state and counters are the
    restored system's before its first frame.  A missing checkpoint or one
    written with another config exits with 2, as the reference's."""
    ckpt = tmp_path / "state"
    first = {}
    assert cli.main(ARGS + ["--out-dir", str(tmp_path / "a"),
                            "--save-state", str(ckpt)], out=first) == 0
    assert (tmp_path / "state.npz").exists()
    assert (tmp_path / "state.npz.place.npz").exists() == (
        first["system"]._bow_db is not None)
    assert "checkpoint written to" in capsys.readouterr().err
    saved = first["system"]
    restored = SLAMSystem(saved.config, device="cpu")
    restored.restore(str(tmp_path / "state.npz"))
    for got, want in zip(convert.to_numpy(restored.map_state.landmarks)
                         .values(),
                         convert.to_numpy(saved.map_state.landmarks)
                         .values()):
        np.testing.assert_array_equal(got, want)
    second = {}
    assert cli.main(ARGS + ["--out-dir", str(tmp_path / "b"),
                            "--resume", str(ckpt)], out=second) == 0
    assert "resumed from" in capsys.readouterr().err
    st1, st2 = first["stats"], second["stats"]
    assert st2["frames"] == st1["frames"] + N
    assert st2["keyframes"] >= st1["keyframes"]
    kdb = second["system"].map_state.keyframes
    assert int(kdb.count) > int(saved.map_state.keyframes.count)
    assert cli.main(ARGS + ["--out-dir", str(tmp_path / "c"), "--resume",
                            str(tmp_path / "missing")]) == 2
    assert "not found" in capsys.readouterr().err
    other = [a if a != "160" else "192" for a in ARGS]
    assert cli.main(other + ["--out-dir", str(tmp_path / "d"), "--resume",
                             str(ckpt)]) == 2
    assert "config mismatch" in capsys.readouterr().err


def test_gt_detector_needs_the_dynamic_source(tmp_path):
    args = ["run", "--device", "cpu", "--source", "synthetic", "--detector",
            "gt", "--out-dir", str(tmp_path)]
    assert cli.main(args) == 2


def _rotations(rng, n):
    """Random rotations, plus half-turns about each axis (each branch of
    the quaternion extraction)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    r = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)
    flips = [np.diag(d) for d in ([1., -1, -1], [-1., 1, -1], [-1., -1, 1])]
    return np.concatenate([r, np.stack(flips)])


def test_tum_trajectory_files_match_reference(tmp_path):
    rng = np.random.default_rng(7)
    rs = _rotations(rng, 40)
    ts = rng.normal(size=(len(rs), 3))
    stamps = 1305031102.175304 + np.arange(len(rs)) / 30.0
    for r in rs:
        np.testing.assert_array_equal(trajectory.quat_from_mat(r),
                                      jtraj.quat_from_mat(r))
    trajectory.write_tum(str(tmp_path / "port.tum"), stamps,
                         list(zip(rs, ts)))
    jtraj.write_tum(str(tmp_path / "ref.tum"), stamps, list(zip(rs, ts)))
    text = (tmp_path / "port.tum").read_text()
    assert text == (tmp_path / "ref.tum").read_text()
    assert len(text.splitlines()) == len(rs)
    for got, want in zip(trajectory.read_tum(str(tmp_path / "port.tum")),
                         jtraj.read_tum(str(tmp_path / "port.tum"))):
        np.testing.assert_array_equal(got, want)
    gt = ts + rng.normal(scale=0.01, size=ts.shape)
    r, t = trajectory.umeyama_alignment(ts, gt)
    jr, jt, s = jtraj.umeyama_alignment(ts, gt)
    assert s == 1.0
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-12)
    assert abs(trajectory.ate_rmse(ts, gt) - jtraj.ate_rmse(ts, gt)) < 1e-12


def test_viz_outputs_match_reference(tmp_path):
    rng = np.random.default_rng(8)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    n_obs = rng.integers(0, 4, 50).astype(np.int32)
    txyz = rng.normal(size=(30, 3))
    for name, port_fn, ref_fn, args in (
            ("landmarks", viz.landmarks_to_ply, jviz.landmarks_to_ply,
             (xyz, n_obs)),
            ("trajectory", viz.trajectory_to_ply, jviz.trajectory_to_ply,
             (txyz,))):
        port_fn(str(tmp_path / f"{name}_port.ply"), *args)
        ref_fn(str(tmp_path / f"{name}_ref.ply"), *args)
        assert (tmp_path / f"{name}_port.ply").read_bytes() == \
            (tmp_path / f"{name}_ref.ply").read_bytes(), name
    gray = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    uv = rng.uniform(-5, 170, (40, 2)).astype(np.float32)
    np.testing.assert_array_equal(viz.annotate_features(gray, uv),
                                  jviz.annotate_features(gray, uv))


def test_tum_dataset_matches_reference(tmp_path):
    """A small TUM RGB-D directory: jittered rgb and depth stamps (one
    depth frame missing), 8-bit colour and 16-bit depth PNGs, a ground
    truth at its own rate."""
    import cv2
    rng = np.random.default_rng(9)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rgb_lines, depth_lines = ["# color images"], ["# depth maps"]
    for i in range(8):
        t = 100.0 + i / 30.0
        name = f"{t:.6f}.png"
        cv2.imwrite(str(tmp_path / "rgb" / name),
                    rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
        rgb_lines.append(f"{t:.6f} rgb/{name}")
        if i != 5:
            td = t + rng.uniform(-0.012, 0.012)
            dname = f"{td:.6f}.png"
            cv2.imwrite(str(tmp_path / "depth" / dname),
                        rng.integers(0, 20000, (24, 32), dtype=np.uint16))
            depth_lines.append(f"{td:.6f} depth/{dname}")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    gt_stamps = 99.9 + np.arange(40) / 100.0
    jtraj.write_tum(str(tmp_path / "groundtruth.txt"), gt_stamps,
                    list(zip(_rotations(rng, 37), rng.normal(size=(40, 3)))))
    got, want = tum.TUMDataset(str(tmp_path)), jtum.TUMDataset(str(tmp_path))
    assert got.pairs == want.pairs and len(got) == len(want) == 7
    np.testing.assert_array_equal(got.groundtruth, want.groundtruth)
    n = 0
    for g, w in zip(got.frames(limit=6), want.frames(limit=6)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        n += 1
    assert n == 6
    stamps = np.asarray([p[0] for p in got.pairs])
    np.testing.assert_array_equal(got.gt_positions_at(stamps),
                                  want.gt_positions_at(stamps))


def test_stage_timer_matches_reference(monkeypatch):
    """Both timers on one scripted clock: the reference's summary, and the
    port's median and 90th percentile of the samples after the first."""
    durations = [0.25, 0.01, 0.03, 0.02, 0.05, 0.04, 0.02, 0.06]
    clock = [0.0]

    def fake_clock():
        return clock[0]

    monkeypatch.setattr(time, "perf_counter", fake_clock)
    port, ref = profiling.StageTimer(), jprof.StageTimer()
    for i, d in enumerate(durations):
        for timer in (port, ref):
            for name, scale in (("frame", 1.0), ("detector", 0.5)):
                if name == "detector" and i % 3 == 1:
                    continue
                with timer.stage(name):
                    clock[0] += d * scale
    got, want = port.summary(), ref.summary()
    assert list(got) == list(want) == ["frame", "detector"]
    for name, entry in want.items():
        extra = {k: got[name].pop(k) for k in ("median_ms", "p90_ms")}
        assert got[name] == entry
        samples = np.asarray(port.samples_ms[name])
        assert len(samples) == entry["count"] - 1
        assert extra == dict(median_ms=round(float(np.median(samples)), 3),
                             p90_ms=round(float(np.percentile(samples, 90)),
                                          3))


@pytest.mark.parametrize("argv", [[], ["--preset", "tum_fr3"],
                                  ["--width", "320", "--height", "240"]])
def test_info_prints_the_reference_json(argv, capsys):
    assert cli.main(["info"] + argv) == 0
    got = capsys.readouterr().out
    assert jcli.main(["info"] + argv) == 0
    assert got == capsys.readouterr().out
    want = {"--preset": 640, "--width": 320}[argv[0]] if argv else 1280
    assert json.loads(got)["camera"]["width"] == want


def test_train_vocab_writes_what_the_reference_reads(tmp_path):
    from dynamic_visual_slam_tpu.place import bow as jbow
    from dynamic_visual_slam_tpu_torch.place import bow as pbow
    path = str(tmp_path / "voc.npz")
    d = {}
    assert cli.main(["train-vocab", "--device", "cpu", "--scenes", "2",
                     "--frames-per-scene", "2", "--per-frame", "100",
                     "--branching", "4", "--depth", "2", "--out", path],
                    out=d) == 0
    assert d["report"]["n_words"] == 16
    want = jbow.load_vocabulary(path)
    got = pbow.load_vocabulary(path, "cpu")
    assert (want.k, want.depth) == (4, 2)
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.word_weights.numpy(),
                                  np.asarray(want.word_weights))


def test_train_detector_writes_what_the_reference_reads(tmp_path):
    from dynamic_visual_slam_tpu.config import SLAMConfig as JConfig
    from dynamic_visual_slam_tpu.models.convert_ultralytics import \
        load_params as jload
    from dynamic_visual_slam_tpu.semantic.detector import YoloDetector as JDet
    from dynamic_visual_slam_tpu_torch.semantic.detector import YoloDetector
    path = str(tmp_path / "w.npz")
    d = {}
    assert cli.main(["train-detector", "--device", "cpu", "--steps", "6",
                     "--pool", "6", "--input-size", "64", "--train-batch",
                     "2", "--eval-images", "2", "--out", path], out=d) == 0
    rep = d["report"]
    assert rep["input_size"] == 64 and rep["steps"] == 6
    assert {"loss_first", "loss_last", "mean_best_iou", "recall",
            "precision"} <= set(rep)
    ref = jload(path)
    assert int(np.asarray(ref["input_size"], np.float32)) == 64
    np.testing.assert_array_equal(np.asarray(ref["heads"][2]["cls3"]["w"],
                                             np.float32),
                                  d["params"]["heads"][2]["cls3"]["w"])
    assert JDet(JConfig(), weights_path=path).size == 64
    assert YoloDetector(SLAMConfig(), weights_path=path,
                        device="cpu").size == 64


def test_run_with_a_random_init_detector(tmp_path, capsys):
    """``run --detector yolov8`` without ``--weights`` runs on random
    weights, as the reference's, and warns that its boxes are
    meaningless."""
    d = {}
    argv = ["run", "--device", "cpu", "--source", "dynamic", "--detector",
            "yolov8", "--width", "160", "--height", "120", "--frames", "3",
            "--out-dir", str(tmp_path)]
    assert cli.main(argv, out=d) == 0
    assert d["stats"]["frames"] == 3
    assert "random init" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["train-detector", "train-vocab"])
def test_train_commands_default_to_the_card(cmd, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([cmd, "--out", str(tmp_path / "x.npz")])


# --- the operator's tools: --trace, --serve, parity -----------------------

TOOL_ARGS = ["run", "--device", "cpu", "--source", "synthetic", "--width",
             "160", "--height", "120", "--frames", str(N), "--seed", "3"]
TIMING_KEYS = {"fps", "wall_s", "stages"}


class Recorder:
    """Stands in for ``utils/serve.LiveView`` in both packages: records
    what each update would publish."""

    made = []

    def __init__(self, port=8080, host="127.0.0.1"):
        self.port = port
        self.updates = []
        self.closed = False
        Recorder.made.append(self)

    def update(self, gray, uv, stats, traj_xyz=None, landmarks_xyz=None):
        self.updates.append((
            gray is None, None if uv is None else len(uv), sorted(stats),
            stats.get("frames"),
            None if traj_xyz is None else np.shape(traj_xyz),
            None if landmarks_xyz is None else np.shape(landmarks_xyz)))

    def close(self):
        self.closed = True


class FakeSystem:
    """A stand-in for either package's SLAMSystem with the surface their
    ``cli run`` and ``parity`` read (counters, trajectory, keypoint block,
    landmarks), so that both commands' own logic (live-view cadence, trace
    spans, the threaded transport, the parity report) runs on equal
    inputs at no cost."""

    enable_place_recognition = False

    def __init__(self, config, **kw):
        self.config = config
        self.stats = dict(frames=0, keyframes=0, ba_runs=0)
        self.trajectory = []
        n = config.map.max_obs_per_keyframe
        self.tracker_state = types.SimpleNamespace(prev=types.SimpleNamespace(
            mask=torch.arange(n) % 3 == 0, uv=torch.rand(n, 2) * 100))

    def process(self, gray, depth, timestamp, detections=None):
        i = len(self.trajectory)
        self.stats["frames"] += 1
        self.stats["keyframes"] += i % 5 == 0
        self.trajectory.append(types.SimpleNamespace(
            timestamp=float(timestamp), t_wc=np.array([0.01 * i, 0.002 * i,
                                                       0.001 * i * i]),
            tracking_ok=True, is_keyframe=i % 5 == 0))

    def process_batch(self, grays, depths, stamps, detections=None):
        for g, d, s in zip(grays, depths, stamps):
            self.process(g, d, s)

    def finalize(self):
        pass

    def frontend_trajectory(self):
        ts = np.stack([f.t_wc for f in self.trajectory])
        return (np.asarray([f.timestamp for f in self.trajectory]),
                np.broadcast_to(np.eye(3), (len(ts), 3, 3)), ts)

    def keyframe_trajectory(self):
        kf = [f for f in self.trajectory if f.is_keyframe]
        return (np.asarray([f.timestamp for f in kf]),
                np.broadcast_to(np.eye(3), (len(kf), 3, 3)),
                np.stack([f.t_wc for f in kf]))

    def landmarks_world(self):
        n = 10 * len(self.trajectory)
        return dict(xyz=np.ones((n, 3)), n_obs=np.full(n, 2),
                    category=np.zeros(n, np.int32))


def _both_clis(monkeypatch, tmp_path, argv):
    """The same argv through the reference's cli and the port's, each on
    FakeSystem, with Recorder as the live view → (reference, port) dicts of
    the views made and the trace events (name, phase)."""
    from dynamic_visual_slam_tpu.pipeline import slam as jslam
    from dynamic_visual_slam_tpu.utils import serve as jserve
    from dynamic_visual_slam_tpu_torch.utils import serve as pserve
    monkeypatch.setattr(jcli, "_enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jslam, "SLAMSystem", FakeSystem)
    monkeypatch.setattr(pslam, "SLAMSystem", FakeSystem)
    monkeypatch.setattr(jserve, "LiveView", Recorder)
    monkeypatch.setattr(pserve, "LiveView", Recorder)
    out = []
    for name, main in (("ref", lambda a: jcli.main(["--platform", "cpu"]
                                                   + a)),
                       ("port", lambda a: cli.main(a + ["--device", "cpu"]))):
        Recorder.made = []
        d = tmp_path / name
        assert main(argv + ["--out-dir", str(d)]) == 0
        trace = d / "trace.json"
        events = [(e["name"], e["ph"]) for e in json.loads(
            trace.read_text())["traceEvents"]] if trace.exists() else None
        out.append(dict(views=Recorder.made, events=events,
                        stats=json.loads((d / "stats.json").read_text())))
    return out


@pytest.mark.parametrize("mode", ["frames", "batch", "threaded"])
def test_trace_and_live_view_follow_the_reference(monkeypatch, tmp_path,
                                                  mode):
    """``--trace --serve 0 --serve-every 2`` through both packages' ``cli
    run`` on FakeSystem: the live view gets the same updates (per frame:
    every 2nd frame and once after the run, the landmark cloud every 6th
    refresh; under --batch after each batch; under --threaded only after
    the run) and closes; trace.json holds the same events (a "frame" pair a
    frame on the per-frame path, none under --batch and --threaded)."""
    extra = {"frames": [], "batch": ["--batch", "4"],
             "threaded": ["--threaded"]}[mode]
    ref, port = _both_clis(monkeypatch, tmp_path, TOOL_ARGS[:1] + TOOL_ARGS[
        3:] + extra + ["--trace", "--serve", "0", "--serve-every", "2"])
    assert len(port["views"]) == len(ref["views"]) == 1
    got, want = port["views"][0], ref["views"][0]
    assert got.updates == want.updates
    assert got.port == 0 and got.closed
    n_updates = {"frames": N // 2 + 1, "batch": N // 4 + 1,
                 "threaded": 1}[mode]
    assert len(got.updates) == n_updates
    assert got.updates[-1][0] and got.updates[-1][5] == (10 * N, 3)
    assert port["events"] == ref["events"]
    assert len(port["events"]) == (2 * N if mode == "frames" else 0)
    assert set(port["stats"]) == set(ref["stats"])


@pytest.mark.parametrize("tool", ["trace", "serve"])
def test_trace_and_serve_leave_the_run_unchanged(monkeypatch, tmp_path,
                                                 plain_run, tool):
    """The port's system through ``cli run`` with ``--trace`` (in
    trace.json a tree a frame: "frame", the ``process`` call inside it,
    the layers' stage spans inside that) or with ``--serve 0
    --serve-every 2`` (the reference's number of updates, N // 2 + 1):
    the trajectory file and the stats but for their timings equal the
    same command's without the flag."""
    from dynamic_visual_slam_tpu_torch.utils import serve as pserve
    monkeypatch.setattr(pserve, "LiveView", Recorder)
    Recorder.made = []
    extra = ["--trace"] if tool == "trace" else ["--serve", "0",
                                                 "--serve-every", "2"]
    out_dir = tmp_path / tool
    assert cli.main(TOOL_ARGS + extra + ["--out-dir", str(out_dir)]) == 0
    stats = json.loads((out_dir / "stats.json").read_text())
    want = plain_run["stats"]
    assert {k: v for k, v in stats.items() if k not in TIMING_KEYS} == \
        {k: v for k, v in want.items() if k not in TIMING_KEYS}
    assert set(stats) == set(want)
    assert (out_dir / "frontend.tum").read_text() == plain_run["tum"]
    if tool == "trace":
        doc = json.loads((out_dir / "trace.json").read_text())
        frames = _trees(doc["traceEvents"])
        # a tree a frame: "frame" at the root, the process call inside it,
        # the layers and their stages inside that
        assert [f[0] for f in frames] == ["frame"] * N
        assert all([k[0] for k in f[1]] == ["process"] for f in frames)
        names = [_subtree_names(f) for f in frames]
        assert all({"process", "track", "track.prep", "track.match",
                    "track.ransac.fm", "track.ransac.pnp", "extract",
                    "extract.pyramid", "extract.b1", "extract.b2",
                    "pipeline.read", "pipeline.emit"} <= n for n in names)
        assert sum("insert" in n for n in names) >= 1
        assert sum({"ba", "ba.optimize"} <= n for n in names) == \
            stats["ba_runs"]
        summary = doc["otherData"]
        assert summary["frames"] == N
        assert summary["spans"]["frame"]["calls"] == N
        assert summary["spans"]["process"]["calls"] == N
    else:
        assert not (out_dir / "trace.json").exists()
        (view,) = Recorder.made
        assert len(view.updates) == N // 2 + 1 and view.closed
        assert [u[3] for u in view.updates] == list(range(2, N + 1, 2)) + [N]


def _trees(events):
    """Chrome B/E events → [(name, children, begin ts, end ts)] of the
    roots, checking that they nest, each thread in time order."""
    roots, stack = [], []
    for e in events:
        if e["ph"] == "B":
            node = (e["name"], [], e["ts"], [None])
            (stack[-1][1] if stack else roots).append(node)
            stack.append(node)
        else:
            node = stack.pop()
            assert e["ph"] == "E" and e["name"] == node[0]
            assert e["ts"] >= node[2]
            node[3][0] = e["ts"]
    assert not stack
    return [(n, k, b, e[0]) for n, k, b, e in roots]


def _subtree_names(node):
    return {node[0]}.union(*(_subtree_names(k) for k in node[1]))


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("plain")
    assert cli.main(TOOL_ARGS + ["--out-dir", str(out_dir)]) == 0
    return dict(stats=json.loads((out_dir / "stats.json").read_text()),
                tum=(out_dir / "frontend.tum").read_text())


def test_threaded_takes_the_native_queue(monkeypatch, tmp_path):
    """``--threaded`` moves the frames through the native runtime's
    NativeQueue (built at first use), byte for byte."""
    from dynamic_visual_slam_tpu_torch import native
    from dynamic_visual_slam_tpu_torch.pipeline import runner
    queues, got = [], []
    make_queue = runner._make_queue

    def recorded(*a, **k):
        queues.append(make_queue(*a, **k))
        return queues[-1]

    class Seen(FakeSystem):
        def process(self, gray, depth, timestamp, detections=None):
            got.append(_pack_frame(gray, np.asarray(depth) / 1000.0))
            super().process(gray, depth, timestamp)

    monkeypatch.setattr(runner, "_make_queue", recorded)
    monkeypatch.setattr(pslam, "SLAMSystem", Seen)
    res = {}
    assert cli.main(TOOL_ARGS + ["--threaded", "--out-dir", str(tmp_path)],
                    out=res) == 0
    assert native.available(), native.error()
    assert len(queues) == 1 and isinstance(queues[0], native.NativeQueue)
    cfg = SLAMConfig().replace(camera=SLAMConfig().camera.scaled(160, 120))
    want = [_pack_frame(g, d) for g, d, *_ in synthetic.generate_sequence(
        cfg.camera, N, seed=3, depth_noise=0.004)]
    assert got == want
    assert res["stats"]["queue_dropped"] == 0


PARITY_ARGS = ["parity", "--width", "160", "--height", "120", "--frames",
               "20", "--seed", "0"]


def test_parity_reports_the_port_against_the_oracle(monkeypatch, tmp_path):
    """``parity --device cpu --seeds 2`` at 160x120 on 20 frames: the
    oracle's fields equal the port's OracleSLAM run directly on the same
    frames, the pipeline's (``tpu_`` keys) a direct SLAMSystem(
    enable_place_recognition=False) run, ATEs and ratio as the reference
    computes them; the report and its summary carry the reference's keys
    (the reference's command run on FakeSystem, whose oracle fields must
    equal the port's)."""
    from dynamic_visual_slam_tpu_torch.oracle.pipeline_cpu import OracleSLAM
    res = {}
    assert cli.main(PARITY_ARGS + ["--device", "cpu", "--seeds", "2",
                                   "--out-dir", str(tmp_path / "port")],
                    out=res) == 0
    report = json.loads((tmp_path / "port" / "parity.json").read_text())
    assert report == res["report"]
    assert [r["seed"] for r in report["runs"]] == [0, 1]
    cfg = SLAMConfig().replace(camera=SLAMConfig().camera.scaled(160, 120))
    frames = list(synthetic.generate_sequence(cfg.camera, 20, seed=0,
                                              depth_noise=0.004))
    gt_t = np.stack([f[3] for f in frames])
    slam = SLAMSystem(cfg, enable_place_recognition=False, device="cpu")
    orc = OracleSLAM(cfg, run_ba=True)
    for g, d, _, _, ts in frames:
        slam.process(g, d, ts)
        orc.process(g, d, ts)
    slam.finalize()
    tpu_t, orc_t = slam.frontend_trajectory()[2], orc.frontend_trajectory()[2]
    run = report["runs"][0]
    tpu_ate = trajectory.ate_rmse(tpu_t, gt_t)
    orc_ate = trajectory.ate_rmse(orc_t, gt_t)
    assert run == dict(
        source="synthetic(seed=0)", frames=20,
        tpu_keyframes=slam.stats["keyframes"],
        oracle_keyframes=len(orc.keyframes),
        oracle_ba_rounds=orc.ba_rounds,
        tpu_vs_oracle_ate_m=round(trajectory.ate_rmse(tpu_t, orc_t), 5),
        tpu_ate_m=round(tpu_ate, 5), oracle_ate_m=round(orc_ate, 5),
        ate_ratio=round(tpu_ate / orc_ate, 4), seed=0)
    # the reference's report on the same frames, its pipeline FakeSystem
    from dynamic_visual_slam_tpu.pipeline import slam as jslam
    monkeypatch.setattr(jcli, "_enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jslam, "SLAMSystem", FakeSystem)
    assert jcli.main(["--platform", "cpu"] + PARITY_ARGS + [
        "--seeds", "2", "--out-dir", str(tmp_path / "ref")]) == 0
    ref = json.loads((tmp_path / "ref" / "parity.json").read_text())
    assert set(ref) == set(report) == {"runs", "summary"}
    assert set(ref["summary"]) == set(report["summary"])
    assert report["summary"]["n"] == 2
    assert report["summary"]["resolution"] == "160x120"
    for r, p in zip(ref["runs"], report["runs"]):
        assert set(r) == set(p)
        for key in ("source", "frames", "seed", "oracle_keyframes",
                    "oracle_ba_rounds", "oracle_ate_m"):
            assert r[key] == p[key], key


def test_parity_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(PARITY_ARGS + ["--out-dir", str(tmp_path)])
