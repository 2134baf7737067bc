"""Cells that exist only in the tests: each of the four entries' mixes,
cut to 160x120 and a few frames, added the way a later change adds a cell,
by files alone: a ``BENCHMARK.json`` beside copies of the benchmark's
folders, plus a configuration, four traffic mixes, their limits and one
per-layer metric of its own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchlib import spec

TINY_CAMERA = dict(width=160, height=120, fx=130.0, fy=130.0, cx=79.5,
                   cy=59.5)
LIMITS = {"orb_mismatch": 0.0, "pose_gap_mm": 1e-6, "rot_gap_deg": 1e-6,
          "flag_mismatch": 0, "ba_cost_gap": 1e-9, "ba_pose_gap_mm": 1e-6,
          "det_logit_gap": 0.0, "det_box_gap_px": 0.0,
          "orb_indep_mismatch": 0.0, "map_xyz_gap_mm": 1e-6,
          "loop_gap_mm": 1e-6, "loop_rot_gap_deg": 1e-6}
TINY = ("tiny.replay", "tiny.live", "tiny.dynamic", "tiny.fleet")
REQUIRE = ["orb_mismatch", "pose_gap_mm", "rot_gap_deg", "flag_mismatch",
           "ba_cost_gap", "ba_pose_gap_mm", "orb_indep_mismatch",
           "map_xyz_gap_mm"]


def make(root: Path) -> Path:
    """Writes the fixture under ``root``; → its ``BENCHMARK.json``."""
    bench = root / "benchmark"
    for d in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(spec.BENCH_DIR / d, bench / d)
    (bench / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "source": "the tests' own 160x120 camera",
        "preset": None,
        # BA every 0.3 s of input, so a short run reaches a round
        "overrides": {"camera": TINY_CAMERA, "ba": {"period_s": 0.3}},
        "assumed": [], "reduced": ["camera"]}))
    (bench / "traffic" / "tinyreplay.json").write_text(json.dumps({
        "entry": "process_batch", "frames": 12, "cycle": "pingpong",
        "trajectory": "orbit",
        "gray": "uint8", "depth": "uint16_mm", "batch": 4, "sync_every": 2,
        "place_recognition": False, "warmup_steps": 3,
        "warmup_ba_rounds": 1, "warmup_max_steps": 20, "profile_steps": 1,
        "check": {"steps": 2, "from": 0, "span": 3, "ba": 1,
                  "require": REQUIRE}}))
    (bench / "traffic" / "tinylive.json").write_text(json.dumps({
        "entry": "process", "frames": 12, "trajectory": "loop",
        "radius": 0.35, "gray": "uint8", "depth": "uint16_mm",
        "sync_every": 1, "place_recognition": False, "warmup_steps": 10,
        "warmup_ba_rounds": 1, "warmup_max_steps": 40, "profile_steps": 1,
        "check": {"steps": 2, "from": 0, "span": 3, "ba": 1,
                  "require": REQUIRE}}))
    (bench / "traffic" / "tinydynamic.json").write_text(json.dumps({
        "entry": "process", "frames": 12, "trajectory": "loop",
        "radius": 0.35, "walkers": 2, "gray": "float32",
        "depth": "float32_m", "rgb": True, "sync_every": 1,
        "place_recognition": True, "vocab": "assets/orbvoc_synth.npz",
        "detector": {"weights": "assets/yolov8n_synth.npz"},
        "warmup_steps": 10, "warmup_ba_rounds": 1, "warmup_max_steps": 40,
        "profile_steps": 1,
        # the walkers break tracking at this size: no keyframe is sure
        "check": {"steps": 2, "from": 0, "span": 3, "ba": 1, "verify": 1,
                  "require": [r for r in REQUIRE if r != "map_xyz_gap_mm"]
                  + ["det_logit_gap", "det_box_gap_px"]}}))
    (bench / "traffic" / "tinyfleet.json").write_text(json.dumps({
        "entry": "step_batch", "frames": 12, "cycle": "pingpong",
        "trajectory": "orbit",
        "gray": "uint8", "depth": "uint16_mm", "streams": 2, "steps": 4,
        "warmup_steps": 1, "profile_steps": 1,
        "check": {"steps": 1, "from": 0, "span": 2, "scan_steps": 2,
                  "ba": 1, "require": REQUIRE}}))
    for w in TINY:
        (bench / "checks" / f"{w}.json").write_text(json.dumps(
            {"limits": LIMITS}))
    (bench / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return ctx['span_frames'] or None\n")
    doc = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny", "source": "the tests",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": ["camera"], "why": "tests"})
    doc["workloads"] += [
        {"name": w, "config": "tiny", "traffic": "tiny" + w.split(".")[1],
         "chips": 1, "why": "tests"} for w in TINY]
    doc["per_layer"].append(
        {"name": "frames_traced", "unit": "frames", "better": "higher",
         "source": "program_span", "layer": "orchestration",
         "moves": "fps", "workloads": ["tiny.replay"]})
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(doc))
    return path


def load(root: Path, workload: str):
    return spec.load_cell(workload, make(root), root / "benchmark")
