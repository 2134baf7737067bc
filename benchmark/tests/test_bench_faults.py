"""Whole runs of the harness on the CPU (the look for a card skipped) at a
tiny size: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault the cells can
have.  (One chip only: there is no exchange between chips to leave out.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchlib import cell as cell_mod
from fixture_cell import load

SEED = 3_000_000_017


def _run(tmp_path, workload="tiny.replay", traced=False):
    cell = load(tmp_path, workload)
    torch.manual_seed(0)
    return cell_mod.run(cell, SEED, 1.0, traced, torch.device("cpu"),
                        time.time(), workers=1)


@pytest.fixture
def port():
    from dynamic_visual_slam_tpu_torch.frontend import orb, tracker
    from dynamic_visual_slam_tpu_torch.pipeline import slam
    return orb, tracker, slam


@pytest.mark.parametrize("workload", ["tiny.replay", "tiny.live",
                                      "tiny.dynamic", "tiny.fleet"])
def test_sound_run_is_correct(tmp_path, workload):
    res = _run(tmp_path, workload)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) >= {"fps", "setup_s"}


def test_traced_run_reads_its_per_layer_metrics(tmp_path):
    res = _run(tmp_path, traced=True)
    assert res["correct"], res["check"]
    assert "frames_traced" in res["metrics"]        # the fixture's reader
    assert res["metrics"]["track_ms"]["value"] > 0
    assert res["metrics"]["ba_ms"]["value"] > 0       # a round in the spans
    assert 0 <= res["metrics"]["tracking_ok_pct"]["value"] <= 100
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_step_that_returns_its_state_unchanged(tmp_path, port, monkeypatch):
    _, tracker, _ = port
    real = tracker.track_batch

    def stale(cfg, state, *a, **kw):
        return state, real(cfg, state, *a, **kw)[1]
    monkeypatch.setattr(tracker, "track_batch", stale)
    res = _run(tmp_path)
    assert not res["correct"]
    assert res["check"]["pose_gap_mm"]["value"] > \
        res["check"]["pose_gap_mm"]["limit"]


def test_half_of_the_batch_left_out(tmp_path, port, monkeypatch):
    _, _, slam = port
    real = slam.SLAMSystem.process_batch

    def half(self, grays, depths, stamps, detections=None):
        b = len(stamps) // 2
        return real(self, grays[:b], depths[:b], stamps[:b])
    monkeypatch.setattr(slam.SLAMSystem, "process_batch", half)
    assert not _run(tmp_path)["correct"]


def test_keypoint_altered_where_it_is_produced(tmp_path, port, monkeypatch):
    orb, _, _ = port
    real = orb.extract_batch

    def flipped(imgs, cfg):
        kps = real(imgs, cfg)
        bits = kps.desc_bits.clone()
        bits[..., 0, 0] ^= 1
        return kps._replace(desc_bits=bits)
    monkeypatch.setattr(orb, "extract_batch", flipped)
    res = _run(tmp_path)
    assert not res["correct"]
    assert res["check"]["orb_mismatch"]["value"] > 0


def test_pose_altered_where_it_is_produced(tmp_path, port, monkeypatch):
    _, tracker, _ = port
    real = tracker.track_step

    def moved(*a, **kw):
        state, out = real(*a, **kw)
        return state, out._replace(t_wc=out.t_wc + 1e-3)
    monkeypatch.setattr(tracker, "track_step", moved)
    res = _run(tmp_path, "tiny.live")
    assert not res["correct"]


def test_ba_round_altered_where_it_is_produced(tmp_path, port, monkeypatch):
    _, _, slam = port
    real = slam.run_ba_fb

    def worse(*a, **kw):
        m, t, res = real(*a, **kw)
        return m, t, res._replace(final_cost=res.final_cost * 1.01)
    monkeypatch.setattr(slam, "run_ba_fb", worse)
    res = _run(tmp_path)
    assert not res["correct"]
    assert res["check"]["ba_cost_gap"]["value"] > 1e-3


def test_detection_altered_where_it_is_produced(tmp_path, monkeypatch):
    from dynamic_visual_slam_tpu_torch.models import yolov8
    real = yolov8.detect

    def shifted(*a, **kw):
        raw = real(*a, **kw)
        return raw._replace(boxes=raw.boxes + 0.5)
    monkeypatch.setattr(yolov8, "detect", shifted)
    res = _run(tmp_path, "tiny.dynamic")
    assert not res["correct"]


def test_fleet_streams_left_out(tmp_path, monkeypatch):
    """Every stream but the first keeps its state: half the fleet's work
    left out."""
    from dynamic_visual_slam_tpu_torch.core import containers
    from dynamic_visual_slam_tpu_torch.frontend import tracker
    real = tracker.track_streams

    def first_only(cfg, state, *a, **kw):
        new, out = real(cfg, state, *a, **kw)
        keep = lambda n, o: torch.cat([n[:1], o[1:]])  # noqa: E731
        return containers.tree_map2(keep, new, state), out
    monkeypatch.setattr(tracker, "track_streams", first_only)
    res = _run(tmp_path, "tiny.fleet")
    assert not res["correct"]


def test_insert_altered_where_it_is_produced(tmp_path, monkeypatch):
    """A keyframe insert that moves the landmarks it writes, and one that
    miscounts their observations."""
    from dynamic_visual_slam_tpu_torch.backend import mapping
    real = mapping.insert_keyframe

    def moved(*a, **kw):
        state, stats = real(*a, **kw)
        lm = state.landmarks
        return state._replace(landmarks=lm._replace(
            xyz=lm.xyz + 1e-3 * lm.active[:, None])), stats
    monkeypatch.setattr(mapping, "insert_keyframe", moved)
    res = _run(tmp_path / "moved")
    assert not res["correct"]
    assert res["check"]["map_xyz_gap_mm"]["value"] > 0.5

    def miscounted(*a, **kw):
        state, stats = real(*a, **kw)
        lm = state.landmarks
        return state._replace(landmarks=lm._replace(
            n_obs=lm.n_obs + lm.active.to(lm.n_obs.dtype))), stats
    monkeypatch.setattr(mapping, "insert_keyframe", miscounted)
    res = _run(tmp_path / "miscounted")
    assert not res["correct"]
    assert res["check"]["flag_mismatch"]["value"] > 0


def _force_a_loop(monkeypatch, slam):
    """From the window's second call on, each ``process`` applies a loop
    correction as a verified loop would: the newest keyframe's pose
    moved 20 mm, the oldest keyframe of the ring the candidate.  It goes
    through the module's ``apply_loop_pgo``, as the system's own loops do."""
    from dynamic_visual_slam_tpu_torch.pipeline.slam import _ring_seq
    real = slam.SLAMSystem.process
    calls = [0]

    def process(self, *a, **kw):
        out = real(self, *a, **kw)
        calls[0] += 1
        kdb = self.map_state.keyframes
        if calls[0] > 12 and int(kdb.count) >= 2:
            seq = _ring_seq(kdb, self.config.map.max_keyframes)
            act = kdb.active
            newest = int(seq[act].max())
            slot = int(torch.nonzero(act & (seq == newest))[0])
            self.tracker_state, self.map_state = slam.apply_loop_pgo(
                self.config, self.tracker_state, self.map_state,
                kdb.q[slot], kdb.t[slot] + 0.02, int(seq[act].min()), newest)
        return out
    monkeypatch.setattr(slam.SLAMSystem, "process", process)


def test_loop_correction_compared(tmp_path, port, monkeypatch):
    _, _, slam = port
    _force_a_loop(monkeypatch, slam)
    res = _run(tmp_path, "tiny.live")
    assert res["correct"], res["check"]
    assert "loop_gap_mm" in res["check"]


def test_loop_correction_altered_where_it_is_produced(tmp_path, port,
                                                      monkeypatch):
    _, _, slam = port
    real = slam.apply_loop_pgo

    def off(*a, **kw):
        t, m = real(*a, **kw)
        return t._replace(t_wc=t.t_wc + 1e-3), m
    monkeypatch.setattr(slam, "apply_loop_pgo", off)
    _force_a_loop(monkeypatch, slam)
    res = _run(tmp_path, "tiny.live")
    assert not res["correct"]
    assert res["check"]["loop_gap_mm"]["value"] > 0.5


def test_fault_shared_with_the_frozen_copy(tmp_path, monkeypatch):
    """A FAST score off by one in the port and in its frozen copy alike:
    the copy agrees, the independent transcription does not."""
    from dynamic_visual_slam_tpu_torch.frontend import orb as port_orb
    from slamref.frontend import orb as ref_orb
    for mod in (port_orb, ref_orb):
        real = mod.fast_score_batch
        monkeypatch.setattr(mod, "fast_score_batch",
                            lambda lv, real=real: [s + 1 for s in real(lv)])
    res = _run(tmp_path)
    assert not res["correct"]
    assert res["check"]["orb_mismatch"]["value"] == 0
    assert res["check"]["orb_indep_mismatch"]["value"] > 0.5
