"""The port's 720p loop-closure run (``dynamic_visual_slam_tpu_torch/
evaluation/loop720p.py``) against the reference's ``scripts/loop720p.py``,
on the CPU at a small camera.

- The fixture: the port's frames (rendered in the process and in two
  spawned workers) equal, bit for bit, the reference's construction
  (``loop720p.py:84-105``) written out here with the reference's
  ``synthetic`` module, noise on.
- A run at 160x120, 2 orbits of 24 frames, batches of 8: the record has
  the reference's keys (those of the committed ``loop720p.json``, plus
  ``noise_std``, which ``loop720p.py`` writes and the artifact predates),
  and the verdict is the reference's contract (``loop720p.py:165-170``).
"""

import dataclasses as dc
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.config import SLAMConfig as RefSLAMConfig
from dynamic_visual_slam_tpu.io import synthetic as ref_synthetic
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.evaluation import loop720p

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _reference_frames(cam, n_orbit, orbits, drift, noise):
    """loop720p.py's construction, line for line."""
    scene = ref_synthetic.SyntheticScene(cam, seed=5)
    poses = []
    for k in range(orbits):
        poses += ref_synthetic.loop_trajectory(
            n_orbit, radius=0.35 - 0.01 * (k % 2))
    frames = []
    rng = np.random.default_rng(11)
    for i, (r, t) in enumerate(poses):
        gray, depth = scene.render(r, t)
        scale = 1.0 + drift * i / len(poses)
        g = gray.astype(np.float32)
        if noise > 0.0:
            g = g + rng.normal(0.0, noise, g.shape)
        frames.append((np.clip(g, 0, 255).astype(np.uint8),
                       (depth * scale * 1000.0).astype(np.uint16), t))
    return frames


@pytest.mark.parametrize("workers", [0, 2])
def test_fixture_equals_the_references_construction(workers):
    ref = RefSLAMConfig()
    ref_cfg = ref.replace(camera=ref.camera.scaled(96, 72))
    ref_cfg = ref_cfg.replace(depth=dc.replace(ref_cfg.depth, max_depth=6.0))
    cfg = loop720p.fixture_config(SLAMConfig().replace(
        camera=SLAMConfig().camera.scaled(96, 72)))
    assert cfg.to_dict() == ref_cfg.to_dict()
    want = _reference_frames(ref_cfg.camera, 5, 3, 0.35, 2.0)
    got = loop720p.fixture(cfg.camera, 5, 3, 0.35, 2.0, workers=workers)
    assert len(got) == len(want) == 15
    for (g, d, t), (wg, wd, wt) in zip(got, want):
        assert g.dtype == wg.dtype and d.dtype == wd.dtype
        np.testing.assert_array_equal(g, wg)
        np.testing.assert_array_equal(d, wd)
        np.testing.assert_array_equal(t, wt)


def test_small_run_gives_the_references_record():
    base = SLAMConfig()
    cfg = loop720p.fixture_config(base.replace(
        camera=base.camera.scaled(160, 120)))
    frames = loop720p.fixture(cfg.camera, 24, 2, 0.35, 0.0)
    res = loop720p.evaluate(cfg, frames, batch=8, loop_pgo=True,
                            device="cpu", drift=0.35, noise=0.0,
                            vocab_path=str(loop720p.VOCAB))
    rec = res["record"]
    want = json.loads((ROOT / "loop720p.json").read_text())
    assert set(rec) == set(want) | {"noise_std"}
    json.dumps(rec)
    assert rec["platform"] == "cpu" and rec["frames"] == 48
    assert rec["resolution"] == "160x120" and rec["scheme"] == "pgo"
    assert rec["config"] == want["config"]
    assert res["passed"] == (rec["loops_applied"] >= 1 and
                             rec["ate_with_loops_m"] <= max(
                                 1.5 * rec["ate_without_loops_m"], 0.2))
