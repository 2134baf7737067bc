"""The port's parity sweep (``dynamic_visual_slam_tpu_torch/evaluation/
parity_sweep.py``) against the reference's ``scripts/parity_sweep.py``.

- The aggregation: fed the seed runs of each of the 12 committed
  ``parity_sweep/cell_*.json``, ``summarize`` gives that cell's ratio mean,
  median and worst and both mean ATEs exactly (the reference's rounding).
- The cache key: ``cfg_fingerprint`` equals the reference script's
  ``_cfg_fingerprint`` on the reference's ``SLAMConfig`` at 424x240 and
  640x480 (neither is the fingerprint the committed oracle cache was
  written under: that cache holds an older configuration's trajectories).
- End to end on the CPU at 160x120, 2 seeds, ``--frames-list 8 16``, both
  modes: the reference's file names and key sets (plus ``device`` and
  ``power_limit``); the f8 cell, sliced from the 16-frame run, has the
  ATE of an 8-frame run; a second call is served by both caches and runs
  no pipeline; the oracle's fields equal those of the reference's
  ``OracleSLAM`` on the same frames.  Tolerance: none, every figure is
  compared after the reference's rounding.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.config import SLAMConfig as RefSLAMConfig
from dynamic_visual_slam_tpu.io import synthetic as ref_synthetic
from dynamic_visual_slam_tpu.io import trajectory as ref_trajectory
from dynamic_visual_slam_tpu.oracle.pipeline_cpu import \
    OracleSLAM as RefOracleSLAM
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.evaluation import parity_sweep
from dynamic_visual_slam_tpu_torch.io import synthetic, trajectory

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
REF_DIR = ROOT / "parity_sweep"
CELLS = sorted(REF_DIR.glob("cell_*.json"))
SUMMARY = ("ate_ratio_mean", "ate_ratio_median", "ate_ratio_worst",
           "tpu_ate_mean_m", "oracle_ate_mean_m")
W, H, SEEDS, FRAMES = 160, 120, 2, (8, 16)


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "ref_parity_sweep", ROOT / "scripts" / "parity_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep(out: Path) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = parity_sweep.main([
            "--device", "cpu", "--res-list", f"{W}x{H}", "--seeds",
            str(SEEDS), "--frames-list", *map(str, FRAMES), "--out",
            str(out)])
    assert rc == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep")
    _sweep(out)
    return out


def test_twelve_committed_cells():
    assert len(CELLS) == 12


@pytest.mark.parametrize("path", CELLS, ids=[p.stem for p in CELLS])
def test_aggregation_reproduces_the_committed_cell(path):
    cell = json.loads(path.read_text())
    got = parity_sweep.summarize(cell["runs"])
    assert got == {k: cell[k] for k in SUMMARY}


@pytest.mark.parametrize("res", [(424, 240), (640, 480)])
def test_fingerprint_is_the_references(res):
    ref = RefSLAMConfig()
    ref_cfg = ref.replace(camera=ref.camera.scaled(*res))
    port = SLAMConfig()
    port_cfg = port.replace(camera=port.camera.scaled(*res))
    want = _reference_script()._cfg_fingerprint(ref_cfg)
    assert parity_sweep.cfg_fingerprint(port_cfg) == want
    cached = {p.stem.rsplit("_", 1)[1] for p in
              (REF_DIR / "oracle_cache").glob(f"oracle_{res[0]}x{res[1]}_*")}
    assert len(cached) == 1 and want not in cached


def test_out_under_the_references_directory_is_refused():
    with pytest.raises(ValueError, match="parity_sweep"):
        parity_sweep.main(["--device", "cpu", "--out",
                           str(REF_DIR / "port")])


def test_files_and_keys_are_the_references(swept):
    ref_cell = json.loads((REF_DIR / "cell_f120_640x480_anchored.json")
                          .read_text())
    ref_sweep = json.loads((REF_DIR / "sweep.json").read_text())
    names = {f"cell_f{n}_{W}x{H}_{m}.json" for n in FRAMES
             for m in ("anchored", "frame2frame")}
    assert {p.name for p in swept.glob("cell_*.json")} == names
    extra = {"device", "power_limit"}
    for name in names:
        cell = json.loads((swept / name).read_text())
        assert set(cell) == set(ref_cell) | extra
        assert cell["platform"] == "cpu" and cell["device"] == "cpu"
        assert cell["seeds"] == SEEDS and len(cell["runs"]) == SEEDS
        for run in cell["runs"]:
            assert set(run) == set(ref_cell["runs"][0])
    sweep = json.loads((swept / "sweep.json").read_text())
    assert set(sweep) == set(ref_sweep)
    assert set(sweep["summary"]) == set(ref_sweep["summary"]) | extra
    assert set(sweep["summary"]["cells"][0]) \
        == set(ref_sweep["summary"]["cells"][0]) | extra
    assert len(sweep["cells"]) == 4
    fps = {m: parity_sweep.cfg_fingerprint(parity_sweep.mode_config(
        _cfg(), m)) for m in ("anchored", "frame2frame")}
    assert sorted(p.name for p in (swept / "runs").iterdir()) == sorted(
        f"run_{W}x{H}_seed{s}_{m}_f16_{fp}.npz"
        for s in range(SEEDS) for m, fp in fps.items())


def _cfg():
    base = SLAMConfig()
    return base.replace(camera=base.camera.scaled(W, H))


def test_a_sliced_cell_equals_a_shorter_run(swept):
    cfg0 = _cfg()
    frames = list(synthetic.generate_sequence(
        cfg0.camera, FRAMES[0], seed=0, depth_noise=parity_sweep.DEPTH_NOISE))
    gt = np.stack([f[3] for f in frames])
    for mode in ("anchored", "frame2frame"):
        cell = json.loads((swept / f"cell_f{FRAMES[0]}_{W}x{H}_{mode}.json")
                          .read_text())
        t, kf = parity_sweep.run_pipeline_full(
            parity_sweep.mode_config(cfg0, mode), frames, 8, "cpu")
        run = cell["runs"][0]
        assert run["tpu_ate_m"] == round(float(trajectory.ate_rmse(t, gt)),
                                         5)
        assert run["tpu_keyframes"] == int(kf[-1])


def test_a_second_call_reads_both_caches(swept, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a pipeline ran on a cached sweep")
    monkeypatch.setattr(parity_sweep, "SLAMSystem", refuse)
    monkeypatch.setattr(parity_sweep, "OracleSLAM", refuse)
    before = {p.name: json.loads(p.read_text())
              for p in swept.glob("cell_*.json")}
    log = _sweep(swept)
    assert "(fresh)" not in log and log.count("(cache)") == 3 * SEEDS
    for name, cell in before.items():
        assert json.loads((swept / name).read_text()) == cell


def test_oracle_fields_are_the_references(swept):
    ref = RefSLAMConfig()
    cfg = ref.replace(camera=ref.camera.scaled(W, H))
    for seed in range(SEEDS):
        frames = list(ref_synthetic.generate_sequence(
            cfg.camera, FRAMES[-1], seed=seed, depth_noise=0.004))
        gt = np.stack([f[3] for f in frames])
        orc = RefOracleSLAM(cfg, run_ba=True)
        kf, ba = [], []
        for gray, depth, _, _, ts in frames:
            orc.process(gray, depth, ts)
            kf.append(len(orc.keyframes))
            ba.append(orc.ba_rounds)
        _, _, t = orc.frontend_trajectory()
        for n in FRAMES:
            run = json.loads((swept / f"cell_f{n}_{W}x{H}_anchored.json")
                             .read_text())["runs"][seed]
            assert run["oracle_ate_m"] == round(float(
                ref_trajectory.ate_rmse(t[:n], gt[:n])), 5)
            assert run["oracle_keyframes"] == kf[n - 1]
            assert run["oracle_ba_rounds"] == ba[n - 1]
