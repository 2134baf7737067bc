"""The port's CPU oracles (``dynamic_visual_slam_tpu_torch/oracle``: the f64
scipy BA and the OpenCV pipeline behind ``cli parity``) against the
reference package's, and the port's BA against its oracle.

- ``ba_cpu.solve`` equals the reference's bit for bit on the problems of
  ``tests/test_ba_oracle.py`` (``make_problem`` seeds 10 and 11).
- ``backend/ba.optimize`` of the port on the CPU against the port's oracle
  on the same problems, with ``test_matches_f64_oracle_l2``'s and
  ``_huber``'s bounds (cost within 1 %, camera centres within 1.5 mm /
  5 mm after the gauge alignment, rotations within 0.02 / 0.05 degrees,
  landmarks within 1 mm median and 1 cm at worst).
- ``chip_smoke.ba_window_problem``, the copy of ``make_problem`` on the
  port's Lie helpers that the card's parity phase solves at the shipped
  scale, gives ``make_problem``'s problem within two float32 units in the
  last place, with the same observation mask.
- ``OracleSLAM`` equals the reference's on 64 frames at 424x240, seed 0
  (trajectory, keyframes and BA rounds after every frame; the oracle's
  first BA round fires at frame 61), and reproduces the first 64 rows of
  the seed-0 oracle trajectory cached in ``parity_sweep/oracle_cache``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from dynamic_visual_slam_tpu.config import SLAMConfig as JSLAMConfig
from dynamic_visual_slam_tpu.oracle import ba_cpu as jba_cpu
from dynamic_visual_slam_tpu.oracle.pipeline_cpu import OracleSLAM as JOracle
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.backend import ba as pba
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.oracle import ba_cpu
from dynamic_visual_slam_tpu_torch.oracle.pipeline_cpu import OracleSLAM
from tests.test_ba import K, make_problem
from tests.test_ba_oracle import CFG_NOPRIOR
from torch_parity import to_numpy_tree

torch.set_num_threads(2)
N_FRAMES = 64
CACHE = Path(__file__).resolve().parent.parent / "parity_sweep" / \
    "oracle_cache" / "oracle_424x240_seed0_f480_59748861b52657b3.npz"
PROBLEMS = {  # tests/test_ba_oracle.py's _solve_both calls
    "l2": dict(seed=10, noise_px=0.05, drop_frac=0.2),
    "huber": dict(seed=11, noise_px=0.3, outlier_frac=0.10, pose_pert=0.005),
}
BOUNDS = {"l2": dict(centre_m=1.5e-3, rot_deg=0.02),
          "huber": dict(centre_m=5e-3, rot_deg=0.05)}
PCFG = SLAMConfig.preset("tum_fr3")
PCFG_NOPRIOR = dataclasses.replace(
    PCFG.ba, pose_prior_sigma_rot=0.0, pose_prior_sigma_t=0.0,
    point_prior_sigma=0.0, max_iterations=40)


def _problem(case):
    kw = dict(PROBLEMS[case])
    problem, _ = make_problem(kw.pop("seed"), w=5, l=64, **kw)
    return to_numpy_tree(problem)


def _solve(mod, p):
    return mod.solve(p["q_wc"], p["t_wc"], p["xyz"], p["uv"], p["valid"],
                     float(K.fx), float(K.fy), float(K.cx), float(K.cy),
                     sigma=PCFG.ba.sigma_px, huber_delta=PCFG.ba.huber_delta)


@pytest.mark.parametrize("case", ["l2", "huber"])
def test_ba_oracle_equals_the_reference(case):
    p = _problem(case)
    got, want = _solve(ba_cpu, p), _solve(jba_cpu, p)
    assert got.cost == want.cost and got.n_irls == want.n_irls
    assert got.ok == want.ok
    for name in ("q_wc", "t_wc", "xyz"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    if case == "huber":
        assert got.n_irls > 1         # the robust loss was active


@pytest.mark.parametrize("case", ["l2", "huber"])
def test_port_ba_matches_the_oracle(case):
    p = _problem(case)
    assert CFG_NOPRIOR.max_iterations == PCFG_NOPRIOR.max_iterations
    res = pba.optimize(Intrinsics.from_config(PCFG.camera),
                       convert.ba_problem(p), PCFG_NOPRIOR)
    orc = _solve(ba_cpu, p)
    rel = abs(float(res.final_cost) - orc.cost) / orc.cost
    assert rel < 0.01, (float(res.final_cost), orc.cost)
    t_diff, ang = chip_smoke.gauge_aligned_diff(res, orc)
    assert t_diff.max() < BOUNDS[case]["centre_m"], t_diff
    assert ang.max() < BOUNDS[case]["rot_deg"], ang
    if case == "l2":
        assert float(res.final_cost) > orc.cost * 0.99
        c0 = orc.t_wc[0]
        x_est = res.xyz.numpy().astype(np.float64) - c0
        s = float(np.sum(x_est * (orc.xyz - c0)) / np.sum(x_est * x_est))
        pt = np.linalg.norm(s * x_est + c0 - orc.xyz, axis=1)
        assert np.median(pt) < 1e-3 and pt.max() < 1e-2


@pytest.mark.parametrize("seed,kw", [
    (20, dict(w=8, l=512, noise_px=0.2, drop_frac=0.15)),
    (11, dict(w=5, l=64, noise_px=0.3, outlier_frac=0.10, pose_pert=0.005))])
def test_chip_smokes_problem_is_make_problem(seed, kw):
    got, k = chip_smoke.ba_window_problem(seed, **kw)
    want = to_numpy_tree(make_problem(seed, **kw)[0])
    assert (k.fx, k.fy, k.cx, k.cy) == (K.fx, K.fy, K.cx, K.cy)
    assert set(got) == set(want)
    for name in want:
        # float32: the two packages' so3_exp and quat_to_mat may round the
        # last bit apart; within two units in the last place
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], rtol=2.4e-7,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got["valid"], want["valid"])


@pytest.fixture(scope="module")
def frames_424():
    cam = SLAMConfig().camera.scaled(424, 240)
    return list(synthetic.generate_sequence(cam, N_FRAMES, seed=0,
                                            depth_noise=0.004))


def _oracle_run(cls, cfg, frames):
    orc = cls(cfg, run_ba=True)
    kf_cum, ba_cum = [], []
    for gray, depth, _, _, ts in frames:
        orc.process(gray, depth, ts)
        kf_cum.append(len(orc.keyframes))
        ba_cum.append(orc.ba_rounds)
    stamps, rs, ts = orc.frontend_trajectory()
    return dict(stamps=stamps, r=rs, t=ts, kf_cum=np.asarray(kf_cum),
                ba_cum=np.asarray(ba_cum),
                kf_t=orc.keyframe_trajectory()[2])


@pytest.fixture(scope="module")
def port_oracle(frames_424):
    cfg = SLAMConfig().replace(camera=SLAMConfig().camera.scaled(424, 240))
    return _oracle_run(OracleSLAM, cfg, frames_424)


def test_oracle_slam_equals_the_reference(frames_424, port_oracle):
    cfg = JSLAMConfig().replace(camera=JSLAMConfig().camera.scaled(424, 240))
    want = _oracle_run(JOracle, cfg, frames_424)
    assert set(port_oracle) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(port_oracle[name], value, err_msg=name)
    assert want["ba_cum"][-1] == 1 and want["kf_cum"][-1] >= 2


def test_oracle_slam_reproduces_the_cached_prefix(port_oracle):
    cached = np.load(CACHE)
    np.testing.assert_array_equal(port_oracle["t"], cached["t"][:N_FRAMES])
    np.testing.assert_array_equal(port_oracle["kf_cum"],
                                  cached["kf_cum"][:N_FRAMES])
    np.testing.assert_array_equal(port_oracle["ba_cum"],
                                  cached["ba_cum"][:N_FRAMES])


def test_a_raising_f_estimate_is_one_without_inliers(frames_424,
                                                      monkeypatch):
    """OpenCV 4.13.0's findFundamentalMat fails an internal assertion on
    some inputs (a few frames of the 480-frame parity runs): the oracle
    takes that frame as one whose estimate failed, as when F is None,
    counts it in ``fm_errors`` and runs on."""
    import cv2
    real = cv2.findFundamentalMat
    calls = []

    def flaky(*args, **kwargs):
        calls.append(len(calls))
        if len(calls) == 5:
            raise cv2.error("OpenCV(4.13.0) matrix.cpp:764: error: (-215)")
        return real(*args, **kwargs)

    monkeypatch.setattr(cv2, "findFundamentalMat", flaky)
    cfg = SLAMConfig().replace(camera=SLAMConfig().camera.scaled(424, 240))
    orc = OracleSLAM(cfg, run_ba=True)
    out = [orc.process(g, d, ts) for g, d, _, _, ts in frames_424[:10]]
    assert orc.fm_errors == 1 and len(calls) == 9
    assert not out[5].tracking_ok and out[5].n_inliers == 0
    assert all(f.tracking_ok for f in out[1:5] + out[6:])
    np.testing.assert_array_equal(out[5].t_wc, out[4].t_wc)
