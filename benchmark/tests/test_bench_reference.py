"""The plain reference (``slamref``) against answers known by hand, at a
tiny size on the CPU."""

from __future__ import annotations

import math

import numpy as np
import torch

from slamref.config import SLAMConfig
from slamref.core import lie
from slamref.frontend import orb, tracker
from slamref.io import synthetic
from slamref.ops.fast import corner_score


def test_fast_score_of_a_dot():
    img = torch.zeros(16, 16)
    img[8, 8] = 100.0
    s = corner_score(img)
    assert float(s[8, 8]) == 100.0           # every circle pixel 100 darker
    assert float(corner_score(torch.full((16, 16), 7.0)).abs().max()) == 0


def test_rotation_round_trip():
    w = torch.tensor([0.1, -0.2, 0.3])
    q = lie.so3_exp(w)
    assert torch.allclose(lie.so3_log(q), w, atol=1e-6)
    assert math.isclose(float(torch.linalg.vector_norm(q)), 1.0,
                        rel_tol=1e-6)


def test_tracker_holds_still_on_a_still_camera():
    cam = dict(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    d = SLAMConfig().to_dict()
    d["camera"] = {**d["camera"], **cam}
    cfg = SLAMConfig.from_dict(d)
    scene = synthetic.SyntheticScene(cfg.camera, seed=0)
    gray, depth = scene.render(np.eye(3), np.zeros(3))
    g = torch.from_numpy(gray.astype(np.uint8))
    dep = torch.from_numpy(depth.astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    state = tracker.init_state(cfg, "cpu")
    for i in range(3):
        state, out = tracker.track_step(
            cfg, state, g, dep, torch.tensor(i / 30.0),
            tracker.generator_sampler(gen))
    kps = orb.extract(g.to(torch.float32), cfg.orb)
    assert int(kps.mask.sum()) > 50
    assert bool(out.tracking_ok)
    assert float(torch.linalg.vector_norm(out.t_wc)) < 1e-3
    assert float(torch.linalg.vector_norm(lie.so3_log(out.q_wc))) < 1e-3


# -- the independent transcription of kernels B1 and B2 ----------------------

def test_independent_fast_score_of_a_dot_and_a_corner():
    from benchlib.orb_independent import fast_score
    img = torch.zeros(16, 16, dtype=torch.float64)
    img[8, 8] = 100.0
    assert float(fast_score(img)[8, 8]) == 100.0
    # a bright quadrant: a pixel at its corner sees 7 brighter circle
    # pixels in a row (too few for FAST-9), inside it 9 darker ones
    quad = torch.zeros(16, 16, dtype=torch.float64)
    quad[:8, :8] = 50.0
    s = fast_score(quad)
    assert float(s[8, 8]) == 0.0
    assert float(s[7, 7]) == 50.0


def test_independent_disc_is_orb_slams():
    from benchlib.orb_independent import disc
    # ORB-SLAM's umax for a half patch of 15
    umax = [15, 15, 15, 15, 14, 14, 14, 13, 13, 12, 11, 10, 9, 8, 6, 3]
    du, dv = disc()
    assert len(du) == sum(2 * umax[abs(v)] + 1 for v in range(-15, 16))
    assert int(du.max()) == 15 and int(dv.min()) == -15
    assert sorted(zip(du.tolist(), dv.tolist())) == sorted(
        zip(du.tolist(), (-dv).tolist()))


def test_reflect101_folds_like_opencv():
    from benchlib.orb_independent import reflect101
    got = reflect101(torch.tensor([-3, -1, 0, 4, 5, 7]), 5).tolist()
    assert got == [3, 1, 0, 4, 3, 1]


def test_independent_brief_of_a_ramp():
    """On a ramp that brightens to the right, the moments point along +x
    (no rotation), so bit i is 1 exactly where the pair's first point lies
    left of its second."""
    from benchlib.orb_independent import PATTERN, describe
    ramp = torch.arange(64, dtype=torch.float64).repeat(64, 1)
    pattern = torch.from_numpy(np.load(PATTERN).astype(np.float64))
    bits = describe(ramp, ramp, torch.tensor([32]), torch.tensor([32]),
                    pattern)[0]
    want = (pattern[:, 0] < pattern[:, 2]).to(torch.uint8)
    assert torch.equal(bits, want)


def test_independent_check_agrees_with_the_sound_extractor():
    from benchlib.orb_independent import mismatch
    from slamref.ops import image as imops
    cfg = SLAMConfig()
    cam = {**cfg.to_dict()["camera"], "width": 160, "height": 120,
           "fx": 130.0, "fy": 130.0, "cx": 79.5, "cy": 59.5}
    d = cfg.to_dict()
    d["camera"] = cam
    cfg = SLAMConfig.from_dict(d)
    gray, _ = synthetic.SyntheticScene(cfg.camera, seed=1).render(
        np.eye(3), np.zeros(3))
    g = torch.from_numpy(gray.astype(np.uint8)).to(torch.float32)
    kps = orb.extract(g, cfg.orb)
    levels = imops.build_pyramid(g, cfg.orb.n_levels, cfg.orb.scale_factor)
    smoothed = [torch.clamp(torch.round(imops.gaussian_blur(lv, 7, 2.0)),
                            0, 255) for lv in levels]
    n, bad = mismatch(levels, smoothed, kps, cfg.orb)
    assert n == int(kps.mask.sum()) > 50 and bad == 0
    bits = kps.desc_bits.clone()
    bits[kps.mask.nonzero()[0, 0], 3] ^= 1
    assert mismatch(levels, smoothed, kps._replace(desc_bits=bits),
                    cfg.orb) == (n, 1)
