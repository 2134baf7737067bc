"""PyTorch port vs the JAX reference: the multi-stream fleet,
``parallel/mesh.SLAMFleet`` (``step``, ``run_ba``, ``stats``,
``make_detector``), on the CPU; ``step_batch`` is in
tests/test_torch_fleet_batch.py (the two files run on two workers).

The fixture is tests/test_parallel.py's: 160x120, a map of 256 landmarks,
8 keyframes and 128 observations a keyframe (a payload cap below
``min_matches_to_last_kf``, so every tracked frame is a keyframe); 2
streams, sequence seed 3 in stream 0 and seed 7 in stream 1.  The
reference runs ``SLAMFleet`` on a one-device mesh (``make_mesh(1)``); the
port gets the reference fleet's own RANSAC draws
(torch_parity.JaxFleetSampler: stream s starts at fold_in(key(0), s)) and
extracts its own keypoints.

Tolerances, and why:
- ``step``, 14 frames: per stream and frame, keyframe and tracking flags,
  feature and match counts equal; F-RANSAC inliers within 2 (epipolar
  errors on the threshold, tests/test_torch_tracker.py); keyframe counts
  and active landmarks equal; the landmark arenas equal slot for slot.
  Frame positions within 1e-4 m, quaternion components within 1e-5,
  landmark positions within 1e-3 m.  Measured, this file run alone on an
  AVX-512 host under MKL_CBWR AVX2, AVX512 and COMPATIBLE, each with
  ATEN_CPU_CAPABILITY default and avx2: frame positions 0.0004 to 0.0011
  mm at worst, quaternions 8.3e-8 to 2.3e-7 (no RANSAC decision flips on
  this fixture, and one that did would move a pose by millimetres,
  tests/test_torch_tracker.py, which the bound does not let pass);
  landmarks 0.097 to 0.434 mm (the DLT of a short baseline amplifies the
  poses' last bits).
- ``run_ba`` after those frames: each stream's final cost within 5e-5
  relative of the reference's (the LM runs in float32 over sums in
  another order); measured 8.9e-7 to 8.5e-6 under the same settings.
- GT-box culling (walker scene, both streams): no person landmark.
- ``make_detector`` with the shipped weights (input size 256) on rendered
  320x240 walker frames: against the reference's single-stream pieces
  (``YoloDetector.letterbox`` and ``yolov8.detect`` on each stream's frame,
  boxes unletterboxed and clipped as ``parallel/mesh.py``'s
  ``make_detector``), valid rows and classes equal, boxes within
  tests/test_torch_yolo.py's per-candidate 2.75 px at the network's input,
  i.e. 2.75 / scale frame pixels.
- ``make_detector`` with an explicit ``input_size=640`` and the shipped
  weights (which embed 256): the network's canvas equals the single-stream
  letterbox at 640 exactly; without a size it is 256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxFleetSampler, to_numpy_tree

from dynamic_visual_slam_tpu.config import CameraConfig, MapConfig, SLAMConfig
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu.models import yolov8 as jy
from dynamic_visual_slam_tpu.parallel import mesh as jmesh
from dynamic_visual_slam_tpu.semantic.detector import YoloDetector as JDet
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.parallel.mesh import SLAMFleet
from dynamic_visual_slam_tpu_torch.semantic.detector import \
    boxes_to_detections

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = SLAMConfig().replace(
    camera=CAM,
    map=MapConfig(max_landmarks=256, max_keyframes=8,
                  max_obs_per_landmark=4, max_obs_per_keyframe=128))
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
N = 14
FIELDS = ("t_wc", "q_wc", "is_keyframe", "tracking_ok", "n_features",
          "n_matches", "n_inliers")
WEIGHTS = "assets/yolov8n_synth.npz"


@pytest.fixture(scope="module")
def frames():
    """(grays (N, 2, H, W) uint8, depths (N, 2, H, W) f32 m, stamps (N, 2))."""
    seqs = [list(synthetic.generate_sequence(CAM, N, seed=s)) for s in (3, 7)]
    grays = np.stack([[s[i][0] for s in seqs] for i in range(N)]
                     ).astype(np.uint8)
    depths = np.stack([[s[i][1] for s in seqs] for i in range(N)]
                      ).astype(np.float32)
    stamps = np.asarray([[s[i][4] for s in seqs] for i in range(N)],
                        np.float32)
    return grays, depths, stamps


def _rows(out):
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def runs(frames):
    """Both fleets through ``step`` (no BA tick), then one ``run_ba``."""
    grays, depths, stamps = frames
    ref = jmesh.SLAMFleet(CFG, batch=2, mesh=jmesh.make_mesh(1))
    port = SLAMFleet(PCFG, 2, device="cpu", sampler=JaxFleetSampler(2, N))
    rows = []
    for i in range(N):
        jo = ref.step(jnp.asarray(grays[i]), jnp.asarray(depths[i]),
                      jnp.asarray(stamps[i]), auto_ba=False)
        po = port.step(grays[i], depths[i], stamps[i], auto_ba=False)
        rows.append((_rows(jo), _rows(po)))
    before = (ref.stats(), port.stats())
    costs = (np.asarray(ref.run_ba()), port.run_ba().numpy())
    return dict(rows=rows, stats=before, costs=costs,
                maps=(to_numpy_tree(ref.map_states),
                      convert.to_numpy(port.map_states)),
                ref_tracker=to_numpy_tree(ref.tracker_states))


def test_streams_match_reference(runs):
    rows = runs["rows"]
    get = lambda k, f: np.stack([r[k][f] for r in rows])  # noqa: E731
    for f in ("is_keyframe", "tracking_ok", "n_features", "n_matches"):
        np.testing.assert_array_equal(get(1, f), get(0, f), err_msg=f)
    assert np.abs(get(1, "n_inliers") - get(0, "n_inliers")).max() <= 2
    err = np.linalg.norm(get(1, "t_wc") - get(0, "t_wc"), axis=-1)  # (N, 2)
    q_err = np.abs(get(1, "q_wc") - get(0, "q_wc")).max(-1)
    print(f"fleet positions: worst {err.max() * 1e3:.4f} mm (frame, stream "
          f"{np.unravel_index(err.argmax(), err.shape)}), RMS "
          f"{np.sqrt(np.mean(err ** 2)) * 1e3:.4f} mm; quaternions within "
          f"{q_err.max():.2e}")
    assert err.max() < 1e-4
    assert q_err.max() < 1e-5
    jst, pst = runs["stats"]
    for k in ("streams", "keyframes", "landmarks_active",
              "keyframes_dropped"):
        assert pst[k] == jst[k], k
    assert pst["keyframes"] == [N, N]


def test_landmark_arena_matches_reference(runs):
    """The two maps hold the same landmark slots, categories and
    observation counts per stream, positions within the bound above."""
    jm, pm = runs["maps"]
    jl, pl = jm["landmarks"], pm["landmarks"]
    for f in ("active", "category", "n_obs", "obs_valid", "obs_kf"):
        np.testing.assert_array_equal(pl[f], jl[f], err_msg=f)
    act = jl["active"]
    err = np.abs(pl["xyz"][act] - jl["xyz"][act]).max()
    print(f"fleet landmarks: {int(act.sum())} active, positions within "
          f"{err * 1e3:.4f} mm")
    assert err < 1e-3
    np.testing.assert_array_equal(pm["keyframes"]["count"],
                                  jm["keyframes"]["count"])


def test_fleet_states_carry_across(runs):
    """The reference fleet's states (leaves with a leading stream dim) into
    the port and back: every leaf equal; the per-stream keys' words map to
    a generator seed (the first stream's) and back to that seed's words."""
    want = runs["ref_tracker"]
    ts = convert.tracker_state(want)
    assert ts.q_wc.shape == (2, 4) and ts.prev.uv.shape[0] == 2
    gen = torch.Generator()
    gen.manual_seed(convert.seed_from_words(want["rng"]))
    back = convert.tracker_state_to_numpy(ts, gen)
    for name, w in want.items():
        if name == "rng":
            continue
        got = back[name]
        if isinstance(w, dict):
            for k in w:
                np.testing.assert_array_equal(got[k], w[k], err_msg=k)
        else:
            np.testing.assert_array_equal(got, w, err_msg=name)
    np.testing.assert_array_equal(back["rng"][0], want["rng"][0])
    assert back["rng"].shape == (2, 2)
    jm = runs["maps"][0]
    ms = convert.map_state(jm)
    assert ms.landmarks.xyz.shape[0] == 2
    np.testing.assert_array_equal(convert.to_numpy(ms)["landmarks"]["xyz"],
                                  jm["landmarks"]["xyz"])


def test_run_ba_costs_match_reference(runs):
    jc, pc = runs["costs"]
    assert pc.shape == jc.shape == (2,)
    rel = np.abs(pc - jc) / np.abs(jc)
    print(f"BA final costs: port {pc.tolist()}, reference {jc.tolist()}, "
          f"relative {rel.max():.2e}")
    assert rel.max() < 5e-5


def test_gt_boxes_cull_people_in_every_stream():
    """Ground-truth walker boxes drive the fleet's culling and mapping: no
    person landmark enters either stream's map."""
    seq = list(synthetic.generate_dynamic_sequence(CAM, 8, seed=1))
    fleet = SLAMFleet(PCFG, 2, device="cpu")
    cap = PCFG.semantic.max_detections
    for g, d, _, _, ts, boxes in seq:
        det1 = boxes_to_detections(boxes, cap, device="cpu")
        dets = type(det1)(*(torch.stack([x, x]) for x in det1))
        out = fleet.step(np.stack([g, g]), np.stack([d, d]).astype(
            np.float32), np.full(2, ts, np.float32), detections=dets,
            auto_ba=False)
    assert torch.isfinite(out.t_wc).all()
    lm = fleet.map_states.landmarks
    assert int(fleet.map_states.keyframes.count.min()) >= 1
    assert not bool((lm.active & (lm.category == 1)).any())
    assert int(lm.active.sum()) > 0


def test_make_detector_matches_reference_pieces():
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5)
    cfg = SLAMConfig().replace(camera=cam)
    jdet = JDet(cfg, weights_path=WEIGHTS)
    assert jdet.size == 256
    fleet = SLAMFleet(PSLAMConfig.from_dict(cfg.to_dict()), 2, device="cpu")
    detect = fleet.make_detector(convert.load_params(WEIGHTS))
    grays = [g for g, *_ in synthetic.generate_dynamic_sequence(
        cam, 40, seed=0)][::5]
    hi = np.asarray([cam.width - 1, cam.height - 1] * 2, np.float32)
    n_diff, n_valid, worst, tol = 0, 0, 0.0, None
    for i in range(0, len(grays), 2):
        got = detect(np.stack(grays[i:i + 2]))
        for s in range(2):
            canvas, scale, (px, py) = jdet.letterbox(
                np.stack([grays[i + s]] * 3, -1))
            raw = jy.detect(jdet.params, canvas, jdet.size, 32)
            boxes = np.clip((np.asarray(raw.boxes) - np.asarray(
                [px, py, px, py], np.float32)) / scale, 0.0, hi)
            wv, gv = np.asarray(raw.valid), got.mask[s].numpy()
            same = (wv == gv).all() and (
                np.asarray(raw.classes)[wv] + 1
                == got.category[s].numpy()[gv]).all()
            n_diff += not same
            tol = 2.75 / scale
            if same:
                n_valid += int(wv.sum())
                worst = max(worst, float(np.abs(
                    got.boxes[s].numpy()[gv] - boxes[wv]).max(initial=0.0)))
    print(f"fleet detector: {n_diff} of {len(grays)} frames differ in valid "
          f"rows or classes; {n_valid} detections, boxes within "
          f"{worst:.3f} px (bound {tol:.3f})")
    assert n_diff == 0
    assert n_valid >= len(grays)
    assert worst <= tol


def test_make_detector_honours_an_explicit_input_size(monkeypatch):
    """The shipped weights embed input size 256; an explicit
    ``input_size=640`` wins, as in the reference's ``make_detector``: the
    letterbox geometry (scale 2, padding (0, 80) for 320x240 frames) and the
    network's canvas are 640, equal to the single-stream letterbox at 640.
    Without a size, the fleet keeps the weights' 256 (the port's default;
    the reference's is 640, ROADMAP §C)."""
    from dynamic_visual_slam_tpu_torch.models import yolov8 as py
    from dynamic_visual_slam_tpu_torch.semantic.detector import (
        letterbox, letterbox_geometry)
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5)
    cfg = PSLAMConfig.from_dict(SLAMConfig().replace(camera=cam).to_dict())
    params = convert.load_params(WEIGHTS)
    assert int(params["input_size"]) == 256
    canvases = []
    real = py.detect_batch

    def spy(model, imgs, *args, **kwargs):
        canvases.append(imgs.clone())
        return real(model, imgs, *args, **kwargs)

    monkeypatch.setattr(py, "detect_batch", spy)
    grays = np.stack([g for g, *_ in synthetic.generate_dynamic_sequence(
        cam, 2, seed=0)])
    fleet = SLAMFleet(cfg, 2, device="cpu")
    out = fleet.make_detector(params, input_size=640)(grays)
    assert letterbox_geometry(240, 320, 640) == (2.0, (480, 640), (0, 80))
    want, scale, pad = letterbox(np.stack([grays] * 3, -1), 640, "cpu")
    assert (scale, pad) == (2.0, (0, 80))
    assert canvases[0].shape == (2, 640, 640, 3)
    torch.testing.assert_close(canvases[0], want, rtol=0, atol=0)
    assert out.boxes.shape == (2, PCFG.semantic.max_detections, 4)
    fleet.make_detector(params)(grays)
    assert canvases[1].shape == (2, 256, 256, 3)
