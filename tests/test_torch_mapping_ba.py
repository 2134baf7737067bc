"""PyTorch port vs the JAX reference: backend/mapping (keyframe insert,
association, triangulation, prune) and backend/ba (window extraction, LM
optimize, write-back), on keyframe blocks the reference tracker produced
from synthetic 320x240 frames.  Each stage is fed the reference's own input
state, carried across by convert.py.

Tolerances: arena slots and every integer/boolean field exact (allocation,
association, observation rings); triangulated positions 1e-3 m; BA initial
cost 1e-5 relative, final cost 1e-3 relative (20 float32 LM iterations in
another evaluation order); window extraction exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_numpy_tree

from dynamic_visual_slam_tpu.backend import ba as jba
from dynamic_visual_slam_tpu.backend import mapping as jmap
from dynamic_visual_slam_tpu.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu.core.camera import Intrinsics as JK
from dynamic_visual_slam_tpu.frontend import orb as jorb
from dynamic_visual_slam_tpu.frontend import tracker as jtr
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu.semantic.classes import filtered_mask as jfilt
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.backend import ba as pba
from dynamic_visual_slam_tpu_torch.backend import mapping as pmap
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics as PK
from dynamic_visual_slam_tpu_torch.semantic import classes as pclasses

torch.set_num_threads(2)
CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = SLAMConfig().replace(camera=CAM)
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
INSERT_FRAMES = (0, 1, 3, 5, 7)


def _block(out, i):
    return jtr.KeyframeBlock(*(a[i] for a in out.keyframe))


@pytest.fixture(scope="module")
def reference():
    """The reference's keyframe blocks and the map states before/after each
    insert, then one BA round."""
    seq = list(synthetic.generate_sequence(CAM, 8, seed=11, depth_noise=0.004))
    grays = jnp.asarray(np.stack([f[0] for f in seq]).astype(np.float32))
    depths = jnp.asarray(np.stack([f[1] for f in seq]))
    ts = jnp.asarray([f[4] for f in seq], jnp.float32)
    kps = jax.jit(lambda x: jorb.extract_batch(x, CFG.orb))(grays)
    _, out = jax.jit(lambda s, k, d, t: jtr.track_batch(CFG, s, k, d, t))(
        jtr.init_state(CFG), kps, depths, ts)
    det = jmap.Detections.empty(CFG.semantic.max_detections)
    insert = jax.jit(lambda s, kf: jmap.insert_keyframe(
        CFG, s, kf, det, jfilt(CFG)))
    states = [jmap.init_map(CFG)]
    for i in INSERT_FRAMES:
        states.append(insert(states[-1], _block(out, i))[0])
    k = JK.from_config(CFG.camera)
    problem, wslots, lslots = jba.extract_window(CFG, states[-1])
    result = jax.jit(lambda p: jba.optimize(k, p, CFG.ba))(problem)
    after_ba, _ = jax.jit(lambda s: jba.run_ba(CFG, k, s))(states[-1])
    return dict(out=out, states=states, problem=problem, wslots=wslots,
                lslots=lslots, result=result, after_ba=after_ba)


def _pmap_state(jstate):
    return convert.map_state(to_numpy_tree(jstate))


def _assert_map_equal(got, want, xyz_tol=1e-3):
    g, w = convert.to_numpy(got), to_numpy_tree(want)
    for part in ("landmarks", "keyframes"):
        for name, wv in w[part].items():
            gv = g[part][name]
            if np.issubdtype(np.asarray(wv).dtype, np.floating):
                tol = xyz_tol if name == "xyz" else 1e-5
                if name == "xyz":   # compare positions of live slots only
                    act = w["landmarks"]["active"]
                    gv, wv = gv[act], np.asarray(wv)[act]
                np.testing.assert_allclose(gv, wv, atol=tol, err_msg=name)
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=name)


@pytest.mark.parametrize("step", range(len(INSERT_FRAMES)))
def test_insert_keyframe_matches(reference, step):
    out = reference["out"]
    kf = convert.keyframe_block(to_numpy_tree(_block(out, INSERT_FRAMES[step])))
    det = pmap.Detections.empty(PCFG.semantic.max_detections, "cpu")
    got, stats = pmap.insert_keyframe(
        PCFG, _pmap_state(reference["states"][step]), kf, det,
        pclasses.filtered_mask(PCFG, "cpu"))
    _assert_map_equal(got, reference["states"][step + 1])
    assert int(stats["n_active"]) == int(
        reference["states"][step + 1].landmarks.active.sum())
    if step > 0:
        assert int(stats["n_matched"]) > 0


def test_categorize_first_box_wins():
    det = pmap.Detections(
        boxes=torch.tensor([[0, 0, 10, 10], [5, 5, 20, 20]], dtype=torch.float32),
        category=torch.tensor([3, 7]), score=torch.ones(2),
        mask=torch.tensor([True, True]))
    uv = torch.tensor([[1.0, 1.0], [7.0, 7.0], [15.0, 15.0], [30.0, 30.0]])
    np.testing.assert_array_equal(pmap.categorize(uv, det).numpy(),
                                  [3, 3, 7, 0])
    np.testing.assert_array_equal(
        pclasses.filtered_mask(PCFG, "cpu").numpy(), np.asarray(jfilt(CFG)))


def test_triangulate_all_matches():
    """Wide-baseline rings (the tracker fixture's 8 frames have < 5° of
    parallax, so nothing there passes the gate): 4 keyframes over 0.6 m,
    64 points at 2-3 m observed with 0.3 px noise."""
    rng = np.random.default_rng(5)
    m_ring, n = CFG.map.max_obs_per_landmark, 64
    kj = JK.from_config(CFG.camera)
    cam_t = np.stack([np.linspace(-0.3, 0.3, 4), np.zeros(4), np.zeros(4)], 1)
    pts = rng.uniform([-0.6, -0.4, 2.0], [0.6, 0.4, 3.0], (n, 3))
    uv = (pts[:, None] - cam_t[None]) * np.asarray([kj.fx, kj.fy, 1.0])
    uv = uv[..., :2] / uv[..., 2:] + np.asarray([kj.cx, kj.cy])
    uv += rng.normal(size=uv.shape) * 0.3
    state = jmap.init_map(CFG)
    kdb = state.keyframes._replace(
        t=state.keyframes.t.at[:4].set(jnp.asarray(cam_t, jnp.float32)),
        active=state.keyframes.active.at[:4].set(True),
        next_slot=jnp.asarray(4, jnp.int32), count=jnp.asarray(4, jnp.int32))
    obs_uv = np.zeros((n, m_ring, 2), np.float32)
    obs_uv[:, :4] = uv
    obs_kf = np.zeros((n, m_ring), np.int32)
    obs_kf[:, :4] = np.arange(4)
    obs_valid = np.zeros((n, m_ring), bool)
    obs_valid[:, :4] = rng.random((n, 4)) < 0.9
    active = np.ones(n, bool)
    want_xyz, want_ok = jmap.triangulate_rings(
        CFG, kj, jnp.asarray(obs_uv), jnp.asarray(obs_kf),
        jnp.asarray(obs_valid), jnp.asarray(active), kdb)
    pk = convert.from_numpy(pmap.KeyframeDB, to_numpy_tree(kdb))
    got_xyz, got_ok = pmap.triangulate_rings(
        PCFG, PK.from_config(PCFG.camera), torch.from_numpy(obs_uv),
        torch.from_numpy(obs_kf), torch.from_numpy(obs_valid),
        torch.from_numpy(active), pk)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    assert ok.sum() > 40
    np.testing.assert_allclose(got_xyz.numpy()[ok], np.asarray(want_xyz)[ok],
                               atol=1e-3)


def test_prune_matches(reference):
    state = reference["states"][-1]
    now = 25.0
    want = jmap.prune(CFG, state.landmarks, jnp.asarray(now, jnp.float32))
    got = pmap.prune(PCFG, _pmap_state(state).landmarks, torch.tensor(now))
    for name in ("active", "obs_valid", "n_obs", "obs_head"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_extract_window_matches(reference):
    problem, wslots, lslots = pba.extract_window(
        PCFG, _pmap_state(reference["states"][-1]))
    np.testing.assert_array_equal(wslots.numpy(), np.asarray(reference["wslots"]))
    np.testing.assert_array_equal(lslots.numpy(), np.asarray(reference["lslots"]))
    want = to_numpy_tree(reference["problem"])
    for name, w in convert.to_numpy(problem).items():
        np.testing.assert_array_equal(w, want[name], err_msg=name)


def test_optimize_matches(reference):
    problem = convert.ba_problem(to_numpy_tree(reference["problem"]))
    got = pba.optimize(PK.from_config(PCFG.camera), problem, PCFG.ba)
    want = reference["result"]
    assert int(got.n_residuals) == int(want.n_residuals) > 100
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    print(f"BA final cost: port {float(got.final_cost)} "
          f"reference {float(want.final_cost)} (initial "
          f"{float(want.initial_cost)}); iterations {int(got.iterations)} "
          f"vs {int(want.iterations)}")
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-3)
    assert float(got.final_cost) < float(got.initial_cost)


def test_run_ba_write_back_matches(reference):
    got, res = pba.run_ba(PCFG, PK.from_config(PCFG.camera),
                          _pmap_state(reference["states"][-1]))
    want = reference["after_ba"]
    np.testing.assert_allclose(got.keyframes.t.numpy(),
                               np.asarray(want.keyframes.t), atol=1e-3)
    np.testing.assert_allclose(got.keyframes.q.numpy(),
                               np.asarray(want.keyframes.q), atol=1e-3)
    assert float(res.final_cost) < float(res.initial_cost)
