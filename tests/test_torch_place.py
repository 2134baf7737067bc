"""PyTorch port vs the JAX reference: the place chain — place/bow.py,
backend/pose_graph.py, and pipeline/slam.py's verify_loop, apply_loop,
apply_loop_pgo and apply_reloc — on inputs made from a seed with numpy.

Tolerances, and why:
- vocabulary descent, trained vocabularies, BoW histograms' words: exact
  (integer Hamming distances, the same numpy k-medians); ties in the
  descent go to the first minimum and ties in a database query to the
  lower entry id in both packages (cases below build such ties);
- BoW vectors and query scores: 1e-6 (float32 sums taken in another
  order);
- pose graph: 1e-4 on poses and corrections (a float32 Gauss-Newton with
  an LU solve of the (6F, 6F) normal matrix in both packages);
- verify_loop on the reference's own draws: F-RANSAC inlier count within
  2 % (epipolar errors on the threshold, see tests/test_torch_tracker.py),
  PnP pose within 5e-3 m / 5e-3, PnP inliers within 2 %;
- loop and relocalization corrections on a state carried across by
  convert.py: 1e-4 (rotation composition in float32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxSampler, from_numpy_tree, to_numpy_tree

from dynamic_visual_slam_tpu.backend import mapping as jmap
from dynamic_visual_slam_tpu.backend import pose_graph as jpg
from dynamic_visual_slam_tpu.config import CameraConfig, MapConfig, SLAMConfig
from dynamic_visual_slam_tpu.core import camera as jcam
from dynamic_visual_slam_tpu.core import lie as jlie
from dynamic_visual_slam_tpu.frontend import orb as jorb
from dynamic_visual_slam_tpu.frontend import tracker as jtr
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu.pipeline.slam import _build_programs
from dynamic_visual_slam_tpu.place import bow as jbow
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.backend import pose_graph as ppg
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.pipeline import slam as pslam
from dynamic_visual_slam_tpu_torch.place import bow as pbow

torch.set_num_threads(2)
VOCAB = "assets/orbvoc_synth.npz"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def vocabs():
    return jbow.load_vocabulary(VOCAB), pbow.load_vocabulary(VOCAB, "cpu")


def _tie_descriptors(voc, rng, n):
    """Descriptors at equal Hamming distance from two children of the root
    (the descent's first level must break the tie), then random ones.
    → (descriptors, the lower child of each tie)."""
    lv = np.asarray(voc.levels[0])
    out, lower = [], []
    for a in range(len(lv)):
        for b in range(a + 1, len(lv)):
            diff = np.nonzero(lv[a] != lv[b])[0]
            if len(diff) % 2 or len(lower) >= 4 or a in lower:
                continue
            d = lv[a].copy()
            d[diff[::2]] = lv[b][diff[::2]]
            assert (d != lv[a]).sum() == (d != lv[b]).sum()
            out.append(d)
            lower.append(a)
    out += list(rng.integers(0, 2, (n, 256)).astype(np.uint8))
    return np.stack(out), np.asarray(lower)


def test_vocabulary_loads_equal(vocabs):
    jv, pv = vocabs
    assert (pv.k, pv.depth, pv.n_words) == (jv.k, jv.depth, jv.n_words)
    for a, b in zip(jv.levels + jv.valid, pv.levels + pv.valid):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(pv.word_weights.numpy(),
                                  np.asarray(jv.word_weights))


def test_descend_and_transform_on_the_shipped_vocabulary(vocabs):
    jv, pv = vocabs
    rng = np.random.default_rng(4)
    descs, lower = _tie_descriptors(jv, rng, 300)
    mask = rng.random(len(descs)) < 0.8
    words = pbow.descend(pv, _t(descs)).numpy()
    np.testing.assert_array_equal(words, np.asarray(jbow.descend(jv, descs)))
    # the tie rows took the lower child at the root, in both packages
    assert len(lower) >= 2
    assert (words[:len(lower)] // jv.k ** (jv.depth - 1) == lower).all()
    got = pv.transform(_t(descs), _t(mask)).numpy()
    want = np.asarray(jv.transform(jnp.asarray(descs), jnp.asarray(mask)))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_train_vocabulary_equals_reference():
    rng = np.random.default_rng(8)
    descs = rng.integers(0, 2, (600, 256)).astype(np.uint8)
    docs = np.repeat(np.arange(4), 150)
    want = jbow.train_vocabulary(descs, k=6, depth=2, seed=0, doc_ids=docs)
    got = pbow.train_vocabulary(descs, k=6, depth=2, seed=0, doc_ids=docs,
                                device="cpu")
    for a, b in zip(want.levels + want.valid, got.levels + got.valid):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(got.word_weights.numpy(),
                                  np.asarray(want.word_weights))


def test_vocabulary_round_trips(tmp_path, vocabs):
    _, pv = vocabs
    pbow.save_vocabulary(pv, str(tmp_path / "v.npz"))
    back = pbow.load_vocabulary(str(tmp_path / "v.npz"), "cpu")
    for a, b in zip(pv.levels + pv.valid, back.levels + back.valid):
        assert torch.equal(a, b)
    cv = convert.vocabulary(convert.vocabulary_to_numpy(pv))
    assert torch.equal(cv.word_weights, pv.word_weights)


def test_database_query_matches_reference_ties_included(vocabs):
    jv, pv = vocabs
    rng = np.random.default_rng(6)
    jdb = jbow.Database(jv, capacity=6)
    pdb = pbow.Database(pv, capacity=6)
    sets = [rng.integers(0, 2, (64, 256)).astype(np.uint8) for _ in range(4)]
    # entries 0, 4 and 6 (which wraps onto slot 0) hold the same descriptors:
    # equal scores, so the order of the ids is the tie rule's
    order = [0, 1, 2, 3, 0, 1, 0, 2]
    for i in order:
        assert jdb.add(jnp.asarray(sets[i])) == pdb.add(_t(sets[i]))
        for top_k in (3, 6):
            for q in (0, 1):
                want = jdb.query(jnp.asarray(sets[q]), top_k=top_k)
                got = pdb.query(_t(sets[q]), top_k=top_k)
                np.testing.assert_array_equal(got.entry_ids.numpy(),
                                              np.asarray(want.entry_ids))
                np.testing.assert_array_equal(got.valid.numpy(),
                                              np.asarray(want.valid))
                np.testing.assert_allclose(got.scores.numpy(),
                                           np.asarray(want.scores), atol=1e-6)
    back = convert.database(convert.database_to_numpy(pdb))
    assert back.count == pdb.count == len(order)
    assert torch.equal(back.vectors, pdb.vectors)


def _chain(f=8, noise=0.02, seed=0):
    """tests/test_pose_graph.py's drifted keyframe chain."""
    from test_pose_graph import _chain as chain
    return chain(f, noise, seed)


@pytest.mark.parametrize("case", ["full", "evicted_candidate", "missing"])
def test_optimize_ring_matches_reference(case):
    f = 8
    q_gt, t_gt, q0, t0 = _chain(f)
    active = np.ones(f, bool)
    entry = f - 1
    if case == "evicted_candidate":
        active[0] = False
    if case == "missing":
        entry = 99
    seq = np.arange(f, dtype=np.int32)
    want = jpg.optimize_ring(jnp.asarray(q0), jnp.asarray(t0),
                             jnp.asarray(active), jnp.asarray(seq),
                             jnp.asarray(q_gt[-1]), jnp.asarray(t_gt[-1]),
                             entry_seq=jnp.asarray(entry),
                             cand_seq=jnp.asarray(0))
    got = ppg.optimize_ring(_t(q0), _t(t0), _t(active), _t(seq),
                            _t(q_gt[-1]), _t(t_gt[-1]), entry_seq=entry,
                            cand_seq=0)
    assert bool(got.ok) == bool(want.ok) == (case != "missing")
    for name in ("q", "t", "q_corr", "t_corr"):
        err = np.abs(getattr(got, name).numpy()
                     - np.asarray(getattr(want, name))).max()
        print(f"{case}: {name} max difference {err:.2e}")
        assert err < 1e-4, name
    if case == "full":
        err1 = np.linalg.norm(got.t.numpy() - t_gt, axis=1)
        assert err1[-1] < 0.25 * np.linalg.norm(t0[-1] - t_gt[-1])


# ---------------------------------------------------------------------------
# verification and corrections

CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = SLAMConfig().replace(camera=CAM)
PCFG = PSLAMConfig.from_dict(CFG.to_dict())


@pytest.fixture(scope="module")
def keyframe_pair():
    """Two frames of the seed-11 sequence, four apart: frame 0's keypoints
    as keyframe 1, frame 4's with its ground-truth world points as the
    candidate."""
    seq = list(synthetic.generate_sequence(CAM, 5, seed=11))
    k = jcam.Intrinsics.from_config(CAM)
    extract = jax.jit(lambda g: jorb.extract(g, CFG.orb))
    out = []
    for i in (0, 4):
        gray, depth, r, t, _ = seq[i]
        kps = extract(jnp.asarray(gray, jnp.float32))
        uv = np.asarray(kps.uv)
        z = depth[np.clip(np.round(uv[:, 1]).astype(int), 0, CAM.height - 1),
                  np.clip(np.round(uv[:, 0]).astype(int), 0, CAM.width - 1)]
        xyz = np.asarray(jcam.backproject(k, jnp.asarray(uv), jnp.asarray(z)))
        xyz_w = xyz @ r.T + t
        m = np.asarray(kps.mask) & (z > 0.3) & (z < 3.0)
        out.append(dict(d=np.asarray(kps.desc_bits), uv=uv, m=m,
                        xyz=xyz_w.astype(np.float32), r=r, t=t))
    return out


def test_verify_loop_matches_reference(keyframe_pair):
    a, b = keyframe_pair
    seed = 3 * 9973 + 1
    fn = _build_programs(CFG)["verify_loop"]
    q = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    want = fn(jnp.asarray(a["d"]), jnp.asarray(a["uv"]), jnp.asarray(a["m"]),
              q, jnp.zeros(3), jnp.asarray(b["d"]), jnp.asarray(b["uv"]),
              jnp.asarray(b["m"]), jnp.asarray(b["xyz"]),
              jax.random.key(seed))
    got = pslam.verify_loop(PCFG, Intrinsics.from_config(PCFG.camera),
                            _t(a["d"]), _t(a["uv"]), _t(a["m"]), _t(b["d"]),
                            _t(b["uv"]), _t(b["m"]), _t(b["xyz"]), seed,
                            JaxSampler(0))
    n_j, n_p = int(want[0]), int(got[0])
    pj, pp = int(want[3]), int(got[3])
    print(f"F-RANSAC inliers {n_p} vs {n_j}; PnP inliers {pp} vs {pj}")
    assert n_j > 100 and abs(n_p - n_j) <= 0.02 * n_j
    assert abs(pp - pj) <= 0.02 * pj
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=5e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=5e-3)
    # the PnP pose is frame 0's ground truth (the identity)
    np.testing.assert_allclose(got[2].numpy(), a["t"], atol=2e-2)


SMALL = SLAMConfig().replace(
    camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                        cx=79.5, cy=59.5),
    map=MapConfig(max_landmarks=256, max_keyframes=8, max_obs_per_landmark=6,
                  max_obs_per_keyframe=64))
PSMALL = PSLAMConfig.from_dict(SMALL.to_dict())


def _rand_quats(rng, n, scale):
    phi = rng.normal(size=(n, 3)).astype(np.float32) * scale
    return np.asarray(jlie.so3_exp(jnp.asarray(phi)))


@pytest.fixture(scope="module")
def states():
    """A tracker state and a map state with a wrapped ring of 8 keyframes
    (sequence ids 3..10) and landmarks observed from them, made with
    numpy."""
    rng = np.random.default_rng(12)
    f, n_lm = 8, SMALL.map.max_landmarks
    m = to_numpy_tree(jmap.init_map(SMALL))
    kdb = m["keyframes"]
    kdb["q"] = _rand_quats(rng, f, 0.2)
    kdb["t"] = rng.normal(size=(f, 3)).astype(np.float32)
    kdb["active"] = np.ones(f, bool)
    kdb["active"][5] = False
    kdb["next_slot"] = np.asarray(11, np.int32)
    kdb["count"] = np.asarray(11, np.int32)
    lm = m["landmarks"]
    lm["xyz"] = rng.normal(size=(n_lm, 3)).astype(np.float32) * 2
    lm["active"] = rng.random(n_lm) < 0.8
    lm["obs_kf"] = rng.integers(0, 11, lm["obs_kf"].shape).astype(np.int32)
    lm["obs_valid"] = rng.random(lm["obs_valid"].shape) < 0.5
    t = to_numpy_tree(jtr.init_state(SMALL))
    t["q_wc"] = _rand_quats(rng, 1, 0.3)[0]
    t["t_wc"] = rng.normal(size=3).astype(np.float32)
    t["kf_xyz_w"] = rng.normal(size=t["kf_xyz_w"].shape).astype(np.float32)
    return t, m


def _compare(got, want, tol=1e-4):
    g = convert.to_numpy(got)
    w = to_numpy_tree(want)

    def walk(a, b, path):
        if isinstance(a, dict):
            for key in a:
                if key != "rng":
                    walk(a[key], b[key], path + "." + key)
            return
        np.testing.assert_allclose(a.astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   atol=tol, err_msg=path)
    walk(g, w, "")


@pytest.mark.parametrize("pgo", [True, False])
@pytest.mark.parametrize("size", ["small", "gated"])
def test_loop_corrections_match_reference(states, pgo, size):
    t_np, m_np = states
    rng = np.random.default_rng(3)
    entry_seq, cand_seq = 9, 4
    slot = entry_seq % 8
    dq = _rand_quats(rng, 1, 0.05 if size == "small" else 0.9)[0]
    dt = np.float32([0.05, -0.03, 0.02]) * (1 if size == "small" else 40)
    q_pnp, t_pnp = jlie.se3_compose(jnp.asarray(dq), jnp.asarray(dt),
                                    jnp.asarray(m_np["keyframes"]["q"][slot]),
                                    jnp.asarray(m_np["keyframes"]["t"][slot]))
    progs = _build_programs(SMALL)
    jfn = progs["apply_loop_pgo" if pgo else "apply_loop"]
    jts, jms = jfn(from_numpy_tree(jtr.init_state(SMALL), t_np),
                   from_numpy_tree(jmap.init_map(SMALL), m_np), q_pnp, t_pnp,
                   jnp.asarray(cand_seq, jnp.int32),
                   jnp.asarray(entry_seq, jnp.int32))
    pfn = pslam.apply_loop_pgo if pgo else pslam.apply_loop
    pts, pms = pfn(PSMALL, convert.tracker_state(t_np),
                   convert.map_state(m_np), _t(q_pnp), _t(t_pnp), cand_seq,
                   entry_seq)
    moved = np.abs(pms.keyframes.t.numpy() - m_np["keyframes"]["t"]).max()
    assert (moved > 1e-3) == (size == "small")
    _compare(pts, jts)
    _compare(pms, jms)


def test_reloc_correction_matches_reference(states):
    t_np, _ = states
    rng = np.random.default_rng(5)
    q = _rand_quats(rng, 2, 0.4)
    t = rng.normal(size=(2, 3)).astype(np.float32)
    jts = _build_programs(SMALL)["apply_reloc"](
        from_numpy_tree(jtr.init_state(SMALL), t_np), jnp.asarray(q[0]),
        jnp.asarray(t[0]), jnp.asarray(q[1]), jnp.asarray(t[1]))
    pts = pslam.apply_reloc(convert.tracker_state(t_np), _t(q[0]), _t(t[0]),
                            _t(q[1]), _t(t[1]))
    _compare(pts, jts)


def test_warmup_place_changes_nothing():
    """warmup_place's corrections are exact no-ops on a fresh system, and
    it leaves the database as it was."""
    cfg = dataclasses.replace(PSMALL)
    slam = pslam.SLAMSystem(cfg, vocab_path=VOCAB, device="cpu")
    before = convert.to_numpy(slam.map_state)
    slam.warmup_place()
    after = convert.to_numpy(slam.map_state)
    for key in ("q", "t", "active"):
        np.testing.assert_array_equal(after["keyframes"][key],
                                      before["keyframes"][key])
    assert slam._bow_db.count == 0 and not bool(slam._bow_db.used.any())
    np.testing.assert_allclose(slam.tracker_state.q_wc.numpy(),
                               [1.0, 0.0, 0.0, 0.0])
