"""PyTorch port vs the JAX reference: checkpoint and resume,
``pipeline/snapshot.py`` and ``SLAMSystem.save`` / ``restore``, on the CPU
at 160x120 (the relocalization fixture's camera and map, 12 frames of the
seed-5 sequence, place recognition on with a vocabulary trained online
after 3 keyframes).

- A reference ``SLAMSystem.save`` restores into the port: every leaf of
  both states equal to the reference's carried across with ``convert``
  (no tolerance: the npz holds the arrays as they are), the generator
  seeded from the reference key's words, and the place database
  (vectors, used, count, vocabulary, keyframe store, sequence counter)
  equal.
- A port ``save`` is read by the reference's ``snapshot.load`` with every
  leaf equal, and by its ``SLAMSystem.restore`` with the place database.
- A port save, restore and continue (place recognition off, 14 frames,
  saved after 7) gives the uninterrupted run's flags, positions and
  landmarks exactly: the generator's state and the host clock travel in
  the port's own keys.
- Old checkpoints (no ``desc_anchor``, no ``kf_xyz_w``) get the semantic
  defaults; another config raises and names the sections; a restore drops
  in-flight recovery state (the reference's tests/test_snapshot.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from torch_parity import to_numpy_tree

from dynamic_visual_slam_tpu.config import CameraConfig, MapConfig, SLAMConfig
from dynamic_visual_slam_tpu.io import synthetic
from dynamic_visual_slam_tpu.pipeline import snapshot as jsnap
from dynamic_visual_slam_tpu.pipeline.slam import SLAMSystem as JaxSLAM
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.config import SLAMConfig as PSLAMConfig
from dynamic_visual_slam_tpu_torch.pipeline import snapshot as psnap
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
_BASE = SLAMConfig()
CFG = _BASE.replace(
    camera=CAM,
    keyframe=dataclasses.replace(_BASE.keyframe, max_frames_between_kf=6),
    map=MapConfig(max_landmarks=1024, max_keyframes=8,
                  max_obs_per_landmark=6, max_obs_per_keyframe=256))
PCFG = PSLAMConfig.from_dict(CFG.to_dict())
N = 12
PLACE = dict(ba_async=False, vocab_train_keyframes=3, loop_min_gap=4,
             loop_min_score=0.08, loop_min_inliers=20)


@pytest.fixture(scope="module")
def seq():
    return [(g, d, ts) for g, d, _, _, ts in
            synthetic.generate_sequence(CAM, 14, seed=5, depth_noise=0.004)]


def _eq_tree(got, want, prefix=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _eq_tree(got[k], w, f"{prefix}{k}/")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=prefix + k)


def _eq_db(got, want):
    """Port SLAMSystem's place state against another system's (either
    package), as numpy."""
    g, w = got._bow_db, want._bow_db
    assert g.count == w.count and got._kf_seq == want._kf_seq
    for name in ("vectors", "used"):
        np.testing.assert_array_equal(np.asarray(getattr(g, name).cpu()
                                                 if torch.is_tensor(
                                                     getattr(g, name))
                                                 else getattr(g, name)),
                                      np.asarray(getattr(w, name)))
    gv, wv = g.vocabulary, w.vocabulary
    for a, b in zip(gv.levels + gv.valid + [gv.word_weights],
                    list(wv.levels) + list(wv.valid) + [wv.word_weights]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert sorted(got._kf_store) == sorted(want._kf_store)
    for slot, entry in got._kf_store.items():
        other = want._kf_store[slot]
        assert entry[0] == other[0]
        for a, b in zip(entry[1:], other[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def ref_snapshot(seq, tmp_path_factory):
    """The reference system after N frames with place recognition on, and
    its checkpoint."""
    ref = JaxSLAM(CFG, **PLACE)
    for g, d, ts in seq[:N]:
        ref.process(g, d, ts)
    ref.finalize()
    assert ref._bow_db is not None and ref._bow_db.count > 0
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    ref.save(path)
    return ref, path


def test_reference_snapshot_restores_into_the_port(ref_snapshot):
    ref, path = ref_snapshot
    port = SLAMSystem(PCFG, device="cpu", **PLACE)
    port.restore(path)
    want_t = to_numpy_tree(ref.tracker_state)
    words = want_t.pop("rng")
    _eq_tree(convert.to_numpy(port.tracker_state), want_t)
    _eq_tree(convert.to_numpy(port.map_state),
             to_numpy_tree(ref.map_state))
    assert port.generator.initial_seed() == convert.seed_from_words(words)
    assert port._n_kf_host == int(ref.map_state.keyframes.count)
    _eq_db(port, ref)


def test_port_snapshot_loads_in_the_reference(seq, tmp_path):
    port = SLAMSystem(PCFG, device="cpu", **PLACE)
    for g, d, ts in seq[:N]:
        port.process(g, d, ts)
    port.finalize()
    assert port._bow_db is not None
    path = str(tmp_path / "port.npz")
    port.save(path)
    ts_state, ms_state, cfg = jsnap.load(path)
    assert cfg == CFG
    want = to_numpy_tree(ts_state)
    np.testing.assert_array_equal(
        want.pop("rng"), convert.seed_words(port.generator.initial_seed()))
    _eq_tree(want, convert.to_numpy(port.tracker_state))
    _eq_tree(to_numpy_tree(ms_state), convert.to_numpy(port.map_state))
    ref = JaxSLAM(CFG, **PLACE)
    ref.restore(path)
    _eq_db(port, ref)


def _run(system, frames):
    out = [system.process(g, d, ts) for g, d, ts in frames]
    system.finalize()
    return out


def test_port_resume_is_exact(seq, tmp_path):
    """Save after 7 frames, restore into a fresh system, continue both."""
    kw = dict(device="cpu", ba_async=False, enable_place_recognition=False)
    a = SLAMSystem(PCFG, **kw)
    _run(a, seq[:7])
    path = str(tmp_path / "ckpt.npz")
    a.save(path)
    b = SLAMSystem(PCFG, **kw)
    b.restore(path)
    ra, rb = _run(a, seq[7:]), _run(b, seq[7:])
    for fa, fb in zip(ra, rb):
        assert (fa.is_keyframe, fa.tracking_ok) == (fb.is_keyframe,
                                                    fb.tracking_ok)
        np.testing.assert_array_equal(fa.t_wc, fb.t_wc)
        np.testing.assert_array_equal(fa.q_wc, fb.q_wc)
    la, lb = a.landmarks_world(), b.landmarks_world()
    assert len(la["xyz"]) > 0
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k])
    assert a.stats == b.stats


def test_old_checkpoint_missing_fields_get_semantic_defaults(seq, tmp_path):
    slam = SLAMSystem(PCFG, device="cpu", ba_async=False,
                      enable_place_recognition=False)
    _run(slam, seq[:6])
    path = str(tmp_path / "new.npz")
    slam.save(path)
    data = dict(np.load(path))
    del data["map/landmarks/desc_anchor"]
    del data["tracker/kf_xyz_w"]
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **data)
    ts_state, ms_state, _ = psnap.load(old, "cpu")
    assert torch.equal(ms_state.landmarks.desc_anchor,
                       ms_state.landmarks.desc_bits)
    assert not bool(ts_state.has_kf)
    # the reference reads the same file the same way
    jts, jms, _ = jsnap.load(old)
    np.testing.assert_array_equal(np.asarray(jms.landmarks.desc_anchor),
                                  ms_state.landmarks.desc_anchor.numpy())
    assert not bool(jts.has_kf)


def test_config_mismatch_names_the_sections(seq, tmp_path):
    slam = SLAMSystem(PCFG, device="cpu", enable_place_recognition=False)
    _run(slam, seq[:2])
    path = str(tmp_path / "ckpt.npz")
    slam.save(path)
    other = PCFG.replace(ba=dataclasses.replace(PCFG.ba, period_s=1.0))
    with pytest.raises(ValueError, match=r"mismatch.*\['ba'\]"):
        SLAMSystem(other, device="cpu").restore(path)


def test_restore_drops_inflight_recovery_state(seq, tmp_path):
    slam = SLAMSystem(PCFG, device="cpu", ba_async=False,
                      enable_place_recognition=False)
    _run(slam, seq[:4])
    path = str(tmp_path / "ckpt.npz")
    slam.save(path)
    slam._pending_reloc = ("stale-verdict", None, None, {})
    slam._pending_queries = [("stale",)]
    slam._pending_loops = [("stale",)]
    slam._lost_streak = 5
    slam.restore(path)
    assert slam._pending_reloc is None and slam._lost_streak == 0
    assert slam._pending_queries == [] and slam._pending_loops == []
    assert slam._n_kf_host == slam._kf_seq == int(
        slam.map_state.keyframes.count)
    g, d, ts = seq[4]
    fr = slam.process(g, d, ts)
    assert np.all(np.isfinite(fr.t_wc))


def test_generator_follows_the_snapshot(seq, tmp_path):
    """A port snapshot carries the generator's state; a reference one its
    key, from whose words the generator is seeded."""
    slam = SLAMSystem(PCFG, device="cpu", enable_place_recognition=False)
    _run(slam, seq[:2])
    path = str(tmp_path / "ckpt.npz")
    slam.save(path)
    gen = torch.Generator()
    psnap.load(path, "cpu", gen)
    assert torch.equal(gen.get_state(), slam.generator.get_state())
    data = {k: v for k, v in np.load(path).items()
            if not k.startswith("torch/")}
    data["tracker/rng"] = np.asarray(jax.random.key_data(
        jax.random.key(12345)))
    ref_path = str(tmp_path / "ref.npz")
    np.savez_compressed(ref_path, **data)
    psnap.load(ref_path, "cpu", gen)
    assert gen.initial_seed() == 12345
