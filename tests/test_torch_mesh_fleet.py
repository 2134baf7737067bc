"""PyTorch port vs the JAX reference: the fleet split over a mesh of two
devices, on the CPU.

The reference runs ``SLAMFleet(CFG, batch=2, mesh=make_mesh(2))`` on two
devices of the virtual CPU mesh (tests/conftest.py), one stream a device;
the port runs ``SLAMFleet(PCFG, 2, make_mesh(devices=["cpu"] * 2))``, one
stream a shard and a thread, fed the reference fleet's own draws
(torch_parity.JaxFleetSampler: stream s starts at fold_in(key(0), s)).
The fixture is tests/test_torch_fleet.py's (160x120, 14 frames, sequence
seeds 3 and 7, every tracked frame a keyframe); the reference fleet's jit
takes about 50 s here, hence a file of its own.

Tolerances: tests/test_torch_fleet.py's, and for the same reasons (the
split changes neither side's arithmetic a stream: the port's mesh fleet
equals its one-device fleet bit for bit, tests/test_torch_mesh.py):
flags, feature and match counts equal, F-RANSAC inliers within 2, frame
positions within 1e-4 m, quaternions within 1e-5, keyframe counts and
active landmarks equal, the landmark arenas equal slot for slot with
positions within 1e-3 m, BA final costs within 5e-5 relative.  The
reference fleet's states carried across (``convert`` then
``shard_batch``) equal its per-device shards exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fleet import CFG, N, PCFG, _rows, frames  # noqa: F401
from torch_parity import JaxFleetSampler, to_numpy_tree

from dynamic_visual_slam_tpu.parallel import mesh as jmesh
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(frames):
    """Both fleets on two-device meshes through ``step`` (no BA tick),
    then one ``run_ba``."""
    grays, depths, stamps = frames
    ref = jmesh.SLAMFleet(CFG, batch=2, mesh=jmesh.make_mesh(2))
    port = pmesh.SLAMFleet(PCFG, 2, pmesh.make_mesh(devices=["cpu"] * 2),
                           sampler=JaxFleetSampler(2, N))
    rows = []
    for i in range(N):
        jo = ref.step(jnp.asarray(grays[i]), jnp.asarray(depths[i]),
                      jnp.asarray(stamps[i]), auto_ba=False)
        po = port.step(grays[i], depths[i], stamps[i], auto_ba=False)
        rows.append((_rows(jo), _rows(po)))
    before = (ref.stats(), port.stats())
    maps = (to_numpy_tree(ref.map_states), convert.to_numpy(port.map_states))
    costs = (np.asarray(ref.run_ba()), port.run_ba().numpy())
    return dict(ref=ref, port=port, rows=rows, stats=before, maps=maps,
                costs=costs)


def test_mesh_streams_match_reference(runs):
    rows = runs["rows"]
    get = lambda k, f: np.stack([r[k][f] for r in rows])  # noqa: E731
    for f in ("is_keyframe", "tracking_ok", "n_features", "n_matches"):
        np.testing.assert_array_equal(get(1, f), get(0, f), err_msg=f)
    assert np.abs(get(1, "n_inliers") - get(0, "n_inliers")).max() <= 2
    err = np.linalg.norm(get(1, "t_wc") - get(0, "t_wc"), axis=-1)
    q_err = np.abs(get(1, "q_wc") - get(0, "q_wc")).max(-1)
    print(f"mesh fleet positions: worst {err.max() * 1e3:.4f} mm; "
          f"quaternions within {q_err.max():.2e}")
    assert err.max() < 1e-4
    assert q_err.max() < 1e-5
    jst, pst = runs["stats"]
    for k in ("streams", "keyframes", "landmarks_active",
              "keyframes_dropped"):
        assert pst[k] == jst[k], k
    # each side's states live one stream a device
    assert len(runs["ref"].tracker_states.t_wc.sharding.device_set) == 2
    assert [(s.lo, s.hi) for s in runs["port"].shards] == [(0, 1), (1, 2)]


def test_mesh_landmark_arena_matches_reference(runs):
    jm, pm = runs["maps"]
    jl, pl = jm["landmarks"], pm["landmarks"]
    for f in ("active", "category", "n_obs", "obs_valid", "obs_kf"):
        np.testing.assert_array_equal(pl[f], jl[f], err_msg=f)
    act = jl["active"]
    err = np.abs(pl["xyz"][act] - jl["xyz"][act]).max()
    print(f"mesh fleet landmarks: {int(act.sum())} active, positions within "
          f"{err * 1e3:.4f} mm")
    assert err < 1e-3


def test_mesh_run_ba_costs_match_reference(runs):
    jc, pc = runs["costs"]
    assert pc.shape == jc.shape == (2,)
    rel = np.abs(pc - jc) / np.abs(jc)
    print(f"mesh BA final costs: relative {rel.max():.2e}")
    assert rel.max() < 5e-5


def _chunks_equal(ref_tree, port_parts, path):
    """Each of the port's leaves (the reference's of the same name): the
    reference's per-device shards, by their row offset, equal the port's
    chunks, device for device."""
    for name in port_parts[0]._fields:
        leaf = getattr(ref_tree, name)
        parts = [getattr(p, name) for p in port_parts]
        if hasattr(leaf, "_fields"):
            _chunks_equal(leaf, parts, f"{path}.{name}")
            continue
        shards = sorted(leaf.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(shards) == len(parts), path
        for s, p in zip(shards, parts):
            np.testing.assert_array_equal(p.numpy(), np.asarray(s.data),
                                          err_msg=f"{path}.{name}")


def test_reference_states_carry_across_shard_for_shard(runs):
    """``shard_batch(convert.map_state(...), mesh)``: the reference fleet's
    map and tracker states on make_mesh(2), carried into the port and
    split over its mesh, equal the reference's per-device shards chunk for
    chunk (the tracker's key has no leaf in the port's state: the port's
    fleet keeps a generator a shard)."""
    ref = runs["ref"]
    m = pmesh.make_mesh(devices=["cpu"] * 2)
    ms = pmesh.shard_batch(convert.map_state(to_numpy_tree(ref.map_states)),
                           m)
    assert [p.landmarks.xyz.shape[0] for p in ms] == [1, 1]
    _chunks_equal(ref.map_states, ms, "map_states")
    ts = pmesh.shard_batch(convert.tracker_state(
        to_numpy_tree(ref.tracker_states)), m)
    _chunks_equal(ref.tracker_states, ts, "tracker_states")
