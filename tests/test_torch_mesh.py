"""The port's fleet over a mesh of devices, port against port, on the CPU:
``parallel/mesh.make_mesh``, ``batch_sharding``, ``shard_batch`` and
``replicate``; ``SLAMFleet`` and ``sharded_detector_apply`` split over a
two-entry CPU mesh (``make_mesh(devices=["cpu"] * 2)``, one shard a thread)
against the one-device fleet; ``kernels.count`` under threads.  The
reference's fleet on its own mesh is in tests/test_torch_mesh_fleet.py.

The fleet fixture is tests/test_parallel.py's at 160x120 (a map of 256
landmarks, 8 keyframes, 128 observations a keyframe), 4 streams (sequence
seeds 3, 7, 11 and 5), 8 frames, both fleets on one keyed sampler
(``keyed_sampler``: the minimal sets of (stream, frame, stage) drawn from a
generator seeded with that key), so that the split cannot change a draw.

Tolerances, and why:
- ``step`` and ``step_batch`` on the mesh against one device: telemetry,
  flags, counts and positions equal, bit for bit (each stream's arithmetic
  is the same; the batched ops run on 2 streams a shard instead of 4).
  Measured equal under MKL_CBWR AVX2, AVX512 and COMPATIBLE, each with
  ATEN_CPU_CAPABILITY default and avx2, this file run alone on an AVX-512
  host.
- ``run_ba``: each stream's final cost within 1e-5 relative.  The LM's
  batched float32 reductions run over 2 streams instead of 4 and round in
  another order; measured 0 to 1.24e-6 under the six settings above.
- the detector on the mesh against one device: equal detections (the
  network's convolutions on 2 images instead of 4), measured equal under
  the same settings.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu_torch import convert, kernels
from dynamic_visual_slam_tpu_torch.backend import mapping
from dynamic_visual_slam_tpu_torch.config import (CameraConfig, MapConfig,
                                                  SLAMConfig)
from dynamic_visual_slam_tpu_torch.frontend import orb, ransac
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.models import yolov8
from dynamic_visual_slam_tpu_torch.parallel import mesh

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = SLAMConfig().replace(
    camera=CAM,
    map=MapConfig(max_landmarks=256, max_keyframes=8,
                  max_obs_per_landmark=4, max_obs_per_keyframe=128))
SEEDS = (3, 7, 11, 5)
B, N = len(SEEDS), 8
FIELDS = ("t_wc", "q_wc", "is_keyframe", "tracking_ok", "n_features",
          "n_matches", "n_inliers", "n_pnp_inliers")
BA_REL = 1e-5
WEIGHTS = "assets/yolov8n_synth.npz"
STAGES = ("fm", "pnp", "anchor")


def keyed_sampler(stage, streams, frame_ids, n_hyp, size, count):
    """A fleet sampler keyed by (stream, frame, stage): one generator a
    draw, so shards in threads share nothing."""
    out = []
    for i, (s, f) in enumerate(zip(streams.tolist(), frame_ids.tolist())):
        gen = torch.Generator(device=count.device)
        gen.manual_seed((s * 1_000_003 + f) * len(STAGES)
                        + STAGES.index(stage))
        out.append(ransac.sample_indices(gen, n_hyp, size, count[i:i + 1]))
    return torch.cat(out)


def cpu_mesh(n=2):
    return mesh.make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def frames():
    """(grays (N, B, H, W) uint8, depths (N, B, H, W) f32 m, stamps (N, B))."""
    seqs = [list(synthetic.generate_sequence(CAM, N, seed=s)) for s in SEEDS]
    grays = np.stack([[q[i][0] for q in seqs] for i in range(N)]
                     ).astype(np.uint8)
    depths = np.stack([[q[i][1] for q in seqs] for i in range(N)]
                      ).astype(np.float32)
    stamps = np.asarray([[q[i][4] for q in seqs] for i in range(N)],
                        np.float32)
    return grays, depths, stamps


@pytest.fixture(scope="module")
def runs(frames):
    """One-device and mesh fleets through ``step`` then ``run_ba``, and
    through one ``step_batch``."""
    grays, depths, stamps = frames
    out = {}
    for name, kw in (("one", dict(device="cpu")), ("mesh", dict(
            mesh=cpu_mesh()))):
        fleet = mesh.SLAMFleet(CFG, B, sampler=keyed_sampler, **kw)
        rows = [fleet.step(grays[i], depths[i], stamps[i], auto_ba=False)
                for i in range(N)]
        stats = fleet.stats()
        trees = {name: convert.to_numpy(getattr(fleet, name))
                 for name in ("tracker_states", "map_states")}
        costs = fleet.run_ba(1.0)
        batch = mesh.SLAMFleet(CFG, B, kf_slots=N, sampler=keyed_sampler,
                               **kw)
        telems = batch.step_batch(grays, depths, stamps, auto_ba=False)
        out[name] = dict(fleet=fleet, rows=rows, stats=stats, trees=trees,
                         costs=costs,
                         stats_ba=fleet.stats(), batch=batch, telems=telems,
                         stats_batch=batch.stats())
    return out


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def test_make_mesh_lists_its_devices():
    m = cpu_mesh()
    assert m.size == 2 and m.axis == "dp"
    assert m.devices == (torch.device("cpu"),) * 2
    m = mesh.make_mesh(3, axis="x", devices=["cpu"] * 3)
    assert (m.size, m.axis) == (3, "x")
    with pytest.raises(ValueError, match="n_devices"):
        mesh.make_mesh(2, devices=["cpu"])


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (mesh.make_mesh, lambda: mesh.make_mesh(1),
                 lambda: mesh.make_mesh(devices=["cuda:0"])):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_make_mesh_raises_with_too_few_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.make_mesh().devices == (torch.device("cuda", 0),)
    assert mesh.make_mesh(devices=["cuda:0"] * 2).devices == \
        (torch.device("cuda", 0),) * 2
    with pytest.raises(RuntimeError, match="2 cuda devices asked for, 1"):
        mesh.make_mesh(2)
    with pytest.raises(RuntimeError, match=r"\[1\] asked for"):
        mesh.make_mesh(devices=["cuda:0", "cuda:1"])


@pytest.mark.parametrize("devices", [["cpu", "cuda:0"], ["meta"], []])
def test_make_mesh_rejects_mixed_or_other_devices(devices):
    with pytest.raises(ValueError):
        mesh.make_mesh(devices=devices)


def test_batch_sharding_names_the_split():
    m = cpu_mesh()
    s = mesh.batch_sharding(m)
    assert s.bounds(8) == [(0, 4), (4, 8)]
    assert s.mesh is m and s.axis == "dp"
    with pytest.raises(ValueError, match="does not split"):
        s.bounds(5)
    with pytest.raises(ValueError, match="axis"):
        mesh.batch_sharding(m, "mp")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_batch_splits_the_leading_dim(n):
    m = cpu_mesh(n)
    rng = np.random.default_rng(0)
    det = mapping.Detections(
        boxes=rng.random((8, 3, 4), np.float32),
        category=torch.arange(24).reshape(8, 3),
        score=torch.tensor(0.5), mask=None)
    parts = mesh.shard_batch(det, m)
    assert len(parts) == n
    for i, p in enumerate(parts):
        assert isinstance(p, mapping.Detections) and p.mask is None
        assert p.boxes.shape == (8 // n, 3, 4)
        assert p.boxes.device == m.devices[i]
        np.testing.assert_array_equal(p.boxes.numpy(),
                                      det.boxes[i * 8 // n:(i + 1) * 8 // n])
        assert torch.equal(p.category, det.category[i * 8 // n:
                                                    (i + 1) * 8 // n])
        assert p.score.ndim == 0 and float(p.score) == 0.5
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(np.zeros((6, 2)), cpu_mesh(4))


def test_replicate_copies_to_every_device():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [torch.ones(3)]}
    parts = mesh.replicate(tree, cpu_mesh(3))
    assert len(parts) == 3
    for p in parts:
        np.testing.assert_array_equal(p["w"].numpy(), tree["w"])
        assert torch.equal(p["b"][0], tree["b"][0])


# ---------------------------------------------------------------------------
# The fleet on a mesh against one device
# ---------------------------------------------------------------------------

def test_fleet_holds_its_streams_on_the_shards(runs):
    fleet = runs["mesh"]["fleet"]
    assert [(s.lo, s.hi) for s in fleet.shards] == [(0, 2), (2, 4)]
    assert fleet.stream_devices() == [torch.device("cpu")] * B
    assert [s.generator.initial_seed() for s in fleet.shards] == [0, 2]
    for s in fleet.shards:
        assert s.tracker_states.q_wc.shape == (2, 4)
        assert s.map_states.landmarks.xyz.shape[0] == 2
    assert fleet.tracker_states.q_wc.shape == (B, 4)
    one = runs["one"]["fleet"]
    assert len(one.shards) == 1
    assert one.map_states is one.shards[0].map_states
    with pytest.raises(ValueError, match="does not split"):
        mesh.SLAMFleet(CFG, 3, cpu_mesh())


def test_fleet_step_on_a_mesh_matches_one_device(runs):
    one, two = runs["one"], runs["mesh"]
    for i, (a, b) in enumerate(zip(one["rows"], two["rows"])):
        for f in FIELDS:
            torch.testing.assert_close(getattr(b, f), getattr(a, f),
                                       rtol=0, atol=0, msg=f"{f}, frame {i}")
    assert two["stats"] == one["stats"]
    assert one["stats"]["keyframes"] == [N] * B
    for name, want in one["trees"].items():
        _assert_tree_equal(two["trees"][name], want, name)


def _assert_tree_equal(got, want, path):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_tree_equal(got[k], w, f"{path}.{k}")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}.{k}")


def test_fleet_run_ba_on_a_mesh_matches_one_device(runs):
    one, two = runs["one"], runs["mesh"]
    a, b = one["costs"].numpy(), two["costs"].numpy()
    assert a.shape == b.shape == (B,)
    rel = np.abs(b - a) / np.abs(a)
    print(f"BA costs on the mesh against one device: {rel.max():.2e}")
    assert rel.max() < BA_REL
    assert two["stats_ba"]["ba_runs"] == 1
    assert len(two["stats_ba"]["last_ba_costs"]) == B
    np.testing.assert_allclose(two["stats_ba"]["last_ba_costs"], b)


def test_fleet_step_batch_on_a_mesh_matches_one_device(runs):
    one, two = runs["one"], runs["mesh"]
    assert two["telems"].shape == (N, B, 10)
    torch.testing.assert_close(two["telems"], one["telems"], rtol=0, atol=0)
    assert two["stats_batch"] == one["stats_batch"]
    assert two["stats_batch"]["keyframes_dropped"] == [0] * B
    # step_batch runs the per-frame program: its poses are step()'s
    t_step = torch.stack([r.t_wc for r in one["rows"]])
    assert float((t_step - two["telems"][..., 4:7]).norm(dim=-1).max()) \
        < 1e-6


def test_kf_slots_drop_count_in_stream_order(frames):
    """3 slots over 8 frames keep 3 a stream and drop 5, every stream's
    count in its place in stream order."""
    grays, depths, stamps = frames
    fleet = mesh.SLAMFleet(CFG, B, cpu_mesh(), kf_slots=3,
                           sampler=keyed_sampler)
    fleet.step_batch(grays, depths, stamps, auto_ba=False)
    st = fleet.stats()
    assert st["keyframes_dropped"] == [5] * B
    assert st["keyframes"] == [3] * B


def test_extract_shards_match_the_per_frame_extractor(frames):
    """Each shard extracts its own frames, B/n a device, equal to
    ``orb.extract`` frame by frame (tests/test_parallel.py's shard-shape
    test)."""
    grays = frames[0][0]
    fleet = mesh.SLAMFleet(CFG, B, cpu_mesh(), sampler=keyed_sampler)
    shards = fleet.extract_shards(grays)
    assert len(shards) == 2
    for i, kps in enumerate(shards):
        for leaf in kps:
            assert leaf.shape[0] == B // 2
            assert leaf.device == fleet.shards[i].device
        for j in range(B // 2):
            want = orb.extract(torch.from_numpy(grays[i * 2 + j]), CFG.orb)
            for f in ("desc_bits", "mask", "uv", "octave"):
                assert torch.equal(getattr(kps, f)[j], getattr(want, f)), f


def test_a_shard_exception_reaches_the_caller(frames):
    """A sampler that raises in shard 1 (its streams 2 and 3) makes step
    and step_batch raise that exception once both shards' threads have
    joined."""
    grays, depths, stamps = frames

    class Boom(RuntimeError):
        pass

    def sampler(stage, streams, *args):
        if int(streams[0]) >= 2:
            raise Boom(f"shard of streams {streams.tolist()}")
        return keyed_sampler(stage, streams, *args)
    fleet = mesh.SLAMFleet(CFG, B, cpu_mesh(), sampler=sampler)
    with pytest.raises(Boom, match=r"\[2, 3\]"):
        fleet.step(grays[0], depths[0], stamps[0], auto_ba=False)
    with pytest.raises(Boom):
        fleet.step_batch(grays[:2], depths[:2], stamps[:2], auto_ba=False)


def _detector_frames():
    return np.stack([g for g, *_ in synthetic.generate_dynamic_sequence(
        CAM, 16, seed=0)][::4])


def test_make_detector_on_a_mesh_matches_one_device():
    params = convert.load_params(WEIGHTS)
    grays = _detector_frames()
    got = mesh.SLAMFleet(CFG, B, cpu_mesh()).make_detector(params)(grays)
    want = mesh.SLAMFleet(CFG, B, device="cpu").make_detector(params)(grays)
    assert got.boxes.shape == (B, CFG.semantic.max_detections, 4)
    print(f"mesh detector: {int(want.mask.sum())} detections")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_sharded_detector_apply_on_a_mesh():
    """tests/test_parallel.py's batched inference: (B, 160, 160, 3) on the
    mesh → boxes (B, 32, 4), equal to one device's."""
    params = yolov8.init_params(torch.Generator().manual_seed(0))
    m = cpu_mesh()
    imgs = torch.from_numpy(np.random.default_rng(0).random(
        (B, 160, 160, 3), np.float32))
    got = mesh.sharded_detector_apply(params, m, input_size=160)(imgs)
    want = mesh.sharded_detector_apply(params, input_size=160,
                                       device="cpu")(imgs)
    assert got.boxes.shape == (B, 32, 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_launch_counts_stay_exact_under_threads():
    """kernels.count from 8 threads with a short switch interval: no count
    is lost."""
    per, n_threads = 2000, 8
    kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernels.count("probe") for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launches["probe"] == per * n_threads
    kernels.reset_launch_counts()


def test_threads_reaching_an_unbuilt_kernel_build_it_once(monkeypatch):
    """kernels.entry from 8 threads at once: one build (of every kernel,
    their nvcc processes together) and one load (a stand-in build that
    sleeps and a stand-in library), one entry point for all."""
    import types
    calls = []

    def build(names):
        calls.append(list(names))
        threading.Event().wait(0.05)

    def cdll(path):
        lib = types.SimpleNamespace()
        setattr(lib, kernels.ENTRY["fast_score"], types.SimpleNamespace())
        return lib
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", cdll)
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(kernels.entry("fast_score")))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert calls == [list(kernels.SOURCES)]
    assert len(got) == 8 and all(g is got[0] for g in got)
