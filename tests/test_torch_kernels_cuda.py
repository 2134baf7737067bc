"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the device stages of the main path free of host synchronisation.

These tests need an NVIDIA GPU and skip without one.  The file imports only
the port (no JAX), so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_kernels_cuda.py

Tolerance: none for the kernels.  Scores, moments and descriptor bits are
exact in both versions (min, max and differences of float32 values;
integer-valued moments; the descriptor angle arithmetic is rounded
identically), so the kernels must equal the plain versions bit for bit.
Kernel D1 (orb_detect) outputs integers, floats holding integers and one
float32 product a coordinate, as the plain detection does: it must equal
``ops/detect.detect_levels_plain`` bit for bit too.
Kernel pnp_ransac follows the plain chain's operations in the rounding
that PyTorch and cuBLAS give them on the card (csrc/pnp_ransac.cu), and
measured bit-equal to it in every case here, poses included: its
tolerance is 0 too.
The YOLOv8n module (cuDNN convolutions, not a kernel of the port) is held
to the CPU within tests/test_torch_yolo.py's bound.
``chip_smoke.py``'s kernels phase repeats the comparison at the main
path's 720p shapes and times each kernel for the kernel table; the port's
speed end to end is measured by ``benchmark/run.py`` alone.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu_torch import kernels
from dynamic_visual_slam_tpu_torch.backend import ba, mapping
from dynamic_visual_slam_tpu_torch.config import (CameraConfig, ORBConfig,
                                                  SLAMConfig)
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.core import lie
from dynamic_visual_slam_tpu_torch.frontend import orb, ransac, tracker
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.ops import descriptors, detect, fast, fields
from dynamic_visual_slam_tpu_torch.ops import image as imops
from dynamic_visual_slam_tpu_torch.pipeline import slam
from dynamic_visual_slam_tpu_torch.place import bow
from dynamic_visual_slam_tpu_torch.semantic.classes import filtered_mask
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(2)
CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                   cx=159.5, cy=119.5)
CFG = ORBConfig()


@pytest.fixture(scope="module")
def sequence():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    seq = list(synthetic.generate_sequence(CAM, 4, seed=11,
                                           depth_noise=0.004))
    grays = torch.from_numpy(np.stack([f[0] for f in seq]).astype(np.float32))
    depths = torch.from_numpy(
        (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16))
    return grays, depths


@pytest.fixture(scope="module")
def frames(sequence):
    return sequence[0]


@pytest.mark.cuda
def test_fast_score_matches_corner_score(frames):
    levels = [lv.contiguous() for lv in imops.build_pyramid(
        frames.cuda(), CFG.n_levels, CFG.scale_factor)]
    before = kernels.launches["fast_score"]
    got = fields.fast_score_batch(levels)
    torch.cuda.synchronize()
    assert kernels.launches["fast_score"] == before + 1
    for g, lv in zip(got, levels):
        assert torch.equal(g, fast.corner_score(lv))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 9), (479, 641), (720, 1280)])
@pytest.mark.parametrize("fractional", [False, True])
def test_corner_score_auto_matches_corner_score(card, shape, fractional):
    """Kernel B3: one (H, W) image, the tile grid's ragged edges included,
    integer-valued or fractional float32."""
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape).astype(np.float32)
    if fractional:
        img += rng.random(shape).astype(np.float32)
    x = torch.from_numpy(img).to(card)
    before = dict(kernels.launches)
    got = fast.corner_score_auto(x)
    torch.cuda.synchronize()
    assert kernels.launches["corner_score"] == \
        before.get("corner_score", 0) + 1
    assert kernels.launches["fast_score"] == before.get("fast_score", 0)
    assert torch.equal(got, fast.corner_score(x))
    assert torch.equal(got.cpu(), fast.corner_score_auto(x.cpu()))


@pytest.mark.cuda
def test_descriptors_match_plain_version(frames):
    levels = [lv.contiguous() for lv in imops.build_pyramid(
        frames.cuda(), CFG.n_levels, CFG.scale_factor)]
    _, inputs = orb.detect_batch(levels, fields.fast_score_batch(levels), CFG)
    got = descriptors.descriptors_moments(*inputs)
    want = descriptors.descriptors_moments_plain(*inputs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("fractional", [False, True])
def test_fast_score_small_and_ragged_levels(card, fractional):
    """Kernel B1 in one launch over levels smaller than one 64x32 tile and
    levels with ragged tile edges, three frames each."""
    rng = np.random.default_rng(7)
    shapes = [(4, 4), (5, 7), (31, 63), (33, 65), (32, 64), (70, 129)]
    levels = []
    for h, w in shapes:
        img = rng.integers(0, 256, (3, h, w)).astype(np.float32)
        if fractional:
            img += rng.random((3, h, w)).astype(np.float32)
        levels.append(torch.from_numpy(img).to(card))
    before = kernels.launches["fast_score"]
    got = fields.fast_score_batch(levels)
    torch.cuda.synchronize()
    assert kernels.launches["fast_score"] == before + 1
    for g, lv in zip(got, levels):
        assert torch.equal(g, fast.corner_score(lv))


@pytest.mark.cuda
def test_fast_score_tiles_mixing_byte_and_other_pixels(card):
    """B1 takes its packed 16-bit branch only on tiles whose staged pixels
    are all integers in [0, 255]: here fractional pixels, values outside
    [0, 255] and a negative zero fall in some tiles of a level (across tile
    boundaries and halos), the rest are bytes."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (2, 100, 150)).astype(np.float32)
    img[0, 20:40, 50:80] += 0.5                      # straddles a tile edge
    img[0, 63, 10] = 256.0                           # in a halo row
    img[1, 70:75, 120:140] = -3.0
    img[1, 5, 5] = -0.0
    levels = [torch.from_numpy(img).to(card),
              torch.from_numpy(np.round(img[:, ::2, ::2])).to(card)]
    got = fields.fast_score_batch(levels)
    torch.cuda.synchronize()
    for g, lv in zip(got, levels):
        assert torch.equal(g, fast.corner_score(lv))


def _descriptor_inputs(card, n_kp, seed=3):
    """Padded blurred/raw levels of 2 frames x 3 levels and n_kp keypoints:
    the first ones at the four corners of each level (the padded border)
    and padding slots at (level 0, frame 0, 0, 0), the rest random."""
    rng = np.random.default_rng(seed)
    sizes = [(48, 64), (40, 53), (33, 44)]
    pad = descriptors.SAMPLE_PAD
    blur, raw = [], []
    for h, w in sizes:
        img = torch.from_numpy(rng.integers(0, 256, (2, h, w)).astype(
            np.float32)).to(card)
        raw.append(imops.reflect_pad(img, pad).contiguous())
        smooth = torch.clamp(torch.round(imops.gaussian_blur(img, 7, 2.0)),
                             0.0, 255.0)
        blur.append(imops.reflect_pad(smooth, pad).contiguous())
    fixed = [(lvl, f, y, x) for lvl, (h, w) in enumerate(sizes) for f in (0, 1)
             for y, x in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1))]
    fixed += [(0, 0, 0, 0)] * 5
    rows = []
    for i in range(n_kp):
        if i < len(fixed):
            rows.append(fixed[i])
        else:
            lvl = int(rng.integers(0, 3))
            h, w = sizes[lvl]
            rows.append((lvl, int(rng.integers(0, 2)), int(rng.integers(0, h)),
                         int(rng.integers(0, w))))
    kp = torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).to(card)
    return (blur, raw) + tuple(kp[:, i].contiguous() for i in range(4))


@pytest.mark.cuda
@pytest.mark.parametrize("n_kp", [0, 1, 29, 37, 1000])
def test_descriptors_border_padding_and_ragged_counts(card, n_kp):
    """Kernel B2 on keypoints at the padded border, padding slots at (0, 0),
    K not a multiple of the warps a block, and K = 0 (no launch)."""
    inputs = _descriptor_inputs(card, n_kp)
    before = kernels.launches["orb_desc_moments"]
    got = descriptors.descriptors_moments(*inputs)
    want = descriptors.descriptors_moments_plain(*inputs)
    torch.cuda.synchronize()
    assert kernels.launches["orb_desc_moments"] == before + (n_kp > 0)
    assert got[0].shape == (n_kp, 256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_extract_batch_on_the_card_equals_the_cpu(frames):
    k_gpu = orb.extract_batch(frames.cuda(), CFG)
    k_cpu = orb.extract_batch(frames, CFG)
    for name in ("uv", "response", "octave", "mask", "desc_bits",
                 "desc_packed"):
        assert torch.equal(getattr(k_gpu, name).cpu(), getattr(k_cpu, name))
    # atan2 of identical moments in two libraries
    assert float((k_gpu.angle.cpu() - k_cpu.angle).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(frames):
    lv = frames.cuda()
    with pytest.raises(ValueError):
        fields.fast_score_batch([lv.double()])
    with pytest.raises(ValueError):
        fields.fast_score_batch([lv[:, :, ::2]])
    with pytest.raises(ValueError):
        fields.fast_score_batch([lv, lv.cpu()])


@pytest.mark.cuda
def test_device_stages_do_not_synchronise(sequence):
    """Extraction, both trackers, keyframe insert, BA, BoW add and query,
    loop verification and the pose-graph loop correction on the card with
    torch's sync debug mode set to raise: none of them waits for the
    device."""
    dev = torch.device("cuda")
    cfg = SLAMConfig().replace(camera=CAM)
    grays, depths = (t.to(dev) for t in sequence)
    stamps = torch.arange(len(grays), dtype=torch.float32, device=dev) / 30.0
    k = Intrinsics.from_config(cfg.camera)
    det = mapping.Detections.empty(cfg.semantic.max_detections, dev)
    filt = filtered_mask(cfg, dev)
    sampler = tracker.generator_sampler(
        torch.Generator(device=dev).manual_seed(0))
    state0, map0 = tracker.init_state(cfg, dev), mapping.init_map(cfg, dev)

    vocab = Path(__file__).resolve().parent.parent / "assets" \
        / "orbvoc_synth.npz"
    db = bow.Database(bow.load_vocabulary(str(vocab), dev), capacity=16)

    def run():
        kps = orb.extract_batch(grays, cfg.orb)
        _, out = tracker.track_batch(cfg, state0, kps, depths, stamps,
                                     sampler)
        tracker.track_step(cfg, state0, grays[0], depths[0], stamps[0],
                           sampler)
        state = map0
        blocks = [tracker.KeyframeBlock(*(a[i] for a in out.keyframe))
                  for i in range(len(grays))]
        for kf in blocks:
            state, _ = mapping.insert_keyframe(cfg, state, kf, det, filt)
        a, b = blocks[-1], blocks[0]
        db.add(b.desc_bits, b.mask)
        db.query(a.desc_bits, a.mask, top_k=4)
        _, q, t, _ = slam.verify_loop(cfg, k, a.desc_bits, a.uv, a.mask,
                                      b.desc_bits, b.uv, b.mask, b.xyz_w, 7)
        slam.apply_loop_pgo(cfg, state0, state, q, t, 0, 3)
        state, res = ba.run_ba(cfg, k, state)
        return mapping.prune(cfg, state.landmarks, stamps[-1]), res

    run()                       # first use: builds, caches, library handles
    torch.cuda.synchronize()
    before = kernels.launches["pnp_ransac"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        landmarks, res = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # both trackers and the verification went through the PnP kernel
    assert kernels.launches["pnp_ransac"] > before
    assert bool(landmarks.active.any())
    assert float(res.final_cost) <= float(res.initial_cost)


@pytest.mark.cuda
def test_yolo_on_the_card_matches_the_cpu(card):
    """YOLOv8n with the shipped weights on one rendered 720p walker frame,
    letterboxed to 640: per scale, box and class logits within 2 % of the
    scale's largest magnitude (tests/test_torch_yolo.py's bound against the
    reference: cuDNN sums in another order, and a bf16 activation can round
    to its neighbour), and the same detection classes."""
    from dynamic_visual_slam_tpu_torch import convert
    from dynamic_visual_slam_tpu_torch.models import yolov8
    from dynamic_visual_slam_tpu_torch.semantic.detector import letterbox

    params = convert.load_params(str(Path(__file__).resolve().parent.parent
                                     / "assets" / "yolov8n_synth.npz"))
    cpu = yolov8.YOLOv8()
    cpu.load_state_dict(convert.yolo_state_dict(params))
    cpu.eval()
    gpu = yolov8.YOLOv8()
    gpu.load_state_dict(convert.yolo_state_dict(params))
    gpu.eval().cuda()
    cam = SLAMConfig().camera
    gray = next(synthetic.generate_dynamic_sequence(cam, 1, seed=0))[0]
    canvas = letterbox(np.stack([gray] * 3, -1), 640, "cpu")[0]
    x = canvas.permute(2, 0, 1)[None]
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.cuda())
    for (wb, wc), (gb, gc) in zip(want, got):
        for w, g in ((wb, gb), (wc, gc)):
            assert float((g.cpu() - w).abs().max()) <= \
                0.02 * float(w.abs().max())
    dw = yolov8.detect(cpu, canvas)
    dg = yolov8.detect(gpu, canvas.cuda())
    assert sorted(dg.classes[dg.valid].tolist()) == \
        sorted(dw.classes[dw.valid].tolist())


@pytest.mark.cuda
def test_training_step_on_the_card_matches_the_cpu(card):
    """One semantic/train.train_step (detection_loss, backward, the
    optax-equivalent AdamW) from yolov8.init_params at input size 128 on 4
    rendered images, on the card and on the CPU: the loss and each
    parameter's gradient within tests/test_torch_train.py's bounds against
    the reference (7.9e-7 relative; 0.0515, norm of the difference over the
    norm), every parameter updated and finite."""
    from dynamic_visual_slam_tpu_torch import convert
    from dynamic_visual_slam_tpu_torch.models import yolov8
    from dynamic_visual_slam_tpu_torch.semantic import train

    init = yolov8.init_params(torch.Generator().manual_seed(0))
    batch = [torch.from_numpy(a) for a in train.render_pool(4, 128, seed=1)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = train.trainable_model(init, dev)
        opt = train.OptaxAdamW(model.parameters(), 1e-3, 10)
        opt.zero_grad()
        loss, _ = train.detection_loss(model, *(t.to(dev) for t in batch),
                                       128)
        loss.backward()
        grads = {n: p.grad.cpu().clone() for n, p in model.named_parameters()}
        opt.step()
        out[dev] = (float(loss.detach()), grads, convert.yolo_params(
            model.state_dict()))
    (lg, gg, pg), (lc, gc, _) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 7.9e-7 * abs(lc)
    for name, g in gc.items():
        assert float((gg[name] - g).norm() / g.norm()) <= 0.0515, name
    for a, b in zip(_leaves(pg), _leaves(init)):
        if isinstance(b, np.ndarray):
            assert np.isfinite(a).all() and not np.array_equal(a, b)


@pytest.mark.cuda
def test_training_steps_repeat_bit_for_bit_on_the_card(card):
    """Three semantic/train.train_step updates from yolov8.init_params at
    input size 128 on 4 rendered images, twice: every parameter equal bit
    for bit (cuDNN's deterministic algorithms in the step)."""
    from dynamic_visual_slam_tpu_torch.models import yolov8
    from dynamic_visual_slam_tpu_torch.semantic import train

    init = yolov8.init_params(torch.Generator().manual_seed(0))
    batch = [torch.from_numpy(a).cuda()
             for a in train.render_pool(4, 128, seed=1)]
    runs = []
    for _ in range(2):
        model = train.trainable_model(init, "cuda")
        opt = train.OptaxAdamW(model.parameters(), 1e-3, 10)
        for _ in range(3):
            train.train_step(model, opt, *batch, 128)
        runs.append({n: p.detach().cpu() for n, p in
                     model.named_parameters()})
    for name, p in runs[0].items():
        assert torch.equal(p, runs[1][name]), name


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module")
def fleet_levels(card):
    """The fleet's shape: one extraction of B = 8 streams at 720p, each
    stream's frame from the 6-frame 720p cycle, offset by its index."""
    cam = SLAMConfig().camera
    seq = [g for g, *_ in synthetic.generate_sequence(cam, 6, seed=3)]
    grays = torch.from_numpy(np.stack([seq[s % 6] for s in range(8)])
                             .astype(np.float32)).to(card)
    return [lv.contiguous() for lv in imops.build_pyramid(
        grays, CFG.n_levels, CFG.scale_factor)]


@pytest.mark.cuda
def test_fast_score_at_the_fleet_shape(fleet_levels):
    """Kernel B1 on B = 8 frames x 8 levels of 720p (22,824,704 px), one
    launch: bit-equal to its plain version."""
    assert sum(lv.numel() for lv in fleet_levels) == 22_824_704
    before = kernels.launches["fast_score"]
    got = fields.fast_score_batch(fleet_levels)
    torch.cuda.synchronize()
    assert kernels.launches["fast_score"] == before + 1
    for g, lv in zip(got, fleet_levels):
        assert torch.equal(g, fast.corner_score(lv))


@pytest.mark.cuda
def test_descriptors_at_the_fleet_shape(fleet_levels):
    """Kernel B2 on the fleet's 8 x 1024 keypoint slots, one launch:
    bit-equal to its plain version."""
    _, inputs = orb.detect_batch(fleet_levels,
                                 fields.fast_score_batch(fleet_levels), CFG)
    assert inputs.level.numel() == 8 * CFG.max_keypoints
    before = kernels.launches["orb_desc_moments"]
    got = descriptors.descriptors_moments(*inputs)
    want = descriptors.descriptors_moments_plain(*inputs)
    torch.cuda.synchronize()
    assert kernels.launches["orb_desc_moments"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_fleet_step_does_not_synchronise(sequence):
    """The fleet's step, step_batch and BA on the card (2 streams at
    320x240) with torch's sync debug mode set to raise (the fleets are
    built before: construction uploads its tables)."""
    from dynamic_visual_slam_tpu_torch.parallel.mesh import SLAMFleet
    dev = torch.device("cuda")
    cfg = SLAMConfig().replace(camera=CAM)
    grays, depths = (t.to(dev) for t in sequence)
    g = grays.reshape(2, 2, *grays.shape[1:])
    d = depths.reshape(2, 2, *depths.shape[1:])
    s = torch.arange(4, dtype=torch.float32, device=dev).reshape(2, 2) / 30

    def run(fleet):
        fleet.step(g[0], d[0], s[0], auto_ba=False)
        fleet.step_batch(g, d, s, auto_ba=False)
        return fleet.run_ba(0.5)

    first, second = (SLAMFleet(cfg, 2, kf_slots=2, device=dev)
                     for _ in range(2))
    run(first)
    torch.cuda.synchronize()
    before = kernels.launches["pnp_ransac"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        costs = run(second)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(costs).all())
    # two PnP calls a scan step (frame to frame, anchored), three steps
    assert kernels.launches["pnp_ransac"] - before == 2 * 3


def _fleet_on_a_mesh(sequence, devices):
    """step_batch and run_ba of a 2-stream fleet on ``devices`` against the
    one-device fleet, both on tests/test_torch_mesh.py's keyed draws:
    positions within 1e-6 m, flags equal, B1 and B2 launched once a shard a
    scan step and the PnP kernel twice, each shard's work on its own card,
    the outputs on the first."""
    from test_torch_mesh import keyed_sampler
    from dynamic_visual_slam_tpu_torch.parallel import mesh
    cfg = SLAMConfig().replace(camera=CAM)
    grays, depths = sequence
    g = grays.reshape(2, 2, *grays.shape[1:])
    d = depths.reshape(2, 2, *depths.shape[1:])
    s = torch.arange(4, dtype=torch.float32).reshape(2, 2) / 30
    one = mesh.SLAMFleet(cfg, 2, device="cuda", sampler=keyed_sampler)
    want = one.step_batch(g, d, s, auto_ba=False)
    m = mesh.make_mesh(devices=devices)
    fleet = mesh.SLAMFleet(cfg, 2, m, sampler=keyed_sampler)
    before = dict(kernels.launches)
    got = fleet.step_batch(g, d, s, auto_ba=False)
    torch.cuda.synchronize()
    for name, per_step in (("fast_score", 1), ("orb_desc_moments", 1),
                           ("pnp_ransac", 2)):
        assert kernels.launches[name] - before.get(name, 0) \
            == per_step * 2 * 2, name
    assert fleet.stream_devices() == list(m.devices)
    assert [sh.tracker_states.q_wc.device for sh in fleet.shards] == \
        list(m.devices)
    assert got.device == m.devices[0]
    err = (got[..., 4:7] - want[..., 4:7].to(got.device)).norm(dim=-1)
    assert float(err.max()) < 1e-6
    assert torch.equal(got[..., 7:9], want[..., 7:9].to(got.device))
    costs = fleet.run_ba(0.5)
    assert costs.device == m.devices[0]
    assert bool(torch.isfinite(costs).all())


@pytest.mark.cuda
def test_fleet_on_a_two_entry_mesh_of_one_card(sequence):
    """make_mesh(devices=["cuda:0"] * 2): two shards, one thread each, on
    one card."""
    _fleet_on_a_mesh(sequence, ["cuda:0"] * 2)


@pytest.mark.cuda
def test_fleet_on_two_cards(sequence):
    """One shard a card, where the machine has two."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _fleet_on_a_mesh(sequence, ["cuda:0", "cuda:1"])


@pytest.mark.cuda
def test_batches_on_the_card_equal_host_arrays(card):
    """process_batch fed batches already on the card gives the poses and
    flags, bit for bit, of the same batches as host arrays (320x240, the
    6-frame cycle of seed 3, 4 batches of 8, sync_every 3, place
    recognition off)."""
    cycle = [(g.astype(np.uint8), (d * 1000.0).astype(np.uint16))
             for g, d, _, _, _ in synthetic.generate_sequence(CAM, 6, seed=3)]
    batches = []
    for i0 in range(0, 32, 8):
        idx = [(i0 + j) % 6 for j in range(8)]
        batches.append((np.stack([cycle[i][0] for i in idx]),
                        np.stack([cycle[i][1] for i in idx]),
                        (i0 + np.arange(8)) / 30.0))

    def run(batches):
        s = slam.SLAMSystem(SLAMConfig().replace(camera=CAM),
                            enable_place_recognition=False, sync_every=3,
                            device="cuda")
        for gs, ds, tss in batches:
            s.process_batch(gs, ds, tss)
        s.finalize()
        torch.cuda.synchronize()
        return s.frontend_trajectory()[2], [
            (f.is_keyframe, f.tracking_ok) for f in s.trajectory]

    want_t, want_f = run(batches)
    got_t, got_f = run([(torch.from_numpy(gs).cuda(),
                         torch.from_numpy(ds).cuda(), tss)
                        for gs, ds, tss in batches])
    assert len(got_t) == 32
    np.testing.assert_array_equal(got_t, want_t)
    assert got_f == want_f


# --- kernel pnp_ransac against pnp_ransac_plain ------------------------------
PNP_K = Intrinsics(535.4, 539.2, 320.1, 247.6)


def _pnp_scene(seed, b, n, valid=0.6, outliers=0.25):
    """b two-view problems of n slots on the card: points in front of the
    first camera, their noisy pixels in the second, a share moved far off,
    a share masked out; the true motion as a prior."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -1.5, 1.0], [2, 1.5, 6.0], (b, n, 3)).astype(
        np.float32)
    rv = torch.from_numpy((rng.normal(size=(b, 3)) * 0.05).astype(np.float32))
    tv = (rng.normal(size=(b, 3)) * 0.1).astype(np.float32)
    r = lie.rodrigues(rv).numpy()
    cam = np.einsum("bij,bnj->bni", r, pts) + tv[:, None]
    kk = np.array([[PNP_K.fx, 0, PNP_K.cx], [0, PNP_K.fy, PNP_K.cy],
                   [0, 0, 1]])
    uv = ((cam / cam[..., 2:]) @ kk.T)[..., :2] \
        + rng.normal(size=(b, n, 2)) * 0.5
    off = rng.random((b, n)) < outliers
    uv[off] += rng.uniform(10, 200, size=(int(off.sum()), 2))
    mask = rng.random((b, n)) < valid
    dev = torch.device("cuda")
    return (torch.from_numpy(pts).to(dev),
            torch.from_numpy(uv.astype(np.float32)).to(dev),
            torch.from_numpy(mask).to(dev),
            lie.so3_exp(rv).to(dev), torch.from_numpy(tv).to(dev))


def _pnp_both(xyz, uv, mask, samples, prior, **kw):
    extra = dict(prior_q=prior[0], prior_t=prior[1]) if prior else {}
    before = kernels.launches["pnp_ransac"]
    got = ransac.pnp_ransac(PNP_K, xyz, uv, mask, samples=samples, **extra,
                            **kw)
    want = ransac.pnp_ransac_plain(PNP_K, xyz, uv, mask, samples, **extra,
                                   **kw)
    torch.cuda.synchronize()
    assert kernels.launches["pnp_ransac"] == before + 1
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1024), (8, 1024), (24, 1024),
                                 (8, 512)])
@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("threshold", [4.0, 12.0])
def test_pnp_ransac_matches_plain_version(card, b, n, prior, threshold):
    """The tracker's shapes (192 hypotheses, 10 refinement steps a pass):
    poses, inlier masks, counts and flags bit-equal."""
    xyz, uv, mask, q, t = _pnp_scene(b * 7 + n, b, n)
    gen = torch.Generator(device=card).manual_seed(b + n)
    samples = ransac.sample_indices(gen, 192, 6, mask.sum(-1))
    got = _pnp_both(xyz, uv, mask, samples, (q, t) if prior else None,
                    threshold=threshold, refine_iters=10)
    assert bool(got.valid.all())


@pytest.mark.cuda
def test_pnp_ransac_unbatched_as_verify_loop(card):
    """verify_loop's call: one unbatched problem of 512 slots, threshold
    12, no prior."""
    xyz, uv, mask, _, _ = _pnp_scene(5, 1, 512)
    gen = torch.Generator(device=card).manual_seed(5)
    samples = ransac.sample_indices(gen, 192, 6, mask[0].sum()[None])[0]
    got = _pnp_both(xyz[0], uv[0], mask[0], samples, None, threshold=12.0)
    assert got.q.shape == (4,) and got.inliers.shape == (512,)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_masked", "five_valid",
                                  "all_outliers"])
def test_pnp_ransac_degenerate_inputs(card, case):
    """Nothing to fit: equal exactly; fewer than 6 valid points is never
    valid."""
    xyz, uv, mask, q, t = _pnp_scene(11, 4, 1024)
    if case == "all_masked":
        mask = torch.zeros_like(mask)
    elif case == "five_valid":
        mask = (torch.arange(1024, device=card) < 5).expand(4, -1).clone()
    else:
        uv = torch.rand(uv.shape, generator=torch.Generator(
            device=card).manual_seed(1), device=card) * 1e4 - 5e3
    gen = torch.Generator(device=card).manual_seed(3)
    samples = ransac.sample_indices(gen, 192, 6, mask.sum(-1))
    got = _pnp_both(xyz, uv, mask, samples, (q, t))
    if case != "all_outliers":
        assert not bool(got.valid.any())


@pytest.mark.cuda
def test_pnp_ransac_wrapper_rejects_what_the_kernel_does_not_take(card):
    xyz, uv, mask, q, t = _pnp_scene(2, 2, 64)
    smp = torch.zeros((2, 8, 6), dtype=torch.int64, device=card)
    bad = [dict(xyz=xyz.double()), dict(uv=uv[..., :1]),
           dict(mask=mask.to(torch.uint8)), dict(samples=smp.int()),
           dict(samples=smp[:1]), dict(xyz=xyz.cpu()),
           dict(prior_q=q), dict(prior_q=q[:, :3], prior_t=t),
           dict(xyz=xyz[:, :0], uv=uv[:, :0], mask=mask[:, :0]),
           dict(samples=torch.zeros((2, 50_000, 6), dtype=torch.int64,
                                    device=card))]
    for change in bad:
        args = dict(xyz=xyz, uv=uv, mask=mask, samples=smp)
        args.update(change)
        with pytest.raises(ValueError):
            ransac.pnp_ransac(PNP_K, **args)


# ---------------------------------------------------------------------------
# Kernel D1 (ops/detect.detect_levels): the keypoints of every level
# ---------------------------------------------------------------------------

def _detect_both(scores, cfg=CFG):
    """D1 against its plain version on the card: every slot tensor equal."""
    spec = detect.detect_spec(cfg)
    before = kernels.launches["orb_detect"]
    got = detect.detect_levels(scores, spec)
    want = detect.detect_levels_plain(scores, spec)
    torch.cuda.synchronize()
    assert kernels.launches["orb_detect"] == before + 1
    assert set(got) == set(want)
    for k in detect.SLOT_KEYS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k
    return got


def _scores_of(grays):
    levels = [lv.contiguous() for lv in imops.build_pyramid(
        grays, CFG.n_levels, CFG.scale_factor)]
    return fields.fast_score_batch(levels)


def _rendered(card, w, h, n, seed):
    cam = CameraConfig(width=w, height=h, fx=0.8 * w, fy=0.8 * w,
                       cx=(w - 1) / 2, cy=(h - 1) / 2)
    return torch.from_numpy(np.stack([g for g, *_ in synthetic.generate_sequence(
        cam, n, seed=seed)]).astype(np.float32)).to(card)


@pytest.fixture(scope="module")
def frames_720p(card):
    """24 distinct 720p frames: 6 rendered ones and their mirror images."""
    x = _rendered(card, 1280, 720, 6, seed=3)
    return torch.cat([x, x.flip(-1), x.flip(-2), x.flip(-1, -2)]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 24])
def test_orb_detect_matches_plain_at_720p(frames_720p, b):
    got = _detect_both(_scores_of(frames_720p[:b]))
    assert got["uv"].shape == (b, CFG.max_keypoints, 2)
    assert int(got["mask"].sum()) > b * CFG.n_features // 2


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(640, 480), (424, 240), (96, 64)])
def test_orb_detect_matches_plain_at_other_sizes(card, w, h):
    """640x480 (TUM), 424x240 (vocabulary training, the tools) and a tiny
    frame whose coarse levels hold fewer candidates than their quotas."""
    scores = _scores_of(_rendered(card, w, h, 1, seed=5))
    _detect_both(scores)
    short = [q > 8 * hc * wc for q, (hc, wc) in zip(
        detect.detect_spec(CFG).quotas,
        (detect.cell_grid(*s.shape[1:]) for s in scores))]
    assert any(short) == ((w, h) == (96, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero", "constant", "weak", "dense255",
                                  "random"])
def test_orb_detect_matches_plain_on_made_maps(card, case):
    """Score maps made to reach each branch, 3 frames at 424x240's levels:
    no peak; all ties (every pixel a peak and its cell's best); only weak
    corners (every score <= 20, so every cell falls back to 7); dense 255s;
    random bytes (cells with and without a strong corner side by side)."""
    rng = np.random.default_rng(17)
    shapes = imops.pyramid_shapes(240, 424, CFG.n_levels, CFG.scale_factor)
    make = {"zero": lambda s: np.zeros(s),
            "constant": lambda s: np.full(s, 10.0),
            "weak": lambda s: rng.integers(0, 21, s),
            "dense255": lambda s: np.full(s, 255.0),
            "random": lambda s: rng.integers(0, 256, s)}[case]
    scores = [torch.from_numpy(make((3,) + s).astype(np.float32)).to(card)
              for s in shapes]
    got = _detect_both(scores)
    n = int(got["mask"].sum())
    assert (n == 0) == (case == "zero")


@pytest.mark.cuda
def test_extract_batch_with_d1_equals_the_plain_detection(frames_720p,
                                                          monkeypatch):
    """extract_batch's whole Keypoints with D1 against the same call with
    the plain detection on the card; the tracer counts B x 8 levels on the
    kernel's route and none on the plain one."""
    imgs = frames_720p[:8]
    before = kernels.launches["orb_detect"]
    TRACER.enable(syncs=False)
    got = orb.extract_batch(imgs, CFG)
    torch.cuda.synchronize()
    s = TRACER.disable()
    assert kernels.launches["orb_detect"] == before + 1
    assert s.counters["extract.detect.kernel"] == 8 * CFG.n_levels
    assert s.counters.get("extract.detect.plain", 0) == 0
    monkeypatch.setattr(detect, "detect_levels", detect.detect_levels_plain)
    want = orb.extract_batch(imgs, CFG)
    torch.cuda.synchronize()
    for name in orb.Keypoints._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_orb_detect_wrapper_rejects_what_the_kernel_does_not_take(card):
    spec = detect.detect_spec(ORBConfig(n_features=40, n_levels=2,
                                        max_keypoints=48))
    good = [torch.zeros(2, 24, 32, device=card),
            torch.zeros(2, 20, 27, device=card)]
    for bad in ([good[0], good[1].cpu()], [good[0].double(), good[1]],
                [good[0][0], good[1]], [good[0][:, :, ::2], good[1]],
                good[:1]):
        with pytest.raises(ValueError):
            detect.detect_levels(bad, spec)
    _detect_both(good, ORBConfig(n_features=40, n_levels=2, max_keypoints=48))
