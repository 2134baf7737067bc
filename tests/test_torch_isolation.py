"""The PyTorch port stands alone: no module of it, not chip_smoke.py and
not its evaluation scripts (``scripts/torch_parity_sweep.py``,
``torch_loop720p.py``, ``torch_ood_eval.py``) imports JAX, optax, anything
of the JAX package or the reference's root ``bench`` module; its entry
points (the three evaluations among them) default to the card and raise
without one; it reads no environment variable but ``CUDA_HOME``,
``DVS_SERVE_HOLD_S`` and ``DVS_ORACLE_DEBUG``; its kernels are built
without fast math; and its
device stages (extraction, both trackers, keyframe insert, BA, BoW add and
query, loop verification, the pose-graph loop correction, the detector's
network and NMS, the fleet's step, step_batch, BA and detector) never read
a value
back to the host nor build a tensor from host data, either of which makes
the host wait for the card (tests/test_torch_kernels_cuda.py checks the same
on the card with torch's sync debug mode)."""

import ast
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dynamic_visual_slam_tpu_torch import convert, kernels
from dynamic_visual_slam_tpu_torch.backend import ba, mapping
from dynamic_visual_slam_tpu_torch.config import (CameraConfig, ORBConfig,
                                                  SLAMConfig)
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.evaluation import (loop720p, ood,
                                                      parity_sweep)
from dynamic_visual_slam_tpu_torch.frontend import orb, ransac, tracker
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.models import yolov8
from dynamic_visual_slam_tpu_torch.ops import descriptors, detect, fields
from dynamic_visual_slam_tpu_torch.parallel import mesh
from dynamic_visual_slam_tpu_torch.pipeline import slam as pslam
from dynamic_visual_slam_tpu_torch.pipeline import snapshot, wire
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
from dynamic_visual_slam_tpu_torch.place import bow
from dynamic_visual_slam_tpu_torch.semantic.classes import filtered_mask

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dynamic_visual_slam_tpu_torch"
# "bench": the reference's root benchmark, which imports the JAX package
FORBIDDEN = {"jax", "jaxlib", "optax", "dynamic_visual_slam_tpu", "bench"}
EVAL_SCRIPTS = ("torch_parity_sweep.py", "torch_loop720p.py",
                "torch_ood_eval.py")
# the nvcc location (kernels.py), the live view's hold after a run (cli
# run --serve) and the CPU oracle's trace of its IRLS rounds
ENVIRONMENT = {"CUDA_HOME", "DVS_SERVE_HOLD_S", "DVS_ORACLE_DEBUG"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_top_level(path: Path):
    """Top-level names of every absolute import in the file."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value).split(".")[0])
    return names


def test_no_jax_or_reference_imports():
    files = _port_files()
    assert len(files) > 20
    for new in ("place/bow.py", "backend/pose_graph.py", "io/synthetic.py",
                "convert.py", "pipeline/slam.py", "models/yolov8.py",
                "semantic/detector.py", "pipeline/runner.py",
                "pipeline/sync.py", "cli.py", "io/tum.py", "utils/viz.py",
                "utils/profiling.py", "pipeline/wire.py",
                "pipeline/snapshot.py", "parallel/mesh.py",
                "models/convert_ultralytics.py", "place/pretrain.py",
                "semantic/train.py", "native/__init__.py", "native/build.py",
                "utils/serve.py", "oracle/ba_cpu.py",
                "oracle/pipeline_cpu.py",
                "evaluation/__init__.py", "evaluation/parity_sweep.py",
                "evaluation/loop720p.py", "evaluation/ood.py"):
        assert PORT / new in files, new
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_top_level(f))
                                            & FORBIDDEN)
           for f in files}
    assert not {f: n for f, n in bad.items() if n}
    # the port builds and loads its own native runtime, never the
    # reference's committed library
    for f in files + sorted((PORT / "native").iterdir()):
        if f.suffix in (".py", ".cpp"):
            text = f.read_text()
            assert "libdvsruntime.so" not in text, f
            assert "dynamic_visual_slam_tpu/native" not in text, f
    # the prefix is shared, so the comparison above must be exact
    assert "dynamic_visual_slam_tpu_torch" in _imported_top_level(
        ROOT / "chip_smoke.py")


def test_importing_the_port_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            + f"{sorted(FORBIDDEN)!r}]\n"
            + "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SLAMSystem(SLAMConfig().replace(
            camera=SLAMConfig().camera.scaled(160, 120)))


def _environment_reads(path: Path):
    """Names the file reads from the environment (``os.environ[...]``,
    ``os.environ.get``/``pop``/``setdefault``, ``os.getenv``); a name that
    is not a constant, or any other use of ``os.environ``, as "?"."""
    def is_environ(node):
        return isinstance(node, ast.Attribute) and node.attr == "environ"

    names, environ_reads, environ_uses = [], 0, 0
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        environ_uses += is_environ(node)
        key = None
        if isinstance(node, ast.Subscript) and is_environ(node.value):
            key, environ_reads = node.slice, environ_reads + 1
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute):
            f = node.func
            if f.attr in ("get", "pop", "setdefault") and is_environ(
                    f.value):
                environ_reads += 1
            elif f.attr != "getenv":
                continue
            key = node.args[0] if node.args else None
        else:
            continue
        names.append(key.value if isinstance(key, ast.Constant)
                     and isinstance(key.value, str) else "?")
    return names + ["?"] * (environ_uses - environ_reads)


def test_the_port_reads_only_documented_environment_variables():
    """No knob of the port's own changes what it computes or measures: the
    three names it reads are listed above and in README.md."""
    reads = {str(f.relative_to(ROOT)): sorted(set(_environment_reads(f)))
             for f in sorted(PORT.rglob("*.py"))}
    seen = set().union(*reads.values())
    assert seen == ENVIRONMENT, {f: r for f, r in reads.items()
                                 if set(r) - ENVIRONMENT}
    readme = (ROOT / "README.md").read_text()
    assert all(name in readme for name in ENVIRONMENT)


def test_evaluation_scripts_import_only_the_port_and_default_to_the_card(
        monkeypatch, tmp_path):
    for name in EVAL_SCRIPTS:
        path = ROOT / "scripts" / name
        names = set(_imported_top_level(path))
        assert "dynamic_visual_slam_tpu_torch" in names, name
        assert not names & FORBIDDEN, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="cuda"):
        parity_sweep.main(["--out", str(out)])
    with pytest.raises(RuntimeError, match="cuda"):
        loop720p.main(["--out", str(out / "loop.json")])
    with pytest.raises(RuntimeError, match="cuda"):
        ood.main([])
    assert not out.exists()


def test_fleet_and_state_io_default_to_the_card(monkeypatch, tmp_path):
    cfg = SLAMConfig().replace(camera=SLAMConfig().camera.scaled(160, 120))
    slam = SLAMSystem(cfg, device="cpu", enable_place_recognition=False)
    path = str(tmp_path / "ckpt.npz")
    slam.save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.SLAMFleet(cfg, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.sharded_detector_apply(convert.load_params(
            str(ROOT / "assets" / "yolov8n_synth.npz")))
    with pytest.raises(RuntimeError, match="cuda"):
        snapshot.load(path)
    with pytest.raises(RuntimeError, match="cuda"):
        wire.decode(b"\x00" * 64, capacity=8)


def test_make_mesh_raises_without_a_card(monkeypatch):
    """The fleet's mesh takes CUDA devices unless the caller lists CPU
    ones: with no card it raises, and never shrinks to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.SLAMFleet(SLAMConfig().replace(
            camera=SLAMConfig().camera.scaled(160, 120)), 2,
            mesh.make_mesh(devices=["cuda:0"] * 2))
    assert mesh.make_mesh(devices=["cpu"]).devices == (torch.device("cpu"),)


def test_wrappers_take_the_plain_path_only_on_the_cpu():
    levels = [torch.zeros((1, 40, 40), device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        fields.fast_score_batch(levels)
    with pytest.raises(ValueError, match="unsupported device"):
        detect.detect_levels(levels, detect.detect_spec(ORBConfig(n_levels=1)))
    pad = [torch.zeros((1, 78, 78), device="meta")]
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        descriptors.descriptors_moments(pad, pad, idx, idx, idx, idx)
    k = Intrinsics(500.0, 500.0, 320.0, 240.0)
    pts = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ransac.pnp_ransac(k, pts, pts[..., :2],
                          torch.zeros((1, 8), dtype=torch.bool, device="meta"),
                          samples=torch.zeros((1, 4, 6), dtype=torch.int64,
                                              device="meta"))


def test_kernel_build_flags():
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    # kernel B3 (ops/fast.corner_score_auto) launches B1's source
    assert sorted(kernels.SOURCES) == ["fast_score", "orb_desc_moments",
                                       "orb_detect", "pnp_ransac"]
    for src in kernels.SOURCES.values():
        text = (kernels.CSRC / src).read_text()
        assert "Replaces:" in text and "bounds it on the H100" in text
        assert "roundf(" not in text


class HostRoundTrip(TorchDispatchMode):
    """Raise on every tensor op that reads a value back to the host or
    builds a tensor from host data: on the card each of these makes the host
    wait for the device (an H2D copy from pageable memory synchronises
    too)."""

    SYNCING = {"_local_scalar_dense", "is_nonzero", "equal", "allclose",
               "nonzero", "masked_select", "_unique", "_unique2",
               "unique_dim", "unique_consecutive", "bincount", "histc",
               "lift_fresh", "linalg_cholesky", "linalg_inv", "linalg_solve",
               "cholesky", "inverse"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bool_index = name in ("index", "index_put", "index_put_",
                              "_index_put_impl_") and any(
            t is not None and t.dtype == torch.bool for t in args[1])
        if name in self.SYNCING or bool_index:
            raise AssertionError(f"host round trip: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_traffic():
    """HostRoundTrip, plus the host reads that do not dispatch an op."""
    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"host round trip: {name}")
        return call
    saved = [(torch.Tensor, name, getattr(torch.Tensor, name))
             for name in ("tolist", "cpu", "numpy")]
    try:
        for owner, name, _ in saved:
            setattr(owner, name, refuse(name))
        with HostRoundTrip():
            yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@pytest.fixture(scope="module")
def stage_inputs():
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5)
    cfg = SLAMConfig().replace(camera=cam)
    seq = list(synthetic.generate_sequence(cam, 8, seed=11,
                                           depth_noise=0.004))
    grays = torch.from_numpy(np.stack([f[0] for f in seq]).astype(np.uint8))
    depths = torch.from_numpy(
        (np.stack([f[1] for f in seq]) * 1000.0).astype(np.uint16))
    stamps = torch.arange(8, dtype=torch.float32) / 30.0
    kps = orb.extract_batch(grays, cfg.orb)
    sampler = tracker.generator_sampler(torch.Generator().manual_seed(0))
    _, out = tracker.track_batch(cfg, tracker.init_state(cfg, "cpu"), kps,
                                 depths, stamps, sampler)
    det = mapping.Detections.empty(cfg.semantic.max_detections, "cpu")
    filt = filtered_mask(cfg, "cpu")
    blocks = [tracker.KeyframeBlock(*(a[i] for a in out.keyframe))
              for i in range(8)]
    state = mapping.init_map(cfg, "cpu")
    for kf in blocks[:-1]:
        state, _ = mapping.insert_keyframe(cfg, state, kf, det, filt)
    db = bow.Database(bow.load_vocabulary(
        str(ROOT / "assets" / "orbvoc_synth.npz"), "cpu"), capacity=16)
    db.add(blocks[0].desc_bits, blocks[0].mask)
    yolo = yolov8.YOLOv8()
    yolo.load_state_dict(convert.yolo_state_dict(convert.load_params(
        str(ROOT / "assets" / "yolov8n_synth.npz"))))
    canvas = torch.rand((128, 128, 3), generator=torch.Generator()
                        .manual_seed(0))
    fleet_frames = (grays[:4].reshape(2, 2, *grays.shape[1:]),
                    depths[:4].reshape(2, 2, *depths.shape[1:]),
                    stamps[:4].reshape(2, 2))
    return dict(yolo=yolo.eval(), canvas=canvas, fleet_frames=fleet_frames,
                cfg=cfg, grays=grays, depths=depths, stamps=stamps, kps=kps,
                sampler=sampler, det=det, filt=filt, blocks=blocks,
                block=blocks[-1], state=state, db=db,
                tstate=tracker.init_state(cfg, "cpu"))


@pytest.mark.parametrize("stage", ["extract", "track", "insert", "ba",
                                   "track_step", "bow", "verify", "pgo",
                                   "detect", "fleet_step", "fleet_batch",
                                   "fleet_ba", "fleet_detect"])
def test_device_stages_make_no_host_round_trip(stage_inputs, stage):
    x = stage_inputs
    cfg = x["cfg"]
    if stage.startswith("fleet"):
        fleet = mesh.SLAMFleet(cfg, 2, kf_slots=2, device="cpu")
        grays, depths, stamps = x["fleet_frames"]
        if stage == "fleet_ba":
            fleet.step_batch(grays, depths, stamps, auto_ba=False)
        elif stage == "fleet_detect":
            detect = fleet.make_detector(convert.load_params(
                str(ROOT / "assets" / "yolov8n_synth.npz")), input_size=64)
    with no_host_traffic():
        if stage == "fleet_step":
            out = fleet.step(grays[0], depths[0], stamps[0],
                             auto_ba=False).keyframe.mask
        elif stage == "fleet_batch":
            fleet.step_batch(grays, depths, stamps, auto_ba=False)
            out = fleet.map_states.landmarks.active
        elif stage == "fleet_ba":
            out = torch.isfinite(fleet.run_ba(0.5))
        elif stage == "fleet_detect":
            res = detect(grays[0])
            out = res.mask | ~res.mask
        elif stage == "extract":
            out = orb.extract_batch(x["grays"], cfg.orb).mask
        elif stage == "track":
            _, res = tracker.track_batch(
                cfg, tracker.init_state(cfg, "cpu"), x["kps"], x["depths"],
                x["stamps"], x["sampler"])
            out = res.is_keyframe
        elif stage == "insert":
            state, _ = mapping.insert_keyframe(cfg, x["state"], x["block"],
                                               x["det"], x["filt"])
            out = state.landmarks.active
        elif stage == "ba":
            state, _ = ba.run_ba(cfg, Intrinsics.from_config(cfg.camera),
                                 x["state"])
            out = mapping.prune(cfg, state.landmarks,
                                x["stamps"][-1]).active
        elif stage == "track_step":
            _, res = tracker.track_step(
                cfg, x["tstate"], x["grays"][0], x["depths"][0],
                x["stamps"][0], x["sampler"])
            out = res.keyframe.mask
        elif stage == "detect":
            res = yolov8.detect(x["yolo"], x["canvas"], 32)
            out = res.valid | ~res.valid
        elif stage == "bow":
            b = x["block"]
            x["db"].add(b.desc_bits, b.mask)
            out = x["db"].query(b.desc_bits, b.mask, top_k=4).valid
        else:
            a, b = x["blocks"][-1], x["blocks"][-3]
            k = Intrinsics.from_config(cfg.camera)
            n_inl, q, t, _ = pslam.verify_loop(
                cfg, k, a.desc_bits, a.uv, a.mask, b.desc_bits, b.uv, b.mask,
                b.xyz_w, 7)
            out = n_inl > 0
            if stage == "pgo":
                _, state = pslam.apply_loop_pgo(cfg, x["tstate"], x["state"],
                                                q, t, 2, 5)
                out = state.keyframes.active
    assert out.any()
