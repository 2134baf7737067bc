"""The PyTorch port stands alone: no module of it, and not chip_smoke.py,
imports JAX or anything of the JAX package; its entry points default to the
card and raise without one; its kernels are built without fast math; and its
device stages (extraction, tracker, keyframe insert, BA) never read a value
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

from dynamic_visual_slam_tpu_torch import kernels
from dynamic_visual_slam_tpu_torch.backend import ba, mapping
from dynamic_visual_slam_tpu_torch.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.frontend import orb, tracker
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.ops import descriptors, fields
from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
from dynamic_visual_slam_tpu_torch.semantic.classes import filtered_mask

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dynamic_visual_slam_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "dynamic_visual_slam_tpu"}


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
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_top_level(f))
                                            & FORBIDDEN)
           for f in files}
    assert not {f: n for f, n in bad.items() if n}
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


def test_wrappers_take_the_plain_path_only_on_the_cpu():
    levels = [torch.zeros((1, 40, 40), device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        fields.fast_score_batch(levels)
    pad = [torch.zeros((1, 78, 78), device="meta")]
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        descriptors.descriptors_moments(pad, pad, idx, idx, idx, idx)


def test_kernel_build_flags():
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert sorted(kernels.SOURCES) == ["fast_score", "orb_desc_moments"]
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
    return dict(cfg=cfg, grays=grays, depths=depths, stamps=stamps, kps=kps,
                sampler=sampler, det=det, filt=filt, block=blocks[-1],
                state=state)


@pytest.mark.parametrize("stage", ["extract", "track", "insert", "ba"])
def test_device_stages_make_no_host_round_trip(stage_inputs, stage):
    x = stage_inputs
    cfg = x["cfg"]
    with no_host_traffic():
        if stage == "extract":
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
        else:
            state, _ = ba.run_ba(cfg, Intrinsics.from_config(cfg.camera),
                                 x["state"])
            out = mapping.prune(cfg, state.landmarks,
                                x["stamps"][-1]).active
    assert out.any()
