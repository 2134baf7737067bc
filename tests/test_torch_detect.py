"""Kernel D1's wrapper (``ops/detect.detect_levels``) on the CPU, where it
takes the plain route.

- The CPU route equals ``detect_level`` run a level and its slots
  concatenated and zero-padded as ``frontend/orb.detect_batch`` did before
  the kernel (the assembly is written out here), exactly, on every slot
  tensor: the 8 levels of a 1280x720 and of a 424x240 synthetic frame, and
  of a 96x64 frame whose coarse levels have fewer candidates than their
  quotas.
- It counts the frames x levels it detected under ``extract.detect.plain``,
  and ``extract_batch`` runs it under the span ``extract.detect``.
- It raises on a wrong dtype, a wrong rank, maps on two devices,
  a non-contiguous map and a wrong number of levels.
- Everything the kernel is given comes from the ORB config (``detect_spec``)
  and the maps' shapes (``cell_grid``).

The card's route is held to the plain one in
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu_torch.config import CameraConfig, ORBConfig
from dynamic_visual_slam_tpu_torch.frontend import orb
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.ops import detect, fast
from dynamic_visual_slam_tpu_torch.ops import image as imops
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(2)
CFG = ORBConfig()


@pytest.fixture(autouse=True)
def tracer_off():
    TRACER.disable()
    yield
    TRACER.disable()


def _scores(w, h, n_frames=1, seed=3):
    cam = CameraConfig(width=w, height=h, fx=0.8 * w, fy=0.8 * w,
                       cx=(w - 1) / 2, cy=(h - 1) / 2)
    grays = np.stack([g for g, *_ in synthetic.generate_sequence(
        cam, n_frames, seed=seed)]).astype(np.float32)
    levels = imops.build_pyramid(torch.from_numpy(grays), CFG.n_levels,
                                 CFG.scale_factor)
    return [fast.corner_score(lv).contiguous() for lv in levels]


def _assembled(scores, cfg):
    """detect_level a level, then the concatenation and zero padding that
    frontend/orb.detect_batch wrote out before kernel D1."""
    quotas = orb.features_per_level(cfg)
    parts = []
    for lvl, (score, quota) in enumerate(zip(scores, quotas)):
        ys, xs, resp = orb.detect_level(score, quota, float(cfg.ini_th_fast),
                                        float(cfg.min_th_fast))
        uv = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], -1) \
            * cfg.scale_factor ** lvl
        parts.append(dict(uv=uv, response=resp, ys=ys, xs=xs,
                          octave=torch.full_like(ys, lvl), mask=resp > 0))
    cat = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    b, n = cat["mask"].shape
    pad = cfg.max_keypoints - n
    if pad > 0:
        cat = {k: torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
               for k, v in cat.items()}
    return cat


@pytest.mark.parametrize("w,h", [(1280, 720), (424, 240), (96, 64)])
def test_cpu_route_equals_detect_level_assembled(w, h):
    scores = _scores(w, h)
    spec = detect.detect_spec(CFG)
    got = detect.detect_levels(scores, spec)
    want = _assembled(scores, CFG)
    assert set(got) == set(want) == set(detect.SLOT_KEYS)
    for k in detect.SLOT_KEYS:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert got["uv"].shape == (1, CFG.max_keypoints, 2)
    n_cand = [8 * hc * wc for hc, wc in
              (detect.cell_grid(*s.shape[1:]) for s in scores)]
    short = [q > n for q, n in zip(spec.quotas, n_cand)]
    if (w, h) == (96, 64):
        # the coarse levels have fewer candidates than their quotas: the
        # plain version pads them with candidate 0's position, response -1
        assert any(short)
        lvl = short.index(True)
        lo = sum(spec.quotas[:lvl])
        tail = got["response"][0, lo + n_cand[lvl]:lo + spec.quotas[lvl]]
        assert tail.numel() and bool((tail == -1).all())
    else:
        assert not any(short)
    assert int(got["mask"].sum()) > 0


def test_cpu_route_counts_plain_and_extract_spans_it():
    scores = _scores(160, 120, n_frames=2)
    TRACER.enable(syncs=False)
    detect.detect_levels(scores, detect.detect_spec(CFG))
    s = TRACER.disable()
    assert s.counters["extract.detect.plain"] == 2 * CFG.n_levels
    assert "extract.detect.kernel" not in s.counters

    imgs = torch.full((3, 120, 160), 7.0)
    TRACER.enable(syncs=False)
    kp = orb.extract_batch(imgs, CFG)
    s = TRACER.disable()
    assert s.counters["extract.detect.plain"] == 3 * CFG.n_levels
    assert s.spans["extract.detect"]["calls"] == 1
    parent = {r.name: s.records[r.parent].name for r in s.records
              if r.parent >= 0}
    assert parent["extract.detect"] == "extract"
    assert kp.mask.shape == (3, CFG.max_keypoints) and not bool(kp.mask.any())


@pytest.mark.parametrize("fault", ["dtype", "rank", "devices",
                                   "non_contiguous", "levels"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault):
    scores = [torch.zeros(2, 24, 32), torch.zeros(2, 20, 27)]
    cfg = ORBConfig(n_features=40, n_levels=2, max_keypoints=48)
    spec = detect.detect_spec(cfg)
    if fault == "dtype":
        scores[1] = scores[1].double()
    elif fault == "rank":
        scores[0] = scores[0][0]
    elif fault == "devices":
        scores[1] = torch.empty(2, 20, 27, device="meta")
    elif fault == "non_contiguous":
        scores[0] = torch.zeros(2, 24, 64)[:, :, ::2]
    else:
        scores = scores[:1]
    with pytest.raises(ValueError):
        detect.detect_levels(scores, spec)
    detect.detect_levels([torch.zeros(2, 24, 32), torch.zeros(2, 20, 27)],
                         spec)


@pytest.mark.parametrize("cfg", [
    ORBConfig(),
    ORBConfig(n_features=500, n_levels=4, scale_factor=1.5,
              max_keypoints=256),
])
def test_spec_comes_from_the_config_alone(cfg):
    spec = detect.detect_spec(cfg)
    assert spec == detect.detect_spec(cfg)
    assert spec.quotas == tuple(orb.features_per_level(cfg))
    assert len(spec.quotas) == cfg.n_levels
    assert sum(spec.quotas) == cfg.n_features
    assert spec.n_out == max(cfg.n_features, cfg.max_keypoints)
    assert spec.scales == tuple(cfg.scale_factor ** lvl
                                for lvl in range(cfg.n_levels))
    assert (spec.ini_th, spec.min_th) == (float(cfg.ini_th_fast),
                                          float(cfg.min_th_fast))
    if cfg == ORBConfig():
        assert spec.quotas == (217, 181, 151, 126, 105, 87, 73, 60)
        assert spec.n_out == 1024
    # a level's cells: 35-px tiles anchored at (0, 0), the ragged edge
    # counted, a level smaller than a cell one cell
    assert detect.cell_grid(720, 1280) == (21, 37)
    assert detect.cell_grid(35, 70) == (1, 2)
    assert detect.cell_grid(20, 7) == (1, 1)
