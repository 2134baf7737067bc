"""The multi-stream fleet: B independent camera streams split over a mesh of
devices, one shard a device.

Port of the reference package's ``parallel/mesh.py``.  The reference is a
single controller: one process, a mesh of devices, and ``jit`` with
``NamedSharding`` placing every leaf's leading (stream) dim over the mesh.
The port keeps that API and that process model.  A ``Mesh`` is a list of
``torch.device``s; ``shard_batch`` splits a tree's leading dim into
contiguous chunks, chunk i on ``devices[i]``, and ``replicate`` copies a
tree to every device.  There is no global sharded tensor: both return a
tuple of per-device trees.  A mesh may list one device more than once
(``["cpu"] * 2``, ``["cuda:0"] * 2``): the counterpart of the reference's
virtual CPU mesh.

``SLAMFleet`` holds one shard a mesh entry, each with B/n streams on its
device.  A shard runs the one-device fleet body: every device stage runs
once for its streams, extraction is one ``orb.extract_batch`` call (one
launch each of kernels B1 and B2 for its frames), tracking is
``tracker.track_streams``, the keyframe insert and BA are vmapped programs
selected per stream on the device; no stage loops over the streams on the
host, and none reads a device value.  The shards run concurrently, one host
thread each (PyTorch releases the interpreter lock inside each op's
dispatch, as ``torch.nn.parallel.parallel_apply`` relies on), inside
``torch.cuda.device(shard.device)``; a one-shard mesh runs inline, so that
``mesh=None`` (one device) is the one-device fleet exactly.  Outputs are
concatenated in stream order on ``mesh.devices[0]``.

Randomness.  By default each shard's tracker stages draw every stream's
minimal sets in one call from the shard's ``generator``, seeded with the
index of the shard's first stream (shard 0 with 0), so streams draw
different samples, as the reference's per-stream keys ``fold_in(key(0),
s)`` keep them apart; the draws then depend on the split, as they depend on
B.  ``sampler`` replaces them with a callable ``sampler(stage, streams,
frame_ids, n_hyp, size, count)`` keyed by (stream, frame), all (b,) int64
with the streams' global ids, returning (b, n_hyp, size) indices; with it
the results do not depend on the split, and tests feed the reference's own
draws through it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.backend import ba as ba_mod
from dynamic_visual_slam_tpu_torch.backend import mapping
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.core import containers
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.frontend import orb, tracker
from dynamic_visual_slam_tpu_torch.models import yolov8
from dynamic_visual_slam_tpu_torch.pipeline.slam import _to_host
from dynamic_visual_slam_tpu_torch.semantic.classes import filtered_mask
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER

FleetSampler = Callable[[str, torch.Tensor, torch.Tensor, int, int,
                         torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of devices, all of one type."""

    devices: Tuple[torch.device, ...]
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Without ``devices``: the first ``n_devices`` CUDA devices (all of
    them when None).  Raises when there is no card or fewer than asked for
    (the reference's ``devs[:n]`` gives fewer without a word; a caller that
    wants as many as there are asks for ``min(n,
    torch.cuda.device_count())``).  ``devices`` lists the mesh's devices,
    one may repeat (``["cpu"] * 2`` or ``["cuda:0"] * 2``), all of one
    type, CPU or CUDA."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device "
                               "(torch.cuda.is_available() is False); pass "
                               "devices=['cpu', ...] for a mesh on the CPU")
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if n > have:
            raise RuntimeError(f"make_mesh: {n} cuda devices asked for, "
                               f"{have} present")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(torch.device(d) for d in devices)
    if n_devices is not None and int(n_devices) != len(devs):
        raise ValueError(f"make_mesh: n_devices={n_devices} but "
                         f"{len(devs)} devices listed")
    if not devs:
        raise ValueError("make_mesh: no device")
    types = {d.type for d in devs}
    if len(types) != 1 or not types <= {"cpu", "cuda"}:
        raise ValueError("make_mesh: the devices must be all CPU or all "
                         f"CUDA; got {[str(d) for d in devs]}")
    if "cuda" in types:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: cuda devices asked for but "
                               "torch.cuda.is_available() is False")
        have = torch.cuda.device_count()
        devs = tuple(torch.device("cuda", torch.cuda.current_device()
                                  if d.index is None else d.index)
                     for d in devs)
        missing = sorted({d.index for d in devs if d.index >= have})
        if missing:
            raise RuntimeError(f"make_mesh: cuda devices {missing} asked "
                               f"for, {have} present")
    return Mesh(devs, axis)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The split of a leading dim over a mesh, the counterpart of the
    reference's ``NamedSharding(mesh, P(axis))``: of n rows, chunk i
    (``bounds(n)[i]``, contiguous, n / mesh.size rows) lies on
    ``mesh.devices[i]``."""

    mesh: Mesh
    axis: str = "dp"

    def bounds(self, n: int) -> List[Tuple[int, int]]:
        """(lo, hi) of each chunk; a leading dim the mesh does not divide
        raises ValueError, as the reference's ``device_put`` rejects it."""
        size = self.mesh.size
        if n % size:
            raise ValueError(f"a leading dim of {n} does not split over a "
                             f"mesh of {size} devices")
        c = n // size
        return [(i * c, (i + 1) * c) for i in range(size)]


def batch_sharding(mesh: Mesh, axis: str = "dp") -> BatchSharding:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    return BatchSharding(mesh, axis)


def _tree_map(fn, tree):
    """``fn`` on every leaf of a tree of NamedTuples, dicts, lists and
    tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return fn(tree)


def _leaf(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(a) if a.ndim else a)


def _split(tree, mesh: Mesh, dim: int) -> Tuple[Any, ...]:
    """Per-device trees: every leaf's ``dim`` split over the mesh (a 0-dim
    leaf copied to every device); a slice already on its device is not
    copied."""
    tree = _tree_map(_leaf, tree)
    leaves: List[torch.Tensor] = []
    _tree_map(leaves.append, tree)
    sizes = {t.shape[dim] for t in leaves if t.ndim}
    if len(sizes) > 1:
        raise ValueError(f"the leaves' dim {dim} differ: {sorted(sizes)}")
    bounds = BatchSharding(mesh, mesh.axis).bounds(sizes.pop()) if sizes \
        else None

    def part(i):
        dev = mesh.devices[i]

        def one(x):
            if x.ndim == 0:
                return x.to(dev)
            lo, hi = bounds[i]
            return x.narrow(dim, lo, hi - lo).to(dev)
        return _tree_map(one, tree)
    return tuple(part(i) for i in range(mesh.size))


def shard_batch(tree: Any, mesh: Mesh, axis: str = "dp") -> Tuple[Any, ...]:
    """Every leaf (tensor or array) of ``tree`` with its leading (batch)
    dim split over ``axis`` → a tuple of per-device trees, chunk i on
    ``mesh.devices[i]``; a 0-dim leaf goes to every device, as the
    reference's ``P()``."""
    batch_sharding(mesh, axis)
    return _split(tree, mesh, 0)


def replicate(tree: Any, mesh: Mesh) -> Tuple[Any, ...]:
    """A copy of ``tree`` (tensors or arrays) on every mesh device."""
    return tuple(_tree_map(lambda x: _leaf(x).to(dev), tree)
                 for dev in mesh.devices)


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _parallel(devices: Sequence[torch.device],
              calls: Sequence[Callable[[], Any]]) -> List[Any]:
    """calls[i]() inside device i, one thread each (inline for one), →
    results in order.  A call's exception is raised after every thread has
    joined; nothing carries on with part of the mesh."""
    if len(calls) == 1:
        with _on(devices[0]):
            return [calls[0]()]
    results: List[Any] = [None] * len(calls)
    errors: List[Optional[BaseException]] = [None] * len(calls)
    grad = torch.is_grad_enabled()       # thread-local, as parallel_apply

    def work(i):
        try:
            with torch.set_grad_enabled(grad), _on(devices[i]):
                results[i] = calls[i]()
        except BaseException as e:    # re-raised in the calling thread
            errors[i] = e
    threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}")
               for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def _gather(parts: Sequence[Any], device: torch.device, dim: int = 0):
    """Per-shard trees of one type → one tree, each leaf concatenated along
    ``dim`` on ``device``; one part is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_gather([getattr(p, n) for p in parts],
                                     device, dim) for n in first._fields))
    return torch.cat([p.to(device) for p in parts], dim)


# ---------------------------------------------------------------------------
# Multi-stream SLAM fleet
# ---------------------------------------------------------------------------

def _stack(tree, b: int):
    return containers.tree_map(lambda x: x.expand((b,) + x.shape).clone(),
                               tree)


class _Shard:
    """Streams ``lo:hi`` of a fleet on ``device``: the one-device fleet
    body (tracker and map states, BA, the K-slot inserts and their drop
    count)."""

    def __init__(self, cfg: SLAMConfig, lo: int, hi: int,
                 device: torch.device, kf_slots: Optional[int],
                 k: Intrinsics, sampler: Optional[FleetSampler]):
        self.cfg = cfg
        self.lo, self.hi, self.device = lo, hi, device
        self.kf_slots = kf_slots
        self._k = k
        b = hi - lo
        self._filtered = filtered_mask(cfg, device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(lo)
        if sampler is None:
            self._sampler = tracker.generator_sampler(self.generator)
        else:
            streams = torch.arange(lo, hi)

            def bound(stage, frame_ids, n_hyp, size, count):
                return sampler(stage, streams, frame_ids, n_hyp, size,
                               count).to(device)
            self._sampler = bound
        self.tracker_states = _stack(tracker.init_state(cfg, device), b)
        self.map_states = _stack(mapping.init_map(cfg, device), b)
        self._empty_det = mapping.Detections.empty(
            cfg.semantic.max_detections, device)
        self.ba_costs: Optional[torch.Tensor] = None
        self.dropped_kf = torch.zeros(b, dtype=torch.int32, device=device)

    def _dets(self, detections, lead) -> mapping.Detections:
        if detections is None:
            return containers.tree_map(
                lambda x: x.expand(lead + x.shape), self._empty_det)
        return detections

    def extract(self, grays) -> orb.Keypoints:
        return orb.extract_batch(grays, self.cfg.orb)

    def _track(self, grays, depths, stamps, dets):
        self.tracker_states, out = tracker.track_streams(
            self.cfg, self.tracker_states, self.extract(grays), depths,
            stamps, self._sampler, det=dets, filtered=self._filtered)
        return out

    def step(self, grays, depths, stamps, detections) -> tracker.TrackOutput:
        dets = self._dets(detections, (self.hi - self.lo,))
        out = self._track(grays, depths, stamps.to(torch.float32), dets)
        self.map_states = mapping.insert_keyframe_streams(
            self.cfg, self.map_states, out.keyframe, dets, self._filtered,
            out.is_keyframe)
        return out

    def step_batch(self, grays, depths, stamps, detections) -> torch.Tensor:
        ts = stamps.to(torch.float32)
        t_dim = ts.shape[0]
        dets = self._dets(detections, (t_dim, self.hi - self.lo))
        outs = [self._track(grays[t], depths[t], ts[t],
                            containers.tree_map(lambda x: x[t], dets))
                for t in range(t_dim)]
        outs = containers.tree_stack(outs)                # leaves (T, b, ...)

        k_slots = min(t_dim, self.kf_slots or (t_dim // 4 + 2))
        flags = outs.is_keyframe.T                        # (b, T)
        order = containers.stable_partition(flags)[:, :k_slots]   # (b, K)
        valid = torch.gather(flags, 1, order)             # (b, K)
        dropped = torch.clamp(flags.sum(1) - k_slots, min=0).to(torch.int32)

        def gather_kb(a):
            # (T, b, ...) → (K, b, ...): stream j's slot k is frame order[j, k]
            return containers.bgather(a.transpose(0, 1), order, 1
                                      ).transpose(0, 1)
        kfs = containers.tree_map(gather_kb, outs.keyframe)
        dets_kb = containers.tree_map(gather_kb, dets)
        for k in range(k_slots):
            self.map_states = mapping.insert_keyframe_streams(
                self.cfg, self.map_states,
                containers.tree_map(lambda x: x[k], kfs),
                containers.tree_map(lambda x: x[k], dets_kb),
                self._filtered, valid[:, k])
        self.dropped_kf = self.dropped_kf + dropped
        return torch.cat([
            outs.q_wc, outs.t_wc,
            torch.stack([outs.tracking_ok, outs.is_keyframe, outs.n_inliers],
                        -1).to(torch.float32)], -1)       # (T, b, 10)

    def run_ba(self, now: float) -> torch.Tensor:
        new, res = ba_mod.run_ba_streams(self.cfg, self._k, self.map_states)
        with TRACER.span("ba.prune"):
            t_now = torch.full((), now, dtype=torch.float32,
                               device=self.device)
            self.map_states = new._replace(landmarks=mapping.prune_streams(
                self.cfg, new.landmarks, t_now))
        self.ba_costs = res.final_cost
        return res.final_cost

    def stats(self) -> Tuple[List[int], List[int], List[int],
                             Optional[List[float]]]:
        """(keyframes, active landmarks, dropped keyframes, last BA costs or
        None) of the shard's streams, in one host read."""
        groups = [(self.map_states.keyframes.count,
                   self.map_states.landmarks.active.sum(-1),
                   self.dropped_kf)]
        if self.ba_costs is not None:
            groups.append((self.ba_costs,))
        host = _to_host(groups)
        kf, lm, dropped = (a.astype(np.int64).tolist() for a in host[0])
        costs = host[1][0].tolist() if self.ba_costs is not None else None
        return kf, lm, dropped, costs


class SLAMFleet:
    """B independent SLAM streams split over ``mesh``, B/n a device (module
    docstring).  ``mesh=None``: a one-device mesh on ``device`` ("cuda"
    unless the caller asks for the CPU; it raises without a card).

    kf_slots: keyframe-insert slots per ``step_batch`` call (None → the
    reference's ``T // 4 + 2``, at most T); flagged frames beyond them are
    dropped, newest first, and counted in ``stats()["keyframes_dropped"]``.

    ``tracker_states`` and ``map_states`` are the B-stream trees: the
    shard's own on a one-device mesh, a copy gathered on ``devices[0]``
    otherwise; ``shards`` holds the per-device ones.
    """

    def __init__(self, cfg: SLAMConfig, batch: int,
                 mesh: Optional[Mesh] = None,
                 kf_slots: Optional[int] = None, device="cuda",
                 sampler: Optional[FleetSampler] = None):
        self.cfg = cfg
        self.batch = batch
        self.kf_slots = kf_slots
        self.mesh = make_mesh(devices=[device]) if mesh is None else mesh
        k = Intrinsics.from_config(cfg.camera)
        bounds = batch_sharding(self.mesh, self.mesh.axis).bounds(batch)
        self.shards = tuple(
            _Shard(cfg, lo, hi, dev, kf_slots, k, sampler)
            for (lo, hi), dev in zip(bounds, self.mesh.devices))
        # BA cadence (the reference's 2 s wall timer): one fleet-wide
        # decision per call from the input stamps
        self._last_ba_t: Optional[float] = None
        self.ba_runs = 0

    # ------------------------------------------------------------------
    @property
    def tracker_states(self) -> tracker.TrackerState:
        return _gather([s.tracker_states for s in self.shards],
                       self.mesh.devices[0])

    @property
    def map_states(self) -> mapping.MapState:
        return _gather([s.map_states for s in self.shards],
                       self.mesh.devices[0])

    def stream_devices(self) -> List[torch.device]:
        """The device that holds each stream, in stream order."""
        return [s.device for s in self.shards for _ in range(s.lo, s.hi)]

    def _run(self, fn, parts: Sequence[Any]) -> List[Any]:
        """fn(shard, *parts[i]) for every shard, one thread each."""
        return _parallel(
            [s.device for s in self.shards],
            [lambda s=s, p=p: fn(s, *p) for s, p in zip(self.shards, parts)])

    def extract_shards(self, grays) -> Tuple[orb.Keypoints, ...]:
        """(B, H, W) frames → each shard's Keypoints (leading dim B/n, on
        its device): one ``orb.extract_batch`` a shard, the extraction
        ``step`` runs."""
        return tuple(self._run(_Shard.extract,
                               [(g,) for g in shard_batch(grays, self.mesh,
                                                          self.mesh.axis)]))

    def _ba_tick(self, stamps, auto_ba: bool) -> None:
        if not auto_ba:
            return
        now = float(stamps.max()) if torch.is_tensor(stamps) \
            else float(np.max(stamps))
        if self._last_ba_t is None:
            self._last_ba_t = now
        elif now - self._last_ba_t >= self.cfg.ba.period_s:
            self._last_ba_t = now
            self.run_ba(now)

    def step(self, grays, depths, stamps,
             detections: Optional[mapping.Detections] = None,
             auto_ba: bool = True) -> tracker.TrackOutput:
        """(B, H, W) gray + depth (uint16 mm or float32 m) + (B,) stamps
        (+ optional Detections with leading dim B, e.g. from
        ``make_detector``) → per-stream TrackOutput (leading dim B).  With
        ``auto_ba``, a BA round (+ prune) runs for all streams when
        ``cfg.ba.period_s`` of input time has elapsed."""
        parts = _split((grays, depths, stamps, detections), self.mesh, 0)
        out = _gather(self._run(_Shard.step, parts), self.mesh.devices[0])
        self._ba_tick(stamps, auto_ba)
        return out

    def step_batch(self, grays, depths, stamps,
                   detections: Optional[mapping.Detections] = None,
                   auto_ba: bool = True) -> torch.Tensor:
        """(T, B, H, W) grays / depths + (T, B) stamps (+ optional
        Detections with leading dims (T, B)) → (T, B, 10) telemetry: q_wc,
        t_wc, tracking_ok, is_keyframe, n_inliers.  One extraction for a
        shard's streams per step of T, then the tracker; the keyframe
        inserts are deferred into K = min(T, kf_slots or T // 4 + 2) slots
        filled with each stream's FIRST K flagged frames (a stable sort:
        flags past K are dropped, newest first, and counted), K masked
        inserts in all.  A dropped frame keeps is_keyframe in the telemetry
        (the tracker flagged and anchored it) though the map never stored
        it.  BA cadence is evaluated once per call."""
        with TRACER.entry("step_batch", grays.shape[0] * grays.shape[1],
                          self.mesh.devices[0]):
            parts = _split((grays, depths, stamps, detections), self.mesh, 1)
            telems = _gather(self._run(_Shard.step_batch, parts),
                             self.mesh.devices[0], 1)
            self._ba_tick(stamps, auto_ba)
            return telems

    def run_ba(self, now: float = 0.0) -> torch.Tensor:
        """BA + prune on every stream, one batched program a shard → (B,)
        final costs (on ``devices[0]``)."""
        with TRACER.span("ba"):
            costs = _gather(self._run(_Shard.run_ba,
                                      [(now,)] * len(self.shards)),
                            self.mesh.devices[0])
        self.ba_runs += 1
        return costs

    def stats(self) -> Dict[str, Any]:
        """Per-stream keyframe counts, active landmarks, dropped keyframes,
        BA rounds and the last per-stream final costs, in one host read a
        shard."""
        per = [s.stats() for s in self.shards]
        out = dict(streams=self.batch, ba_runs=self.ba_runs,
                   keyframes=[v for p in per for v in p[0]],
                   landmarks_active=[v for p in per for v in p[1]],
                   keyframes_dropped=[v for p in per for v in p[2]])
        if per[0][3] is not None:
            out["last_ba_costs"] = [v for p in per for v in p[3]]
        return out

    def make_detector(self, params: Dict[str, Any],
                      input_size: Optional[int] = None):
        """Semantic stage for the fleet: → fn mapping (B, H, W) gray frames
        to per-stream Detections (leading dim B, on ``devices[0]``), ready
        for ``step``.  One model a mesh device; each shard's frames run on
        its device, in its thread.  The single-stream detector's letterbox
        (``semantic/detector.letterbox``: [0, 1], fill 0.447) at
        ``input_size`` when the caller gives one, as the reference's; else
        at the size the weights embed (``params["input_size"]``), else
        ``cfg.semantic.input_size``.  (The reference's default is 640
        whatever the weights embed; the port's follows its single-stream
        ``YoloDetector``, 256 with the shipped weights.)  One forward
        for a shard's frames, NMS, the boxes unletterboxed and clipped to
        the frame, class id + 1.  No box margin or tracks (the reference's
        fleet has none).  ``params``: the reference's YOLOv8 tree as numpy
        (``convert.load_params``)."""
        from dynamic_visual_slam_tpu_torch.semantic.detector import (
            build_model, letterbox, letterbox_geometry, resize_tensor)
        cfg, mesh = self.cfg, self.mesh
        if input_size is not None:
            size = int(input_size)
        elif "input_size" in params:
            size = int(np.asarray(params["input_size"], np.float32))
        else:
            size = cfg.semantic.input_size
        sc = cfg.semantic
        h, w = cfg.camera.height, cfg.camera.width
        scale, (nh, nw), (px, py) = letterbox_geometry(h, w, size)
        per_dev = {}
        for dev in dict.fromkeys(mesh.devices):
            resize_tensor(h, nh, dev)  # the letterbox's weights, uploaded once
            resize_tensor(w, nw, dev)
            per_dev[dev] = (
                build_model(params, dev),
                torch.tensor([w - 1, h - 1, w - 1, h - 1],
                             dtype=torch.float32, device=dev),
                torch.tensor([px, py, px, py], dtype=torch.float32,
                             device=dev))

        def one(g: torch.Tensor) -> mapping.Detections:
            dev = g.device
            model, hi, pad = per_dev[dev]
            canvas, _, _ = letterbox(g[..., None].expand(g.shape + (3,)),
                                     size, dev)
            raw = yolov8.detect_batch(model, canvas, sc.max_detections,
                                      sc.score_threshold, sc.iou_threshold)
            boxes = torch.minimum(
                torch.clamp((raw.boxes - pad) / scale, min=0.0), hi)
            return mapping.Detections(boxes=boxes, category=raw.classes + 1,
                                      score=raw.scores, mask=raw.valid)

        def detect(grays) -> mapping.Detections:
            parts = shard_batch(grays, mesh, mesh.axis)
            return _gather(_parallel(mesh.devices,
                                     [lambda g=g: one(g) for g in parts]),
                           mesh.devices[0])
        return detect


# ---------------------------------------------------------------------------
# Sharded detector inference
# ---------------------------------------------------------------------------

def sharded_detector_apply(params: Dict[str, Any],
                           mesh: Optional[Mesh] = None,
                           input_size: int = 640, device="cuda"):
    """→ fn: (B, S, S, 3) float32 images in [0, 1] → batched RawDetections
    (leading dim B, on ``mesh.devices[0]``): B split over ``mesh``
    (``mesh=None``: one device, ``device``), one forward a device, in a
    thread each.  ``params`` as ``make_detector``'s.  ``input_size`` is
    the reference's parameter, kept for its signature: there it reaches
    ``yolov8.detect``, which does not use it past its signature, and here
    too the images' own S is the size the network runs at."""
    from dynamic_visual_slam_tpu_torch.semantic.detector import build_model
    mesh = make_mesh(devices=[device]) if mesh is None else mesh
    models = {dev: build_model(params, dev)
              for dev in dict.fromkeys(mesh.devices)}

    def apply(imgs) -> yolov8.RawDetections:
        parts = shard_batch(imgs, mesh, mesh.axis)
        return _gather(_parallel(
            mesh.devices,
            [lambda im=im: yolov8.detect_batch(models[im.device], im)
             for im in parts]), mesh.devices[0])
    return apply
