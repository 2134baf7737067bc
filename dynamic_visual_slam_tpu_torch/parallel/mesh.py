"""The multi-stream fleet: B independent camera streams in one program on
one device.

Port of the reference package's ``parallel/mesh.py``.  The reference keeps
one ``TrackerState`` and ``MapState`` per stream with a leading stream dim
sharded over a device mesh and vmaps its per-frame programs over it.  Here
the streams are a leading dim on one card, and every device stage runs
once for all of them: extraction is one ``orb.extract_batch`` call (one
launch each of kernels B1 and B2 for the B frames), tracking is
``tracker.track_streams`` (B independent frame pairs through the batched
pair stages), the keyframe insert and BA are vmapped programs selected per
stream on the device.  No stage loops over the streams on the host, and
none reads a device value.  The reference's ``make_mesh``, ``shard_batch``
and ``replicate`` place leaves on a mesh of devices; one card has no such
placement, and splitting the streams over several cards is still to do.

Randomness.  By default each tracker stage draws every stream's minimal
sets in one call from the fleet's ``generator`` (seeded with 0), so streams
draw different samples, as the reference's per-stream keys
``fold_in(key(0), s)`` keep them apart.  ``sampler`` replaces it with a
callable ``sampler(stage, streams, frame_ids, n_hyp, size, count)`` keyed
by (stream, frame), all (B,) int64, returning (B, n_hyp, size) indices;
tests feed the reference's own draws through it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.backend import ba as ba_mod
from dynamic_visual_slam_tpu_torch.backend import mapping
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.core import containers
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.frontend import orb, tracker
from dynamic_visual_slam_tpu_torch.models import yolov8
from dynamic_visual_slam_tpu_torch.pipeline.slam import (_as_tensor, _to_host,
                                                         resolve_device)
from dynamic_visual_slam_tpu_torch.semantic.classes import filtered_mask

FleetSampler = Callable[[str, torch.Tensor, torch.Tensor, int, int,
                         torch.Tensor], torch.Tensor]


def _stack(tree, b: int):
    return containers.tree_map(lambda x: x.expand((b,) + x.shape).clone(),
                               tree)


class SLAMFleet:
    """B independent SLAM streams batched on one device (module docstring).

    kf_slots: keyframe-insert slots per ``step_batch`` call (None → the
    reference's ``T // 4 + 2``, at most T); flagged frames beyond them are
    dropped, newest first, and counted in ``stats()["keyframes_dropped"]``.
    """

    def __init__(self, cfg: SLAMConfig, batch: int,
                 kf_slots: Optional[int] = None, device="cuda",
                 sampler: Optional[FleetSampler] = None):
        self.cfg = cfg
        self.batch = batch
        self.kf_slots = kf_slots
        self._dev = resolve_device(device)
        self._k = Intrinsics.from_config(cfg.camera)
        self._filtered = filtered_mask(cfg, self._dev)
        self.generator = torch.Generator(device=self._dev)
        self.generator.manual_seed(0)
        if sampler is None:
            self._sampler = tracker.generator_sampler(self.generator)
        else:
            streams = torch.arange(batch)

            def bound(stage, frame_ids, n_hyp, size, count):
                return sampler(stage, streams, frame_ids, n_hyp, size, count)
            self._sampler = bound
        self.tracker_states = _stack(tracker.init_state(cfg, self._dev),
                                     batch)
        self.map_states = _stack(mapping.init_map(cfg, self._dev), batch)
        self._empty_det = mapping.Detections.empty(
            cfg.semantic.max_detections, self._dev)
        # BA cadence (the reference's 2 s wall timer): one fleet-wide
        # decision per call from the input stamps
        self._last_ba_t: Optional[float] = None
        self.ba_runs = 0
        self._ba_costs: Optional[torch.Tensor] = None
        # keyframes dropped by step_batch's K-slot insert cap, per stream
        self._dropped_kf = torch.zeros(batch, dtype=torch.int32,
                                       device=self._dev)

    # ------------------------------------------------------------------
    def _dets(self, detections, lead) -> mapping.Detections:
        if detections is None:
            return containers.tree_map(
                lambda x: x.expand(lead + x.shape), self._empty_det)
        return containers.tree_map(lambda x: x.to(self._dev), detections)

    def _track(self, grays, depths, stamps, dets):
        kps = orb.extract_batch(grays, self.cfg.orb)
        self.tracker_states, out = tracker.track_streams(
            self.cfg, self.tracker_states, kps, depths, stamps,
            self._sampler, det=dets, filtered=self._filtered)
        return out

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
        dev = self._dev
        dets = self._dets(detections, (self.batch,))
        out = self._track(_as_tensor(grays, dev), _as_tensor(depths, dev),
                          _as_tensor(stamps, dev).to(torch.float32), dets)
        self.map_states = mapping.insert_keyframe_streams(
            self.cfg, self.map_states, out.keyframe, dets, self._filtered,
            out.is_keyframe)
        self._ba_tick(stamps, auto_ba)
        return out

    def step_batch(self, grays, depths, stamps,
                   detections: Optional[mapping.Detections] = None,
                   auto_ba: bool = True) -> torch.Tensor:
        """(T, B, H, W) grays / depths + (T, B) stamps (+ optional
        Detections with leading dims (T, B)) → (T, B, 10) telemetry: q_wc,
        t_wc, tracking_ok, is_keyframe, n_inliers.  One extraction for the
        B streams per step of T, then the tracker; the keyframe inserts are
        deferred into K = min(T, kf_slots or T // 4 + 2) slots filled with
        each stream's FIRST K flagged frames (a stable sort: flags past K
        are dropped, newest first, and counted), K masked inserts in all.
        A dropped frame keeps is_keyframe in the telemetry (the tracker
        flagged and anchored it) though the map never stored it.  BA
        cadence is evaluated once per call."""
        dev = self._dev
        grays, depths = _as_tensor(grays, dev), _as_tensor(depths, dev)
        ts = _as_tensor(stamps, dev).to(torch.float32)
        t_dim = ts.shape[0]
        dets = self._dets(detections, (t_dim, self.batch))
        outs = [self._track(grays[t], depths[t], ts[t],
                            containers.tree_map(lambda x: x[t], dets))
                for t in range(t_dim)]
        outs = containers.tree_stack(outs)                # leaves (T, B, ...)

        k_slots = min(t_dim, self.kf_slots or (t_dim // 4 + 2))
        flags = outs.is_keyframe.T                        # (B, T)
        order = containers.stable_partition(flags)[:, :k_slots]   # (B, K)
        valid = torch.gather(flags, 1, order)             # (B, K)
        dropped = torch.clamp(flags.sum(1) - k_slots, min=0).to(torch.int32)

        def gather_kb(a):
            # (T, B, ...) → (K, B, ...): stream b's slot k is frame order[b, k]
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
        self._dropped_kf = self._dropped_kf + dropped
        telems = torch.cat([
            outs.q_wc, outs.t_wc,
            torch.stack([outs.tracking_ok, outs.is_keyframe, outs.n_inliers],
                        -1).to(torch.float32)], -1)       # (T, B, 10)
        self._ba_tick(stamps, auto_ba)
        return telems

    def run_ba(self, now: float = 0.0) -> torch.Tensor:
        """BA + prune on every stream in one batched program → (B,) final
        costs (on the device)."""
        new, res = ba_mod.run_ba_streams(self.cfg, self._k, self.map_states)
        t_now = torch.full((), now, dtype=torch.float32, device=self._dev)
        self.map_states = new._replace(landmarks=mapping.prune_streams(
            self.cfg, new.landmarks, t_now))
        self.ba_runs += 1
        self._ba_costs = res.final_cost
        return res.final_cost

    def stats(self) -> Dict[str, Any]:
        """Per-stream keyframe counts, active landmarks, dropped keyframes,
        BA rounds and the last per-stream final costs, in one host read."""
        groups = [(self.map_states.keyframes.count,
                   self.map_states.landmarks.active.sum(-1),
                   self._dropped_kf)]
        if self._ba_costs is not None:
            groups.append((self._ba_costs,))
        host = _to_host(groups)
        kf, lm, dropped = (a.astype(np.int64).tolist() for a in host[0])
        out = dict(streams=self.batch, ba_runs=self.ba_runs, keyframes=kf,
                   landmarks_active=lm, keyframes_dropped=dropped)
        if self._ba_costs is not None:
            out["last_ba_costs"] = host[1][0].tolist()
        return out

    def make_detector(self, params: Dict[str, Any],
                      input_size: Optional[int] = None):
        """Semantic stage for the fleet: → fn mapping (B, H, W) gray frames
        to per-stream Detections (leading dim B) on the fleet's device,
        ready for ``step``.  The single-stream detector's letterbox
        (``semantic/detector.letterbox``: [0, 1], fill 0.447) at
        ``input_size`` when the caller gives one, as the reference's; else
        at the size the weights embed (``params["input_size"]``), else
        ``cfg.semantic.input_size``.  (The reference's default is 640
        whatever the weights embed; the port's follows its single-stream
        ``YoloDetector``, 256 with the shipped weights.)  One forward
        for the B frames, NMS, the boxes unletterboxed and clipped to the
        frame, class id + 1.  No box margin or tracks (the reference's
        fleet has none).  ``params``: the reference's YOLOv8 tree as numpy
        (``convert.load_params``)."""
        from dynamic_visual_slam_tpu_torch.semantic.detector import (
            build_model, letterbox, letterbox_geometry, resize_tensor)
        cfg, dev = self.cfg, self._dev
        if input_size is not None:
            size = int(input_size)
        elif "input_size" in params:
            size = int(np.asarray(params["input_size"], np.float32))
        else:
            size = cfg.semantic.input_size
        model = build_model(params, dev)
        sc = cfg.semantic
        h, w = cfg.camera.height, cfg.camera.width
        scale, (nh, nw), (px, py) = letterbox_geometry(h, w, size)
        resize_tensor(h, nh, dev)      # the letterbox's weights, uploaded once
        resize_tensor(w, nw, dev)
        hi = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=torch.float32,
                          device=dev)
        pad = torch.tensor([px, py, px, py], dtype=torch.float32, device=dev)

        def detect(grays) -> mapping.Detections:
            g = _as_tensor(grays, dev)
            canvas, _, _ = letterbox(g[..., None].expand(g.shape + (3,)),
                                     size, dev)
            raw = yolov8.detect_batch(model, canvas, sc.max_detections,
                                      sc.score_threshold, sc.iou_threshold)
            boxes = torch.minimum(
                torch.clamp((raw.boxes - pad) / scale, min=0.0), hi)
            return mapping.Detections(boxes=boxes, category=raw.classes + 1,
                                      score=raw.scores, mask=raw.valid)
        return detect


def sharded_detector_apply(params: Dict[str, Any], input_size: int = 640,
                           device="cuda"):
    """→ fn: (B, S, S, 3) float32 images in [0, 1] → batched RawDetections
    (leading dim B), one forward for the B images on ``device`` (the
    reference splits B over its mesh).  ``params`` as ``make_detector``'s.
    ``input_size`` is the reference's parameter, kept for its signature:
    there it reaches ``yolov8.detect``, which does not use it past its
    signature, and here too the images' own S is the size the network
    runs at."""
    from dynamic_visual_slam_tpu_torch.semantic.detector import build_model
    model = build_model(params, resolve_device(device))

    def apply(imgs: torch.Tensor) -> yolov8.RawDetections:
        return yolov8.detect_batch(model, imgs)
    return apply
