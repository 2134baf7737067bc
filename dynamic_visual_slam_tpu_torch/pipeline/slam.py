"""Full SLAM system: tracking frontend + mapping backend + periodic BA.

Port of the main path of the reference package's ``pipeline/slam.py``
``SLAMSystem``: ``process_batch`` runs ORB extraction for a batch of frames
(two CUDA kernels), the batched tracker, the keyframe inserts and, every
``ba.period_s`` seconds of input time, one BA round whose newest-keyframe
correction is fed back into the live tracker.

Host reads: the tracker and BA never read a device value.  Each batch is
drained once — one (B, 13) telemetry transfer — and that read decides which
frames were keyframes, so the map inserts run only for them (the reference
runs them under ``lax.cond`` on device instead).  ``process_batch``
therefore returns the current batch's results (the reference returns the
previous batch's).  BA telemetry is read only at ``finalize()`` when
``ba_async`` is set.

Not ported yet (see ROADMAP.md): the per-frame ``process`` path, place
recognition, relocalization and loop correction, snapshots.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.backend import ba as ba_mod
from dynamic_visual_slam_tpu_torch.backend import mapping
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.core import lie
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.frontend import orb, tracker
from dynamic_visual_slam_tpu_torch.semantic.classes import filtered_mask


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU, and no quiet fallback when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SLAMSystem: device='cuda' but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def _correct_tracker(tstate: tracker.TrackerState, q_c: torch.Tensor,
                     t_c: torch.Tensor) -> tracker.TrackerState:
    """Left-compose a world-frame correction onto the live tracker: pose
    T ← T_c ∘ T, and the stored last-keyframe anchor points x ← R_c x + t_c."""
    return tstate._replace(
        q_wc=lie.quat_normalize(lie.quat_mul(q_c, tstate.q_wc)),
        t_wc=lie.quat_rotate(q_c, tstate.t_wc) + t_c,
        kf_xyz_w=lie.quat_rotate(q_c, tstate.kf_xyz_w) + t_c)


def run_ba_fb(cfg: SLAMConfig, k: Intrinsics, mstate: mapping.MapState,
              tstate: tracker.TrackerState):
    """BA + tracker feedback: left-compose the newest keyframe's BA
    correction onto the live tracker pose, unless it exceeds 0.15 m /
    0.1 rad (a poisoned window)."""
    new_m, res = ba_mod.run_ba(cfg, k, mstate)
    f_cap = cfg.map.max_keyframes
    slot = torch.remainder(mstate.keyframes.next_slot - 1, f_cap).long()
    q_oi, t_oi = lie.se3_inverse(mstate.keyframes.q[slot],
                                 mstate.keyframes.t[slot])
    q_c, t_c = lie.se3_compose(new_m.keyframes.q[slot],
                               new_m.keyframes.t[slot], q_oi, t_oi)
    ok = (torch.linalg.vector_norm(t_c) < 0.15) \
        & (torch.linalg.vector_norm(lie.so3_log(q_c)) < 0.1)
    q_c = torch.where(ok, q_c, lie.quat_identity(device=q_c.device))
    t_c = torch.where(ok, t_c, torch.zeros_like(t_c))
    return new_m, _correct_tracker(tstate, q_c, t_c), res


@dataclass
class FrameResult:
    timestamp: float
    q_wc: np.ndarray
    t_wc: np.ndarray
    tracking_ok: bool
    is_keyframe: bool
    n_features: int
    n_matches: int
    n_inliers: int
    n_payload_valid: int = 0


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@dataclass
class SLAMSystem:
    """Host-side orchestrator over the batched device stages.

    device: "cuda" (default) or "cpu"; "cuda" raises without a card.
    sampler: optional tracker.Sampler replacing the ``torch.Generator``
    (seeded with 0, as the reference's key chain starts at key 0) that the
    RANSAC samples come from; tests use it to feed the reference's own
    draws."""

    config: SLAMConfig
    ba_async: bool = True
    # the port runs the main path only: place recognition is not ported yet
    enable_place_recognition: bool = False
    ba_feedback: bool = True
    device: Any = "cuda"
    sampler: Optional[tracker.Sampler] = None
    stats: Dict[str, int] = field(init=False)

    def __post_init__(self):
        if self.enable_place_recognition:
            raise NotImplementedError(
                "place recognition is not ported yet; construct with "
                "enable_place_recognition=False")
        cfg = self.config
        self._dev = resolve_device(self.device)
        self._k = Intrinsics.from_config(cfg.camera)
        self._filtered = filtered_mask(cfg, self._dev)
        self.generator = torch.Generator(device=self._dev)
        self.generator.manual_seed(0)
        self._sampler = self.sampler or tracker.generator_sampler(
            self.generator)
        self.tracker_state = tracker.init_state(cfg, self._dev)
        self.map_state = mapping.init_map(cfg, self._dev)
        self._empty_det = mapping.Detections.empty(
            cfg.semantic.max_detections, self._dev)
        self._t0: Optional[float] = None
        self._last_ba_t: Optional[float] = None
        self._pending_ba_results: List[Tuple[Any, float]] = []
        self._pending_out: List[Tuple[List[float], Any, Any, Any]] = []
        self._n_kf_host = 0
        self.trajectory: List[FrameResult] = []
        self.ba_log: List[Dict[str, Any]] = []
        self.stats = dict(frames=0, keyframes=0, ba_runs=0, ba_converged=0)

    # ------------------------------------------------------------------
    def process_batch(self, grays, depths, timestamps,
                      detections: Optional[mapping.Detections] = None
                      ) -> List[FrameResult]:
        """B RGB-D frames through the system: grays (B, H, W) uint8 or
        float32, depths (B, H, W) uint16 millimetres or float32 metres
        (numpy arrays or tensors), timestamps (B,) seconds.  Detections,
        if given, are stacked with leading dim B.  Returns this batch's
        FrameResults."""
        timestamps = np.asarray(timestamps, np.float64)
        b = len(timestamps)
        if self._t0 is None:
            self._t0 = float(timestamps[0])
        cfg = self.config
        ts_rel = torch.as_tensor(timestamps - self._t0, dtype=torch.float32,
                                 device=self._dev)
        grays_t = _as_tensor(grays, self._dev)
        depths_t = _as_tensor(depths, self._dev)

        kps_b = orb.extract_batch(grays_t, cfg.orb)
        self.tracker_state, outs = tracker.track_batch(
            cfg, self.tracker_state, kps_b, depths_t, ts_rel, self._sampler,
            dets=detections, filtered=self._filtered)
        telems = torch.cat([
            outs.q_wc, outs.t_wc,
            torch.stack([outs.tracking_ok, outs.is_keyframe, outs.n_features,
                         outs.n_matches, outs.n_inliers,
                         outs.keyframe.mask.sum(-1)], -1).to(torch.float32)],
            -1)
        self._pending_out.append((list(timestamps), outs, telems, detections))
        drained = self._drain_results()

        self._ba_tick(float(timestamps[-1]) - self._t0, float(timestamps[-1]))
        self.stats["frames"] += b
        return drained

    def _ba_tick(self, ts_rel: float, timestamp: float) -> None:
        """Fire a BA round if ba.period_s of input time has elapsed."""
        if self._last_ba_t is None:
            self._last_ba_t = ts_rel
        if (ts_rel - self._last_ba_t >= self.config.ba.period_s
                and (self._n_kf_host >= 2 or self.stats["frames"] >= 2)):
            self._last_ba_t = ts_rel
            if self.ba_feedback:
                self.map_state, self.tracker_state, res = run_ba_fb(
                    self.config, self._k, self.map_state, self.tracker_state)
            else:
                self.map_state, res = ba_mod.run_ba(self.config, self._k,
                                                    self.map_state)
            now = torch.tensor(ts_rel, dtype=torch.float32, device=self._dev)
            self.map_state = self.map_state._replace(
                landmarks=mapping.prune(self.config, self.map_state.landmarks,
                                        now))
            self.stats["ba_runs"] += 1
            if self.ba_async:
                self._pending_ba_results.append((res, timestamp))
            else:
                self._record_ba(res, timestamp)

    def _drain_results(self) -> List[FrameResult]:
        """Read the pending batches' telemetry (one transfer each), emit
        their FrameResults and insert their keyframes into the map."""
        if not self._pending_out:
            return []
        pending, self._pending_out = self._pending_out, []
        drained = []
        for ts_list, outs, telem, dets in pending:
            host = telem.cpu().numpy()
            for j, ts in enumerate(ts_list):
                fr = self._emit_frame(ts, host[j])
                drained.append(fr)
                if fr.is_keyframe:
                    self._insert_keyframe(outs, dets, j)
        return drained

    def _emit_frame(self, timestamp: float, telem: np.ndarray) -> FrameResult:
        fr = FrameResult(
            timestamp=timestamp, q_wc=np.asarray(telem[0:4]),
            t_wc=np.asarray(telem[4:7]), tracking_ok=bool(telem[7] > 0.5),
            is_keyframe=bool(telem[8] > 0.5), n_features=int(telem[9]),
            n_matches=int(telem[10]), n_inliers=int(telem[11]),
            n_payload_valid=int(telem[12]))
        self.trajectory.append(fr)
        if fr.is_keyframe:
            self.stats["keyframes"] += 1
            self._n_kf_host += 1
        return fr

    def _insert_keyframe(self, outs: tracker.TrackOutput, dets, j: int) -> None:
        kf = tracker.KeyframeBlock(*(a[j] for a in outs.keyframe))
        det = self._empty_det if dets is None else \
            mapping.Detections(*(a[j] for a in dets))
        self.map_state, _ = mapping.insert_keyframe(
            self.config, self.map_state, kf, det, self._filtered)

    def finalize(self) -> None:
        """Flush deferred work (pending frame results, BA telemetry) — call
        once after the last frame."""
        self._drain_results()
        for res, ts in self._pending_ba_results:
            self._record_ba(res, ts)
        self._pending_ba_results = []

    def _record_ba(self, res: ba_mod.BAResult, ts: float) -> None:
        host = {k: v.item() for k, v in res._asdict().items()
                if k in ("converged", "initial_cost", "final_cost",
                         "iterations", "n_residuals")}
        conv = bool(host["converged"])
        self.stats["ba_converged"] += int(conv)
        self.ba_log.append(dict(
            timestamp=ts, converged=conv,
            initial_cost=float(host["initial_cost"]),
            final_cost=float(host["final_cost"]),
            iterations=int(host["iterations"]),
            n_residuals=int(host["n_residuals"])))

    # ------------------------------------------------------------------
    def keyframe_trajectory(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """BA-refined keyframe poses (stamps, R_wc (N,3,3), t_wc (N,3)),
        oldest→newest."""
        kdb = self.map_state.keyframes
        f_cap = kdb.q.shape[0]
        n = int(kdb.count)
        k = min(n, f_cap)
        slots = [(int(kdb.next_slot) - k + i) % f_cap for i in range(k)]
        stamps = kdb.stamp.cpu().numpy().astype(np.float64)[slots] \
            + (self._t0 or 0.0)
        rs = lie.quat_to_mat(kdb.q.cpu()[slots]).numpy()
        ts = kdb.t.cpu().numpy()[slots]
        return stamps, rs, ts

    def landmarks_world(self) -> Dict[str, np.ndarray]:
        """Active landmark snapshot (positions, categories, observation
        counts)."""
        lm = self.map_state.landmarks
        act = lm.active.cpu().numpy()
        return dict(xyz=lm.xyz.cpu().numpy()[act],
                    category=lm.category.cpu().numpy()[act],
                    n_obs=lm.n_obs.cpu().numpy()[act])

    def frontend_trajectory(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-frame tracked poses."""
        stamps = np.asarray([f.timestamp for f in self.trajectory])
        if not self.trajectory:
            return stamps, np.zeros((0, 3, 3)), np.zeros((0, 3))
        qs = torch.from_numpy(np.stack([f.q_wc for f in self.trajectory]))
        rs = lie.quat_to_mat(qs).numpy()
        ts = np.stack([f.t_wc for f in self.trajectory])
        return stamps, rs, ts
