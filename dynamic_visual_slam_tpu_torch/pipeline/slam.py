"""Full SLAM system: tracking frontend + mapping backend + periodic BA +
place recognition, loop closure and relocalization.

Port of the reference package's ``pipeline/slam.py`` ``SLAMSystem``.
``process`` tracks one frame (``tracker.track_step``), ``process_batch`` a
batch (``orb.extract_batch`` + ``tracker.track_batch``); both insert the
keyframes into the map, emit FrameResults on the ``sync_every`` cadence and,
every ``ba.period_s`` seconds of input time, run one BA round whose
newest-keyframe correction is fed back into the live tracker.  At emission
each keyframe goes through the place chain: BoW add + query, geometric
verification of a candidate (Hamming cross-check match, F-RANSAC, PnP
against the candidate's stored world points), and the loop correction
(pose graph, or the age-interpolated one); a run of lost frames queries the
database for a relocalization.

Host reads.  The device stages never read a device value.  Each call makes
one host transfer: the new frames' (…, 13) telemetry, which decides the map
inserts right away (the reference runs them under ``lax.cond`` on device),
together with — when the cadence emits — every pending place result (loop
verdicts, BoW queries, the relocalization verdict), which the emission
harvests in the reference's order: loops dispatched at the last emission,
then queries, then the new keyframes' queries.  BA telemetry is read only
at ``finalize()`` when ``ba_async`` is set.

Randomness.  Tracker draws come from ``sampler`` or a ``torch.Generator``
seeded with 0.  A verification draws its F-RANSAC and PnP minimal sets
(stages "loop_fm", "loop_pnp") keyed by the reference's integers —
entry·9973 + candidate for a loop, frames·7919 + candidate for a
relocalization — from a generator seeded with that integer, or from
``sampler``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.backend import ba as ba_mod
from dynamic_visual_slam_tpu_torch.backend import mapping, pose_graph
from dynamic_visual_slam_tpu_torch.config import SLAMConfig
from dynamic_visual_slam_tpu_torch.core import lie
from dynamic_visual_slam_tpu_torch.core.camera import Intrinsics
from dynamic_visual_slam_tpu_torch.core.containers import row
from dynamic_visual_slam_tpu_torch.frontend import orb, ransac, tracker
from dynamic_visual_slam_tpu_torch.ops import hamming
from dynamic_visual_slam_tpu_torch.place import bow
from dynamic_visual_slam_tpu_torch.semantic.classes import filtered_mask
from dynamic_visual_slam_tpu_torch.utils.profiling import TRACER, traced


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
    q_oi, t_oi = lie.se3_inverse(row(mstate.keyframes.q, slot),
                                 row(mstate.keyframes.t, slot))
    q_c, t_c = lie.se3_compose(row(new_m.keyframes.q, slot),
                               row(new_m.keyframes.t, slot), q_oi, t_oi)
    ok = (torch.linalg.vector_norm(t_c) < 0.15) \
        & (torch.linalg.vector_norm(lie.so3_log(q_c)) < 0.1)
    q_c = torch.where(ok, q_c, lie.quat_identity(device=q_c.device))
    t_c = torch.where(ok, t_c, torch.zeros_like(t_c))
    return new_m, _correct_tracker(tstate, q_c, t_c), res


def _ring_seq(kdb: mapping.KeyframeDB, f_cap: int) -> torch.Tensor:
    """(F,) monotone keyframe sequence number of each ring slot."""
    s = torch.arange(f_cap, device=kdb.q.device)
    newest = kdb.next_slot.long() - 1
    return newest - torch.remainder(newest - s, f_cap)


def _seq(x, device) -> torch.Tensor:
    """A keyframe sequence id (int or tensor) as an int64 device scalar; an
    int is filled on the device, not copied from the host."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64)
    return torch.full((), x, dtype=torch.int64, device=device)


@traced("place.apply")
def apply_loop(cfg: SLAMConfig, tstate: tracker.TrackerState,
               mstate: mapping.MapState, q_pnp: torch.Tensor,
               t_pnp: torch.Tensor, cand_seq, entry_seq):
    """Distribute a verified loop's drift correction over the keyframe ring
    (se3 tangent scaled by keyframe age between the loop endpoints), the
    landmarks (by newest observation) and the live tracker (in full).
    T_corr = T_pnp ∘ T_entry⁻¹ against the entry keyframe's CURRENT ring
    pose; corrections over 1 m or 0.5 rad are no-ops."""
    kdb = mstate.keyframes
    dev = kdb.q.device
    cand_seq, entry_seq = _seq(cand_seq, dev), _seq(entry_seq, dev)
    seq = _ring_seq(kdb, cfg.map.max_keyframes)
    entry_hit = (seq == entry_seq) & kdb.active
    slot = torch.argmax(entry_hit.to(torch.int32))
    q_ei, t_ei = lie.se3_inverse(row(kdb.q, slot), row(kdb.t, slot))
    q_corr, t_corr = lie.se3_compose(q_pnp, t_pnp, q_ei, t_ei)
    ok = entry_hit.any() & (torch.linalg.vector_norm(t_corr) < 1.0) \
        & (torch.linalg.vector_norm(lie.so3_log(q_corr)) < 0.5)
    q_corr = torch.where(ok, q_corr, lie.quat_identity(device=dev))
    t_corr = torch.where(ok, t_corr, torch.zeros_like(t_corr))
    span = torch.clamp(entry_seq - cand_seq, min=1).to(torch.float32)
    alpha = torch.clamp((seq - cand_seq).to(torch.float32) / span, 0.0, 1.0) \
        * kdb.active
    phi = lie.so3_log(q_corr)
    q_a = lie.so3_exp(alpha[:, None] * phi[None])
    q_new = lie.quat_normalize(lie.quat_mul(q_a, kdb.q))
    t_new = lie.quat_rotate(q_a, kdb.t) + alpha[:, None] * t_corr[None]
    act = kdb.active[:, None]
    kdb = kdb._replace(q=torch.where(act, q_new, kdb.q),
                       t=torch.where(act, t_new, kdb.t))
    lm = mstate.landmarks
    lm_seq = torch.where(lm.obs_valid, lm.obs_kf, -1).amax(1)
    al = torch.clamp((lm_seq - cand_seq).to(torch.float32) / span, 0.0, 1.0) \
        * lm.active
    q_l = lie.so3_exp(al[:, None] * phi[None])
    xyz = lie.quat_rotate(q_l, lm.xyz) + al[:, None] * t_corr[None]
    lm = lm._replace(xyz=torch.where(lm.active[:, None], xyz, lm.xyz))
    return (_correct_tracker(tstate, q_corr, t_corr),
            mstate._replace(keyframes=kdb, landmarks=lm))


@traced("place.apply")
def apply_loop_pgo(cfg: SLAMConfig, tstate: tracker.TrackerState,
                   mstate: mapping.MapState, q_pnp: torch.Tensor,
                   t_pnp: torch.Tensor, cand_seq, entry_seq):
    """Pose-graph variant of apply_loop: the ring poses come from
    ``pose_graph.optimize_ring``; landmarks follow their newest observing
    keyframe's correction; the live tracker follows the newest keyframe.
    Same entry-correction magnitude gate as apply_loop."""
    f_cap = cfg.map.max_keyframes
    kdb = mstate.keyframes
    dev = kdb.q.device
    cand_seq, entry_seq = _seq(cand_seq, dev), _seq(entry_seq, dev)
    seq = _ring_seq(kdb, f_cap)
    entry_hit = (seq == entry_seq) & kdb.active
    slot = torch.argmax(entry_hit.to(torch.int32))
    q_ei, t_ei = lie.se3_inverse(row(kdb.q, slot), row(kdb.t, slot))
    q_raw, t_raw = lie.se3_compose(q_pnp, t_pnp, q_ei, t_ei)
    res = pose_graph.optimize_ring(kdb.q, kdb.t, kdb.active, seq, q_pnp,
                                   t_pnp, entry_seq, cand_seq)
    ok = entry_hit.any() & res.ok \
        & (torch.linalg.vector_norm(t_raw) < 1.0) \
        & (torch.linalg.vector_norm(lie.so3_log(q_raw)) < 0.5)
    kdb = kdb._replace(q=torch.where(ok, res.q, kdb.q),
                       t=torch.where(ok, res.t, kdb.t))
    lm = mstate.landmarks
    lm_seq = torch.where(lm.obs_valid, lm.obs_kf, -1).amax(1)
    live = lm_seq >= (mstate.keyframes.next_slot - f_cap)
    lslot = torch.remainder(torch.clamp(lm_seq, min=0), f_cap).long()
    xyz = lie.quat_rotate(res.q_corr[lslot], lm.xyz) + res.t_corr[lslot]
    move = ok & lm.active & live & (lm_seq >= 0)
    lm = lm._replace(xyz=torch.where(move[:, None], xyz, lm.xyz))
    ns = torch.remainder(mstate.keyframes.next_slot - 1, f_cap).long()
    q_tc = torch.where(ok, row(res.q_corr, ns), lie.quat_identity(device=dev))
    t_tc = torch.where(ok, row(res.t_corr, ns), torch.zeros_like(t_raw))
    return (_correct_tracker(tstate, q_tc, t_tc),
            mstate._replace(keyframes=kdb, landmarks=lm))


@traced("place.apply")
def apply_reloc(tstate: tracker.TrackerState, q_pnp: torch.Tensor,
                t_pnp: torch.Tensor, q_froz: torch.Tensor,
                t_froz: torch.Tensor) -> tracker.TrackerState:
    """Re-anchor the live tracker after a verified relocalization:
    T_corr = T_pnp ∘ T_frozen⁻¹ left-composes onto the CURRENT pose, so the
    tracking resumed since the queried frame is kept.  No magnitude gate."""
    q_c, t_c = lie.se3_compose(q_pnp, t_pnp, *lie.se3_inverse(q_froz, t_froz))
    return _correct_tracker(tstate, q_c, t_c)


def seeded_sampler(seed: int, device) -> tracker.Sampler:
    """A sampler drawing from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def sampler(stage, frame_ids, n_hyp, size, count):
        return ransac.sample_indices(gen, n_hyp, size, count)
    return sampler


@traced("place.verify")
def verify_loop(cfg: SLAMConfig, k: Intrinsics, d1, uv1, m1, d2, uv2, m2,
                xyz2, seed: int, sampler: Optional[tracker.Sampler] = None):
    """Geometric loop / relocalization verification of keyframe 1 against
    candidate 2: Hamming cross-check match, F-RANSAC, then PnP of the
    candidate's stored world points against keyframe 1's pixels.
    → (F-RANSAC inliers, q_wc, t_wc of keyframe 1 from PnP, PnP inliers or
    0), all device tensors.  Draws: stages "loop_fm" and "loop_pnp" of
    ``sampler`` with frame id ``seed``, or a generator seeded with it."""
    TRACER.count("place.verify.dispatched")
    if sampler is None:
        sampler = seeded_sampler(seed, d1.device)
    ids = torch.full((1,), seed, dtype=torch.int64)

    def draws(stage, n_hyp, size, valid):
        return sampler(stage, ids, n_hyp, size, valid.sum()[None])[0]

    res = hamming.match(d1, d2, m1, m2,
                        max_distance=float(cfg.match.max_hamming),
                        cross_check=True)
    fm = ransac.fundamental_ransac(
        uv2[res.train_idx], uv1, res.valid,
        threshold=cfg.ransac.fm_threshold_px,
        samples=draws("loop_fm", cfg.ransac.fm_iterations, 8, res.valid))
    fm_ok = fm.inliers & fm.valid
    pnp = ransac.pnp_ransac(
        k, xyz2[res.train_idx], uv1, fm_ok,
        n_hyp=cfg.ransac.pnp_iterations,
        threshold=cfg.ransac.loop_pnp_threshold_px,
        min_inliers=cfg.ransac.min_pnp_matches,
        refine_iters=cfg.ransac.refine_iterations,
        samples=draws("loop_pnp", cfg.ransac.pnp_iterations, 6, fm_ok))
    q_wc, t_wc = lie.se3_inverse(pnp.q, pnp.t)
    return (fm_ok.sum(), q_wc, t_wc,
            torch.where(pnp.valid, pnp.n_inliers, 0))


@traced("pipeline.read")
def _to_host(groups: Sequence[Sequence[torch.Tensor]]) -> List[tuple]:
    """Groups of device tensors → the same groups of float32 numpy arrays,
    in ONE device-to-host transfer (the integers and flags read here are
    small enough to be exact in float32)."""
    flat = [t for g in groups for t in g]
    if not flat:
        return [() for _ in groups]
    host = torch.cat([t.reshape(-1).to(torch.float32) for t in flat]
                     ).cpu().numpy()
    out, i = [], 0
    for g in groups:
        arrs = []
        for t in g:
            arrs.append(host[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        out.append(tuple(arrs))
    return out


def _telemetry(out: tracker.TrackOutput) -> torch.Tensor:
    """(…, 13) float32: q_wc, t_wc, tracking_ok, is_keyframe, n_features,
    n_matches, n_inliers, mask-valid payload observations."""
    return torch.cat([
        out.q_wc, out.t_wc,
        torch.stack([out.tracking_ok, out.is_keyframe, out.n_features,
                     out.n_matches, out.n_inliers,
                     out.keyframe.mask.sum(-1)], -1).to(torch.float32)], -1)


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
    """Host-side orchestrator over the device stages.  Fields and defaults
    are the reference's (place recognition, loop correction through the
    pose graph and relocalization all on), plus:

    device: "cuda" (default) or "cpu"; "cuda" raises without a card.
    sampler: optional tracker.Sampler replacing the generators the RANSAC
    minimal sets come from (tracker stages "fm", "pnp", "anchor" by frame
    index; verification stages "loop_fm", "loop_pnp" by seed); tests use it
    to feed the reference's own draws."""

    config: SLAMConfig
    ba_async: bool = True
    sync_every: int = 1                # emission cadence (frames or batches)
    enable_place_recognition: bool = True
    vocab_train_keyframes: int = 4     # online vocabulary after N keyframes
    vocab_path: Optional[str] = None   # pretrained vocabulary npz
    loop_min_gap: int = 10             # ignore the most recent N keyframes
    loop_min_score: float = 0.12
    loop_geometric_check: bool = True
    loop_min_inliers: int = 30
    loop_top_k: int = 8
    ba_feedback: bool = True
    loop_correction: bool = True
    loop_pgo: bool = True
    enable_relocalization: bool = True
    reloc_after: int = 3               # consecutive failed frames to trigger
    reloc_min_features: int = 50
    device: Any = "cuda"
    sampler: Optional[tracker.Sampler] = None
    stats: Dict[str, int] = field(init=False)

    def __post_init__(self):
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
        # (timestamp or list of them, TrackOutput, host telemetry, dets)
        self._pending_out: List[Tuple[Any, Any, np.ndarray, Any]] = []
        self._n_kf_host = 0
        self.trajectory: List[FrameResult] = []
        self.ba_log: List[Dict[str, Any]] = []
        self.loop_candidates: List[Dict[str, Any]] = []
        self._bow_db: Optional[bow.Database] = None
        if self.vocab_path is not None:
            self._bow_db = bow.Database(
                bow.load_vocabulary(self.vocab_path, self._dev),
                capacity=cfg.place.max_db_entries)
        self._kf_descs: List[Any] = []   # pre-vocabulary host buffer
        # DB slot → (seq, desc, uv, mask, xyz_w, q_wc, t_wc) device arrays
        self._kf_store: Dict[int, Any] = {}
        self._kf_seq = 0
        # (entry_seq, db slot, QueryResult, timestamp)
        self._pending_queries: List[Tuple[int, int, Any, float]] = []
        # (record, verdict, cand_seq, entry_seq)
        self._pending_loops: List[Any] = []
        self._lost_streak = 0
        # (verdict, q_frozen, t_frozen, record)
        self._pending_reloc: Optional[Tuple[Any, Any, Any, Dict]] = None
        self.reloc_log: List[Dict[str, Any]] = []
        self.stats = dict(frames=0, keyframes=0, ba_runs=0, ba_converged=0,
                          loop_candidates=0, relocalizations=0)

    # ------------------------------------------------------------------
    def process(self, gray, depth_m, timestamp: float,
                detections: Optional[mapping.Detections] = None
                ) -> Optional[FrameResult]:
        """One RGB-D frame: gray (H, W) uint8 or float32, depth (H, W)
        uint16 millimetres or float32 metres (numpy arrays or tensors).
        Returns this frame's FrameResult when sync_every == 1; otherwise the
        newest FrameResult emitted by this call (None if none).  Call
        finalize() after the last frame."""
        with TRACER.entry("process", 1, self._dev):
            if self._t0 is None:
                self._t0 = timestamp
            ts_rel = torch.tensor(timestamp - self._t0, dtype=torch.float32,
                                  device=self._dev)
            self.tracker_state, out = tracker.track_step(
                self.config, self.tracker_state, _as_tensor(gray, self._dev),
                _as_tensor(depth_m, self._dev), ts_rel, self._sampler,
                det=detections, filtered=self._filtered)
            hold = self.sync_every > 1
            emit = not hold or len(self._pending_out) + 1 > self.sync_every
            telem, bundle = self._read(_telemetry(out), emit)
            if telem[8] > 0.5:
                self._insert_keyframe(out, detections, None)
            self._pending_out.append((timestamp, out, telem, detections))
            drained = self._emit(bundle, hold) if emit else []
            self._ba_tick(timestamp - self._t0, timestamp)
            self.stats["frames"] += 1
            return drained[-1] if drained else None

    def process_batch(self, grays, depths, timestamps,
                      detections: Optional[mapping.Detections] = None
                      ) -> List[FrameResult]:
        """B RGB-D frames: grays (B, H, W), depths (B, H, W), timestamps
        (B,) seconds.  Detections, if given, are stacked with leading dim
        B.  Results lag one batch, as the reference's: the batches pending
        before this one are emitted once more than max(1, sync_every) are
        pending; finalize() flushes the tail."""
        timestamps = np.asarray(timestamps, np.float64)
        b = len(timestamps)
        with TRACER.entry("process_batch", b, self._dev):
            if self._t0 is None:
                self._t0 = float(timestamps[0])
            cfg = self.config
            ts_rel = torch.as_tensor(timestamps - self._t0,
                                     dtype=torch.float32, device=self._dev)
            kps_b = orb.extract_batch(_as_tensor(grays, self._dev), cfg.orb)
            self.tracker_state, outs = tracker.track_batch(
                cfg, self.tracker_state, kps_b, _as_tensor(depths, self._dev),
                ts_rel, self._sampler, dets=detections,
                filtered=self._filtered)
            emit = len(self._pending_out) + 1 > max(1, self.sync_every)
            telem, bundle = self._read(_telemetry(outs), emit)
            for j in range(b):
                if telem[j, 8] > 0.5:
                    self._insert_keyframe(outs, detections, j)
            self._pending_out.append((list(timestamps), outs, telem,
                                      detections))
            drained = self._emit(bundle, True) if emit else []
            self._ba_tick(float(timestamps[-1]) - self._t0,
                          float(timestamps[-1]))
            self.stats["frames"] += b
            return drained

    def _read(self, telem: torch.Tensor, emit: bool):
        """The call's one host transfer: the new telemetry, plus the pending
        place results when this call emits."""
        groups = [(telem,)] + (self._place_bundle() if emit else [])
        host = _to_host(groups)
        return host[0][0], host[1:]

    def _emit(self, bundle, hold_newest: bool) -> List[FrameResult]:
        """Emit every pending frame, or all but the newest entry."""
        newest = self._pending_out.pop() if hold_newest else None
        drained = self._drain_results(bundle)
        if newest is not None:
            self._pending_out.append(newest)
        return drained

    def _ba_tick(self, ts_rel: float, timestamp: float) -> None:
        """Fire a BA round if ba.period_s of input time has elapsed."""
        if self._last_ba_t is None:
            self._last_ba_t = ts_rel
        if not (ts_rel - self._last_ba_t >= self.config.ba.period_s
                and (self._n_kf_host >= 2 or self.stats["frames"] >= 2)):
            return
        self._last_ba_t = ts_rel
        with TRACER.span("ba"):
            # a relocalization in flight froze the tracker pose at dispatch:
            # feedback now would be baked into the re-anchored pose as error
            if self.ba_feedback and self._pending_reloc is None:
                self.map_state, self.tracker_state, res = run_ba_fb(
                    self.config, self._k, self.map_state, self.tracker_state)
            else:
                self.map_state, res = ba_mod.run_ba(self.config, self._k,
                                                    self.map_state)
            with TRACER.span("ba.prune"):
                now = torch.tensor(ts_rel, dtype=torch.float32,
                                   device=self._dev)
                self.map_state = self.map_state._replace(
                    landmarks=mapping.prune(self.config,
                                            self.map_state.landmarks, now))
            self.stats["ba_runs"] += 1
            if self.ba_async:
                self._pending_ba_results.append((res, timestamp))
            else:
                self._record_ba(res, timestamp)

    def _place_bundle(self) -> List[tuple]:
        """Every pending place result, in harvest order: the relocalization
        verdict, the loop verdicts, the BoW query results."""
        groups = []
        if self._pending_reloc is not None:
            groups.append(self._pending_reloc[0])
        groups += [v for _, v, _, _ in self._pending_loops]
        groups += [tuple(r) for _, _, r, _ in self._pending_queries]
        return groups

    @traced("pipeline.emit")
    def _drain_results(self, bundle=None) -> List[FrameResult]:
        """Harvest the pending place results (read in ``bundle``, or here in
        one transfer), then emit every pending frame."""
        if bundle is None:
            bundle = _to_host(self._place_bundle())
        n_r = int(self._pending_reloc is not None)
        n_l = len(self._pending_loops)
        self._harvest_reloc(bundle[0] if n_r else None)
        self._harvest_loops(bundle[n_r:n_r + n_l])
        self._harvest_queries(bundle[n_r + n_l:])
        if not self._pending_out:
            return []
        pending, self._pending_out = self._pending_out, []
        drained = []
        for ts_entry, out, telem, _ in pending:
            if isinstance(ts_entry, list):
                for j, ts in enumerate(ts_entry):
                    drained.append(self._emit_frame(ts, telem[j], out, j))
            else:
                drained.append(self._emit_frame(ts_entry, telem, out, None))
        return drained

    @staticmethod
    def _block(out: tracker.TrackOutput, j: Optional[int]
               ) -> tracker.KeyframeBlock:
        if j is None:
            return out.keyframe
        return tracker.KeyframeBlock(*(a[j] for a in out.keyframe))

    def _emit_frame(self, timestamp: float, telem: np.ndarray, out,
                    batch_idx: Optional[int]) -> FrameResult:
        fr = FrameResult(
            timestamp=timestamp, q_wc=np.asarray(telem[0:4]),
            t_wc=np.asarray(telem[4:7]), tracking_ok=bool(telem[7] > 0.5),
            is_keyframe=bool(telem[8] > 0.5), n_features=int(telem[9]),
            n_matches=int(telem[10]), n_inliers=int(telem[11]),
            n_payload_valid=int(telem[12]))
        self.trajectory.append(fr)
        if fr.tracking_ok:
            self._lost_streak = 0
        else:
            self._lost_streak += 1
            if (self.enable_relocalization and self._bow_db is not None
                    and self._pending_reloc is None
                    and self._lost_streak >= self.reloc_after
                    and fr.n_payload_valid >= self.reloc_min_features):
                self._dispatch_reloc(fr, out, batch_idx)
        if fr.is_keyframe:
            self.stats["keyframes"] += 1
            self._n_kf_host += 1
            if self.enable_place_recognition:
                self._place_recognition(self._block(out, batch_idx),
                                        timestamp)
        return fr

    def _insert_keyframe(self, outs: tracker.TrackOutput, dets,
                         j: Optional[int]) -> None:
        if dets is None:
            det = self._empty_det
        else:
            det = dets if j is None else mapping.Detections(
                *(a[j] for a in dets))
        self.map_state, _ = mapping.insert_keyframe(
            self.config, self.map_state, self._block(outs, j), det,
            self._filtered)

    # ------------------------------------------------------------------
    # place chain
    def _place_recognition(self, kf: tracker.KeyframeBlock,
                           timestamp: float) -> None:
        """Add the keyframe to the BoW database and dispatch its query (read
        at the next emission).  Candidate ids are monotone keyframe sequence
        numbers.  Until an online vocabulary exists, the keyframe's valid
        descriptors are buffered on the host; after vocab_train_keyframes
        of them the vocabulary is trained (host k-medians) and they are
        added."""
        if self._bow_db is None:
            with TRACER.span("place.vocab"):
                self._train_vocabulary(kf)
            return
        res = self._bow_db.query(kf.desc_bits, kf.mask, top_k=self.loop_top_k)
        entry = self._bow_db.add(kf.desc_bits, kf.mask)
        entry_seq = self._store_kf_block(entry, kf)
        self._pending_queries.append((entry_seq, entry, res, timestamp))

    def _train_vocabulary(self, kf: tracker.KeyframeBlock) -> None:
        """Buffer the keyframe's valid descriptors on the host; at the
        ``vocab_train_keyframes``-th, train the vocabulary and add them."""
        cfg = self.config
        m, desc, uv, xyz, q, t = _to_host([(
            kf.mask, kf.desc_bits, kf.uv, kf.xyz_w, kf.q_wc, kf.t_wc)])[0]
        m = m > 0.5
        self._kf_descs.append((desc[m].astype(np.uint8), uv[m], xyz[m],
                               (q, t)))
        if len(self._kf_descs) < self.vocab_train_keyframes:
            return
        voc = bow.train_vocabulary(
            np.concatenate([d for d, _, _, _ in self._kf_descs]),
            k=cfg.place.branching, depth=cfg.place.depth, seed=0,
            doc_ids=np.concatenate(
                [np.full(len(d), i)
                 for i, (d, _, _, _) in enumerate(self._kf_descs)]),
            device=self._dev)
        self._bow_db = bow.Database(voc, capacity=cfg.place.max_db_entries)
        for d, u, x, po in self._kf_descs:
            slot = self._bow_db.add(torch.from_numpy(d).to(self._dev))
            self._store_kf(slot, d, u, x, po)
        self._kf_descs = []

    def _harvest_queries(self, host_results=None) -> None:
        """Read the pending BoW query results and dispatch the geometric
        verification of the best surviving candidate of each."""
        if not self._pending_queries:
            return
        pending, self._pending_queries = self._pending_queries, []
        if host_results is None:
            host_results = _to_host([tuple(r) for _, _, r, _ in pending])
        for (entry_seq, entry, _, timestamp), (ids, scores, valid) in zip(
                pending, host_results):
            for i in range(self.loop_top_k):
                if valid[i] < 0.5:
                    continue
                cand, score = int(ids[i]), float(scores[i])
                if cand not in self._kf_store or score < self.loop_min_score:
                    continue
                cand_seq = self._kf_store[cand][0]
                if entry_seq - cand_seq < self.loop_min_gap:
                    continue
                # the entry may have left the store by DB-ring wrap
                if entry not in self._kf_store \
                        or self._kf_store[entry][0] != entry_seq:
                    break
                rec = dict(keyframe=entry_seq, candidate=cand_seq,
                           score=round(score, 4), timestamp=timestamp)
                if self.loop_geometric_check:
                    verdict = self._dispatch_verify(entry, cand)
                    self._pending_loops.append(
                        (rec, verdict, cand_seq, entry_seq))
                else:
                    self.loop_candidates.append(rec)
                    self.stats["loop_candidates"] += 1
                break

    def _store_kf(self, slot: int, desc: np.ndarray, uv: np.ndarray,
                  xyz: Optional[np.ndarray] = None, pose=None) -> int:
        """Store a buffered keyframe's padded device arrays under its DB
        slot (uploaded once, reused by every later verification)."""
        cap = self.config.map.max_obs_per_keyframe
        n = min(len(desc), cap)
        dd = np.zeros((cap, 256), np.uint8)
        uu = np.zeros((cap, 2), np.float32)
        xx = np.zeros((cap, 3), np.float32)
        dd[:n] = desc[:n]
        uu[:n] = uv[:n]
        if xyz is not None:
            xx[:n] = xyz[:n]
        if pose is None:
            pose = (np.asarray([1., 0., 0., 0.], np.float32),
                    np.zeros(3, np.float32))
        dev = self._dev
        seq = self._kf_seq
        self._kf_seq += 1
        self._kf_store[slot] = (
            seq, torch.from_numpy(dd).to(dev), torch.from_numpy(uu).to(dev),
            torch.arange(cap, device=dev) < n, torch.from_numpy(xx).to(dev),
            torch.as_tensor(pose[0], dtype=torch.float32, device=dev),
            torch.as_tensor(pose[1], dtype=torch.float32, device=dev))
        return seq

    def _store_kf_block(self, slot: int, kf: tracker.KeyframeBlock) -> int:
        """Store a keyframe block's device arrays as they are."""
        seq = self._kf_seq
        self._kf_seq += 1
        self._kf_store[slot] = (seq, kf.desc_bits, kf.uv, kf.mask, kf.xyz_w,
                                kf.q_wc, kf.t_wc)
        return seq

    def _dispatch_verify(self, entry: int, cand: int):
        _, d1, uv1, m1, _, _, _ = self._kf_store[entry]
        _, d2, uv2, m2, xyz2, _, _ = self._kf_store[cand]
        return verify_loop(self.config, self._k, d1, uv1, m1, d2, uv2, m2,
                           xyz2, entry * 9973 + cand, self.sampler)

    def warmup_place(self) -> None:
        """Run the place programs once on dummy data (the reference
        compiles them here): one verification, one query if a database
        exists, and the loop / relocalization corrections as exact no-ops
        (sequence id -1 is never in the ring).  The database is not
        changed."""
        cap = self.config.map.max_obs_per_keyframe
        dev = self._dev
        d = torch.zeros((cap, 256), dtype=torch.uint8, device=dev)
        uv = torch.zeros((cap, 2), dtype=torch.float32, device=dev)
        m = torch.zeros(cap, dtype=torch.bool, device=dev)
        xyz = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
        q = lie.quat_identity(device=dev)
        t = torch.zeros(3, dtype=torch.float32, device=dev)
        verify_loop(self.config, self._k, d, uv, m, d, uv, m, xyz, 0,
                    self.sampler)
        if self._bow_db is not None:
            self._bow_db.query(d, m, top_k=self.loop_top_k)
        fn = apply_loop_pgo if self.loop_pgo else apply_loop
        self.tracker_state, self.map_state = fn(
            self.config, self.tracker_state, self.map_state, q, t, -1, -1)
        if self.enable_relocalization:
            self.tracker_state = apply_reloc(self.tracker_state, q, t, q, t)

    def _dispatch_reloc(self, fr: FrameResult, out, batch_idx) -> None:
        """Query the database with the LOST frame's payload (not added) and
        dispatch the verification against the best stored candidate; the
        frame's pose rides along for T_corr = T_pnp ∘ T_frozen⁻¹."""
        kf = self._block(out, batch_idx)
        res = self._bow_db.query(kf.desc_bits, kf.mask, top_k=self.loop_top_k)
        ids, scores, valid = _to_host([tuple(res)])[0]
        for i in range(self.loop_top_k):
            if valid[i] < 0.5:
                continue
            cand, score = int(ids[i]), float(scores[i])
            if cand not in self._kf_store or score < self.loop_min_score:
                continue
            _, d2, uv2, m2, xyz2, _, _ = self._kf_store[cand]
            verdict = verify_loop(
                self.config, self._k, kf.desc_bits, kf.uv, kf.mask, d2, uv2,
                m2, xyz2, self.stats["frames"] * 7919 + cand, self.sampler)
            self._pending_reloc = (
                verdict, kf.q_wc, kf.t_wc,
                dict(timestamp=fr.timestamp, score=round(score, 4),
                     candidate=self._kf_store[cand][0]))
            return

    def _consensus(self, pnp_inliers: int) -> bool:
        return pnp_inliers >= max(self.config.ransac.min_pnp_matches,
                                  self.loop_min_inliers)

    def _harvest_reloc(self, host_verdict=None) -> None:
        if self._pending_reloc is None:
            return
        verdict, q_froz, t_froz, rec = self._pending_reloc
        self._pending_reloc = None
        if host_verdict is None:
            host_verdict = _to_host([verdict])[0]
        n_inl, _, _, pnp_inl = host_verdict
        rec["inliers"] = int(n_inl)
        rec["pnp_inliers"] = int(pnp_inl)
        # loop-grade consensus: re-anchoring is as invasive as a correction
        ok = rec["inliers"] >= self.loop_min_inliers \
            and self._consensus(rec["pnp_inliers"])
        rec["applied"] = ok
        self.reloc_log.append(rec)
        if ok:
            TRACER.count("place.verify.passed")
            self.tracker_state = apply_reloc(self.tracker_state, verdict[1],
                                             verdict[2], q_froz, t_froz)
            self.stats["relocalizations"] += 1
            self._lost_streak = 0

    def _harvest_loops(self, host_verdicts=None) -> None:
        if not self._pending_loops:
            return
        if host_verdicts is None:
            host_verdicts = _to_host([v for _, v, _, _ in
                                      self._pending_loops])
        for (rec, verdict, cand_seq, entry_seq), hv in zip(
                self._pending_loops, host_verdicts):
            n_inl, _, t_pnp_h, pnp_inl = hv
            rec["inliers"] = int(n_inl)
            rec["pnp_inliers"] = int(pnp_inl)
            rec["t_pnp"] = [round(float(v), 4) for v in t_pnp_h]
            if rec["inliers"] < self.loop_min_inliers:
                continue
            TRACER.count("place.verify.passed")
            self.loop_candidates.append(rec)
            self.stats["loop_candidates"] += 1
            # a drift correction rewrites the ring and the landmarks: demand
            # the loop gate's consensus of the PnP too
            if self.loop_correction and self._consensus(rec["pnp_inliers"]):
                fn = apply_loop_pgo if self.loop_pgo else apply_loop
                self.tracker_state, self.map_state = fn(
                    self.config, self.tracker_state, self.map_state,
                    verdict[1], verdict[2], cand_seq, entry_seq)
                rec["applied"] = True
                self.stats["loops_applied"] = \
                    self.stats.get("loops_applied", 0) + 1
                # the correction moved the live pose a relocalization in
                # flight froze at dispatch: drop it (it re-dispatches)
                if self._pending_reloc is not None:
                    rrec = self._pending_reloc[3]
                    rrec["applied"] = False
                    rrec["invalidated_by_loop"] = True
                    self.reloc_log.append(rrec)
                    self._pending_reloc = None
        self._pending_loops = []

    def finalize(self) -> None:
        """Flush deferred work (pending frame results, place results, BA
        telemetry) — call once after the last frame."""
        self._drain_results()
        for res, ts in self._pending_ba_results:
            self._record_ba(res, ts)
        self._pending_ba_results = []
        self._harvest_queries()
        self._harvest_loops()
        self._harvest_reloc()

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Full-system checkpoint: the device states, the tracker's
        generator and the host clock and counters (``pipeline/snapshot.py``),
        plus the place-recognition database in ``path + ".place.npz"``, so
        a resumed system can close loops against pre-snapshot keyframes.
        The reference's layout."""
        from dynamic_visual_slam_tpu_torch.pipeline import snapshot
        snapshot.save(path, self.tracker_state, self.map_state, self.config,
                      self.generator, host=dict(
                          t0=self._t0, last_ba_t=self._last_ba_t,
                          stats=self.stats))
        if self._bow_db is None:
            return
        db, voc = self._bow_db, self._bow_db.vocabulary
        extra = dict(vectors=db.vectors.cpu().numpy(),
                     used=db.used.cpu().numpy(), count=db.count,
                     word_weights=voc.word_weights.cpu().numpy(),
                     voc_k=np.asarray(voc.k), voc_depth=np.asarray(voc.depth),
                     kfseq_counter=self._kf_seq)
        for l, (lv, va) in enumerate(zip(voc.levels, voc.valid)):
            extra[f"voc_level_{l}"] = lv.cpu().numpy()
            extra[f"voc_valid_{l}"] = va.cpu().numpy()
        names = ("desc", "uv", "mask", "xyz", "q", "t")
        for slot, (seq, *arrays) in self._kf_store.items():
            extra[f"kf_{slot}_seq"] = np.asarray(seq)
            for name, a in zip(names, arrays):
                extra[f"kf_{slot}_{name}"] = a.cpu().numpy()
        np.savez_compressed(path + ".place", **extra)

    def restore(self, path: str) -> None:
        """Load a ``save`` checkpoint (the config must equal this
        system's); the reference's checkpoints too.  In-flight recovery
        state is dropped: a pending relocalization verdict, BoW queries and
        loop verdicts were computed against pre-restore poses and slots;
        the lost streak restarts."""
        import os
        from dataclasses import fields as dataclass_fields

        from dynamic_visual_slam_tpu_torch.pipeline import snapshot
        gen = torch.Generator(device=self._dev)
        ts, ms, cfg = snapshot.load(path, self._dev, gen)
        if cfg != self.config:
            diff = [f.name for f in dataclass_fields(cfg)
                    if getattr(cfg, f.name) != getattr(self.config, f.name)]
            raise ValueError(
                "snapshot config mismatch — the checkpoint was written "
                f"with different settings (sections differing: {diff}); "
                "construct the system with the checkpoint's config "
                "(snapshot.load returns it) or rerun with matching flags")
        self.generator.set_state(gen.get_state())
        self.tracker_state = ts
        self.map_state = ms
        self._n_kf_host = int(ms.keyframes.count)
        self._pending_reloc = None
        self._pending_queries = []
        self._pending_loops = []
        self._lost_streak = 0
        # the host sequence counter follows the device ring (apply_loop
        # anchors corrections by sequence id); the place file overrides it
        self._kf_seq = int(ms.keyframes.count)
        host = snapshot.load_host(path)
        if host is not None:
            # the port's own snapshot: resume the time base, the BA timer
            # and the counters (the relocalization draws' key) exactly
            self._t0, self._last_ba_t = host["t0"], host["last_ba_t"]
            self.stats = dict(host["stats"])
        place_path = path + ".place.npz"
        if not os.path.exists(place_path):
            return
        dev = self._dev
        with np.load(place_path) as data:
            files = set(data.files)
            depth = int(data["voc_depth"]) if "voc_depth" in files \
                else self.config.place.depth
            voc_k = int(data["voc_k"]) if "voc_k" in files \
                else self.config.place.branching
            voc = bow._vocabulary(
                voc_k, depth, [data[f"voc_level_{l}"] for l in range(depth)],
                [data[f"voc_valid_{l}"] for l in range(depth)],
                data["word_weights"], dev)
            self._bow_db = bow.Database(
                voc, capacity=self.config.place.max_db_entries,
                vectors=torch.from_numpy(data["vectors"]).to(dev),
                used=torch.from_numpy(data["used"]).to(dev),
                count=int(data["count"]))
            self._kf_seq = int(data["kfseq_counter"])
            cap = self.config.map.max_obs_per_keyframe
            defaults = dict(xyz=np.zeros((cap, 3), np.float32),
                            q=np.asarray([1., 0., 0., 0.], np.float32),
                            t=np.zeros(3, np.float32))
            self._kf_store = {}
            for key in data.files:
                if not (key.startswith("kf_") and key.endswith("_seq")):
                    continue
                slot = int(key.split("_")[1])
                arrays = [torch.from_numpy(np.array(
                    data[f"kf_{slot}_{n}"] if f"kf_{slot}_{n}" in files
                    else defaults[n])).to(dev)
                    for n in ("desc", "uv", "mask", "xyz", "q", "t")]
                self._kf_store[slot] = (int(data[key]), *arrays)

    @traced("pipeline.read")
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
