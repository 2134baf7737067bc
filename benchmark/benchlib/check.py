"""The comparison that decides ``correct``.

Two references, neither importing anything of the port.  ``slamref`` is
the benchmark's frozen copy of the port's plain PyTorch path, a regression
golden model: it finds where the port departs from the plain path it was
proven against, not a fault the two share.  ``orb_independent`` holds what
kernels B1 and B2 compute to the published ORB algorithm, written apart
from both.  Once the window has closed, they work out again, on the same
device and from the same inputs, what the timed path produced in the steps
the seed drew:

- ORB extraction (kernels B1 and B2 in the port, their plain versions in
  ``slamref``) from the frames the benchmark handed over, and, on a few
  frames a step, each keypoint's score, peak and bits by the independent
  transcription;
- the tracker's step from the tracker state the port held before that
  step, with the port's random state at that point, from the reference's
  own keypoints (and, in the dynamic cell, the port's detections: the
  detector's host-side box tracks carry state from frame to frame);
- a BA round (with the tracker feedback) from the port's map and tracker
  state before it;
- a keyframe insert after the first drawn step, from the port's map state
  and tracker output before it;
- each loop verification from the keyframes it compared, and a loop
  correction (spread over the ring, or by the pose graph) from the port's
  tracker and map state and verdict before it;
- the detector's network and NMS from the frame's RGB.

The reference follows the port's state step by step: a SLAM run diverges
from any second run after a few frames (RANSAC), so there is no
independent trajectory to compare with.  Each kind of step that hands the
state on (track, insert, BA, loop correction) is compared itself.

``numbers`` returns each number compared; ``control=True`` puts the
reference computed one precision lower in the port's place (TF32 in the
float32 stages, float8 activations and weights in the bf16 detector), the
control that the limits have to fail.
"""

from __future__ import annotations

import contextlib
import inspect
import math
from typing import Any, Dict, List

import numpy as np
import torch

from benchlib import orb_independent
from benchlib.drivers import build_config

MM = 1000.0
INDEP_FRAMES = 3     # frames a drawn step that the independent ORB judges


@contextlib.contextmanager
def precision(low: bool):
    """float32 with TF32 off and bf16 activations, or (``low``) TF32 on and
    float8 activations."""
    from slamref.models import yolov8
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(), yolov8.ACT_DTYPE)
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    torch.set_float32_matmul_precision("high" if low else "highest")
    yolov8.ACT_DTYPE = torch.float8_e4m3fn if low else torch.bfloat16
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
        yolov8.ACT_DTYPE = saved[3]


def _ref_types() -> Dict[str, type]:
    from slamref.backend import ba, mapping
    from slamref.frontend import orb, tracker
    reg = {}
    for mod in (orb, tracker, mapping, ba):
        for name, obj in vars(mod).items():
            if isinstance(obj, type) and issubclass(obj, tuple) \
                    and hasattr(obj, "_fields"):
                reg[name] = obj
    return reg


def to_ref(x: Any, reg: Dict[str, type]) -> Any:
    """The port's named tuples as the reference's classes of the same
    name; tensors as they are."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return reg[type(x).__name__](*(to_ref(v, reg) for v in x))
    return x


def _t_gap_mm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double(), dim=-1).max()) \
        * MM if a.numel() else 0.0


def _rot_gap_deg(qa: torch.Tensor, qb: torch.Tensor) -> float:
    """The largest rotation between unit quaternions, 4 asin(d / 2) with d
    the distance of qa to the nearer of qb and -qb (well conditioned near
    nought, where acos of their dot product is not)."""
    if not qa.numel():
        return 0.0
    qa, qb = qa.double(), qb.double()
    d = torch.minimum(torch.linalg.vector_norm(qa - qb, dim=-1),
                      torch.linalg.vector_norm(qa + qb, dim=-1))
    return float((4.0 * torch.asin((d / 2).clamp(max=1.0))).max()) \
        * 180.0 / math.pi


class Reference:
    """The reference's configuration, intrinsics and (for the dynamic cell)
    detector, built by the benchmark from the cell's files."""

    def __init__(self, cell, device: torch.device):
        from slamref.config import SLAMConfig
        from slamref.core.camera import Intrinsics
        from slamref.semantic.classes import filtered_mask
        self.cell = cell
        self.device = device
        self.cfg = build_config(cell.config, SLAMConfig)
        self.k = Intrinsics.from_config(self.cfg.camera)
        self.filtered = filtered_mask(self.cfg, device)
        self.reg = _ref_types()
        self._models: Dict[bool, Any] = {}

    def model(self, low: bool):
        """YOLOv8n from the mix's weights file (float8-rounded weights for
        the control) and its input size."""
        if low not in self._models:
            from benchlib.spec import ROOT
            from slamref.models.weights import build_model
            model, size = build_model(
                str(ROOT / self.cell.traffic["detector"]["weights"]),
                self.device)
            if low:
                for p in model.parameters():
                    p.data = p.data.to(torch.float8_e4m3fn).to(torch.float32)
            self._models[low] = (model, size or self.cfg.semantic.input_size)
        return self._models[low]

    def ref(self, x):
        return to_ref(x, self.reg)


class Gaps:
    """The numbers compared, each the worst over what the run sampled."""

    def __init__(self):
        self.orb_slots = 0
        self.orb_bad = 0
        self.indep_slots = 0
        self.indep_bad = 0
        self.vals: Dict[str, float] = {}
        self.counts = 0          # discrete disagreements

    def worst(self, name: str, v: float) -> None:
        if math.isnan(v):
            v = math.inf
        self.vals[name] = max(self.vals.get(name, 0.0), v)

    def result(self) -> Dict[str, float]:
        out = dict(self.vals)
        if self.orb_slots:
            out["orb_mismatch"] = self.orb_bad / self.orb_slots
        if self.indep_slots:
            out["orb_indep_mismatch"] = self.indep_bad / self.indep_slots
        out["flag_mismatch"] = float(self.counts)
        return out

    # -- comparisons ---------------------------------------------------------
    def keypoints(self, p, r) -> None:
        """Slots where either side has a keypoint; a slot differs if its
        mask, position, level, orientation or any descriptor bit does."""
        if p.mask.shape != r.mask.shape:
            self.orb_slots += int(r.mask.numel())
            self.orb_bad += int(r.mask.numel())
            return
        either = p.mask | r.mask
        same = (p.mask == r.mask) & (p.uv == r.uv).all(-1) \
            & (p.octave == r.octave) & (p.angle == r.angle) \
            & (p.desc_bits == r.desc_bits).all(-1)
        self.orb_slots += int(either.sum())
        self.orb_bad += int((either & ~same).sum())

    def independent(self, levels, smoothed, kps, orb_cfg) -> None:
        """One frame's keypoints against the independent transcription."""
        n, bad = orb_independent.mismatch(levels, smoothed, kps, orb_cfg)
        self.indep_slots += n
        self.indep_bad += bad

    def poses(self, qp, tp, qr, tr) -> None:
        if tp.shape != tr.shape:
            self.worst("pose_gap_mm", math.inf)
            return
        self.worst("pose_gap_mm", _t_gap_mm(tp, tr))
        self.worst("rot_gap_deg", _rot_gap_deg(qp, qr))

    def track(self, p_state, p_out, r_state, r_out) -> None:
        """The step's poses and flags, and the state it hands on: pose,
        frame counters, whether a previous frame and a keyframe are held."""
        self.poses(p_out.q_wc, p_out.t_wc, r_out.q_wc, r_out.t_wc)
        self.poses(p_state.q_wc, p_state.t_wc, r_state.q_wc, r_state.t_wc)
        for a, b in ((p_out.tracking_ok, r_out.tracking_ok),
                     (p_out.is_keyframe, r_out.is_keyframe),
                     (p_state.frame_idx, r_state.frame_idx),
                     (p_state.frames_since_kf, r_state.frames_since_kf),
                     (p_state.has_prev, r_state.has_prev),
                     (p_state.has_kf, r_state.has_kf)):
            self.counts += int((a != b).sum()) if a.shape == b.shape \
                else int(b.numel())

    def ba(self, p_res, r_res, p_t=None, r_t=None) -> None:
        fc_p, fc_r = p_res.final_cost.double(), r_res.final_cost.double()
        self.worst("ba_cost_gap", float(((fc_p - fc_r).abs()
                                         / fc_r.abs().clamp(min=1e-12)).max()))
        self.worst("ba_pose_gap_mm", _t_gap_mm(p_res.t_wc, r_res.t_wc))
        if p_t is not None:
            self.worst("ba_pose_gap_mm", _t_gap_mm(p_t.t_wc, r_t.t_wc))

    def exact(self, a, b) -> None:
        """Elements of two named tuples of tensors that differ."""
        for x, y in zip(a, b):
            if isinstance(x, tuple):
                self.exact(x, y)
            elif x.shape != y.shape:
                self.counts += int(y.numel())
            else:
                self.counts += int((x != y).sum())

    def map_state(self, p, r) -> None:
        """A keyframe insert's map: every field but the landmarks'
        positions exactly (copies, counts, flags, rings), the positions of
        the landmarks active on either side to ``map_xyz_gap_mm``."""
        lp, lr = p.landmarks, r.landmarks
        self.exact(lp._replace(xyz=lp.active), lr._replace(xyz=lr.active))
        self.exact(p.keyframes, r.keyframes)
        if lp.xyz.shape == lr.xyz.shape:
            act = lp.active | lr.active
            self.worst("map_xyz_gap_mm", _t_gap_mm(lp.xyz[act], lr.xyz[act]))
        else:
            self.worst("map_xyz_gap_mm", math.inf)

    def loop(self, p_t, p_m, r_t, r_m) -> None:
        """A loop correction: the ring's poses, the tracker's pose and
        anchor points, the landmarks' positions."""
        kp, kr = p_m.keyframes, r_m.keyframes
        lp, lr = p_m.landmarks, r_m.landmarks
        if kp.t.shape != kr.t.shape or lp.xyz.shape != lr.xyz.shape:
            self.worst("loop_gap_mm", math.inf)
            return
        act, lact = kp.active | kr.active, lp.active | lr.active
        self.counts += int((kp.active != kr.active).sum()) \
            + int((lp.active != lr.active).sum())
        self.worst("loop_gap_mm", max(
            _t_gap_mm(kp.t[act], kr.t[act]), _t_gap_mm(p_t.t_wc, r_t.t_wc),
            _t_gap_mm(p_t.kf_xyz_w, r_t.kf_xyz_w),
            _t_gap_mm(lp.xyz[lact], lr.xyz[lact])))
        self.worst("loop_rot_gap_deg", max(
            _rot_gap_deg(kp.q[act], kr.q[act]),
            _rot_gap_deg(p_t.q_wc, r_t.q_wc)))

    def verify(self, p, r) -> None:
        fm_p, q_p, t_p, n_p = p
        fm_r, q_r, t_r, n_r = r
        self.counts += int(int(fm_p) != int(fm_r)) + int(int(n_p) != int(n_r))
        if int(n_p) > 0 and int(n_r) > 0:
            self.poses(q_p, t_p, q_r, t_r)

    def detector(self, p_heads, p_raw, r_heads, r_raw) -> None:
        gap = 0.0
        for (pb, pc), (rb, rc) in zip(p_heads, r_heads):
            for a, b in ((pb, rb), (pc, rc)):
                if a.shape != b.shape:
                    gap = math.inf
                    continue
                gap = max(gap, float((a.float() - b.float()).abs().max()
                                     / b.float().abs().max().clamp(min=1e-12)))
        self.worst("det_logit_gap", gap)
        if p_raw.valid.shape != r_raw.valid.shape:
            self.worst("det_box_gap_px", math.inf)
            return
        self.counts += int((p_raw.valid != r_raw.valid).sum())
        both = p_raw.valid & r_raw.valid
        box = float((p_raw.boxes - r_raw.boxes).abs().max(-1).values[both]
                    .max()) if bool(both.any()) else 0.0
        self.worst("det_box_gap_px", box)


def _stack(driver, tag, key: str) -> np.ndarray:
    return np.stack([driver.frames[i][key] for i, _ in driver.handed[tag]])


def _ts(driver, tag) -> torch.Tensor:
    """The step's stamps since the stream's first (stamps start at 0)."""
    return torch.tensor([ts for _, ts in driver.handed[tag]],
                        dtype=torch.float32, device=driver.device)


def _independent(g: Gaps, grays: torch.Tensor, kps, tag, ref) -> None:
    """Up to ``INDEP_FRAMES`` frames of a step, drawn from its index (which
    the seed drew), against the independent ORB: the levels and blurred
    levels as the reference builds them, in float32 with TF32 off."""
    from slamref.ops import image as imops
    o = ref.cfg.orb
    if kps.mask.shape[0] != grays.shape[0]:     # frames left out
        g.indep_slots += int(kps.mask.numel()) or 1
        g.indep_bad += int(kps.mask.numel()) or 1
        return
    pick = np.random.default_rng(int(tag) if isinstance(tag, int) else 0) \
        .choice(grays.shape[0], size=min(INDEP_FRAMES, grays.shape[0]),
                replace=False)
    with precision(False):
        for j in sorted(int(i) for i in pick):
            levels = imops.build_pyramid(grays[j].to(torch.float32),
                                         o.n_levels, o.scale_factor)
            smoothed = [torch.clamp(torch.round(imops.gaussian_blur(
                lv, 7, 2.0)), 0.0, 255.0) for lv in levels]
            g.independent(levels, smoothed, type(kps)(*(a[j] for a in kps)),
                          o)


def _bound(fn, rec) -> Dict[str, Any]:
    """A captured call's arguments by the reference function's names."""
    b = inspect.signature(fn).bind(*rec["args"], **rec["kwargs"])
    return dict(b.arguments)


def numbers(driver, captured: Dict[str, List[Dict[str, Any]]],
            ref: Reference, control: bool = False) -> Dict[str, float]:
    """Each number compared, from the steps and rounds ``captured``."""
    from slamref import pipeline
    from slamref.frontend import orb, tracker
    from slamref.semantic.detector import detect_frame
    dev = driver.device
    g = Gaps()
    entry = driver.cell.traffic["entry"]
    extracts = {}
    for rec in captured.get("extract", []):
        extracts.setdefault(rec["tag"], rec)

    def gen_at(state):
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        return tracker.generator_sampler(gen)

    def both(fn):
        """(the port's or the control's result, the reference's)."""
        with precision(False):
            r = fn()
        if control:
            with precision(True):
                return fn(), r
        return None, r

    for rec in captured.get("track", []):
        tag = rec["tag"]
        grays = torch.from_numpy(_stack(driver, tag, "gray")).to(dev)
        depths = torch.from_numpy(_stack(driver, tag, "depth")).to(dev)
        ts = _ts(driver, tag)
        state = ref.ref(rec["args"][1])
        if entry == "process_batch":
            def run():
                kps = orb.extract_batch(grays, ref.cfg.orb)
                st, out = tracker.track_batch(
                    ref.cfg, state, kps, depths, ts, gen_at(rec["extra"]),
                    filtered=ref.filtered)
                return kps, st, out
        else:
            det = rec["kwargs"].get("det")
            det = None if det is None else ref.ref(det)

            def run():
                kps = orb.extract_batch(grays, ref.cfg.orb)
                st, out = tracker.track_step(
                    ref.cfg, state, grays[0], depths[0], ts[0],
                    gen_at(rec["extra"]), det=det, filtered=ref.filtered,
                    kps=orb.Keypoints(*(a[0] for a in kps)))
                return kps, st, out
        low, (kps_r, st_r, out_r) = both(run)
        if low is not None:
            kps_p, (st_p, out_p) = low[0], low[1:]
        else:
            kps_p = extracts[tag]["out"] if tag in extracts else None
            st_p, out_p = rec["out"]
        if kps_p is None:
            g.orb_slots += int(kps_r.mask.numel())
            g.orb_bad += int(kps_r.mask.numel())
        else:
            g.keypoints(kps_p, kps_r)
            _independent(g, grays, kps_p, tag, ref)
        g.track(st_p, out_p, st_r, out_r)

    for rec in captured.get("ba", []):
        cfg_ba, k_ba = ref.cfg, ref.k
        m, t = ref.ref(rec["args"][2]), ref.ref(rec["args"][3])
        low, (m_r, t_r, res_r) = both(
            lambda: pipeline.run_ba_fb(cfg_ba, k_ba, m, t))
        _, t_p, res_p = low if low is not None else rec["out"]
        g.ba(res_p, res_r, t_p, t_r)

    for rec in captured.get("ba_streams", []):
        from slamref.backend import ba
        m = ref.ref(rec["args"][2])
        low, (_, res_r) = both(lambda: ba.run_ba_streams(ref.cfg, ref.k, m))
        _, res_p = low if low is not None else rec["out"]
        g.ba(res_p, res_r)

    for rec in captured.get("verify", []):
        a = rec["args"]
        low, r = both(lambda: pipeline.verify_loop(
            ref.cfg, ref.k, *a[2:9], a[9], None))
        g.verify(low if low is not None else rec["out"], r)

    for rec in captured.get("detect", []):
        tag = rec["tag"]
        rgb = driver.frames[driver.handed[tag][0][0]]["rgb"]
        sc = ref.cfg.semantic

        def run(low):
            model, size = ref.model(low)
            heads, raw = detect_frame(model, rgb, size, sc.max_detections,
                                      sc.score_threshold, sc.iou_threshold)
            return heads, raw
        with precision(False):
            heads_r, raw_r = run(False)
        if control:
            with precision(True):
                heads_p, raw_p = run(True)
        else:
            heads_p, raw_p = rec["heads"][0], rec["out"]
        g.detector(heads_p, raw_p, heads_r, raw_r)

    fleet_kps: Dict[Any, List[Any]] = {}
    for rec in captured.get("extract", []):
        fleet_kps.setdefault(rec["tag"], []).append(rec["out"])
    scan_step: Dict[Any, int] = {}
    for rec in captured.get("track_streams", []):
        # the n-th capture of a call is its scan step n; its extraction is
        # the call's n-th extraction
        tag = rec["tag"]
        t_idx = scan_step[tag] = scan_step.get(tag, -1) + 1
        items = driver.handed[tag][t_idx * driver.streams:
                                   (t_idx + 1) * driver.streams]
        grays = torch.from_numpy(np.stack(
            [driver.frames[i]["gray"] for i, _ in items])).to(dev)
        depths = torch.from_numpy(np.stack(
            [driver.frames[i]["depth"] for i, _ in items])).to(dev)
        ts = torch.tensor([t for _, t in items],
                          dtype=torch.float32, device=dev)
        state = ref.ref(rec["args"][1])

        def run():
            kps = orb.extract_batch(grays, ref.cfg.orb)
            st, out = tracker.track_streams(
                ref.cfg, state, kps, depths, ts, gen_at(rec["extra"]),
                filtered=ref.filtered)
            return kps, st, out
        low, (kps_r, st_r, out_r) = both(run)
        if low is not None:
            kps_p, (st_p, out_p) = low[0], low[1:]
        else:
            kps_p = fleet_kps[tag][t_idx]
            st_p, out_p = rec["out"]
        g.keypoints(kps_p, kps_r)
        _independent(g, grays, kps_p, tag * 1000 + t_idx, ref)
        g.track(st_p, out_p, st_r, out_r)

    from slamref.backend import mapping
    for kind, fn in (("insert", mapping.insert_keyframe),
                     ("insert_streams", mapping.insert_keyframe_streams)):
        for rec in captured.get(kind, []):
            a = {k: ref.ref(v) for k, v in _bound(fn, rec).items()}
            a.update(cfg=ref.cfg, filtered_mask=ref.filtered)
            low, r = both(lambda: fn(**a))
            p = low if low is not None else rec["out"]
            if kind == "insert":       # (state, stats)
                p, r = p[0], r[0]
            g.map_state(p, r)

    for kind, fn in (("loop", pipeline.apply_loop),
                     ("loop_pgo", pipeline.apply_loop_pgo)):
        for rec in captured.get(kind, []):
            a = {k: ref.ref(v) for k, v in _bound(fn, rec).items()}
            a.update(cfg=ref.cfg)
            low, (t_r, m_r) = both(lambda: fn(**a))
            t_p, m_p = low if low is not None else rec["out"]
            g.loop(t_p, m_p, t_r, m_r)
    return g.result()


def judge(values: Dict[str, float], limits: Dict[str, float],
          required: List[str]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number the cell requires that the
    run could not read counts as infinite."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name)
        if v is None:
            if name not in required:
                continue
            v = math.inf
        out[name] = {"value": v, "limit": limit}
    return out


def is_correct(judged: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(j["value"]) and j["value"] <= j["limit"]
               for j in judged.values())
