"""The entries the window drives, one class a traffic ``entry``.

A driver builds the port's system for the cell, warms up every shape the
window will use, and then runs one entry call a ``step``: a batch of
``process_batch``, one frame of ``process`` (after the detector, where the
mix has one), or one ``step_batch`` of the fleet.  It keeps, for each step,
which frames it handed over and at which stamps, so that the comparison
with the plain reference can start from the same inputs.

Frames cycle: step k hands over the frames at positions k * per_step + j
at stamps (k * per_step + j) / 30 s, warm-up steps included, so the stamps
run on across the warm-up into the window; the first stamp is 0, so a
stamp is also the time since the stream began.  Position p is frame p mod n
("loop", for a closed trajectory), or, with the mix's ``cycle``
"pingpong", frames 0 .. n - 1 then n - 2 .. 1 and over again, so that an
open trajectory plays forward then back and the camera never jumps.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchlib.spec import ROOT

FPS_IN = 30.0


def frame_at(p: int, n: int, cycle: str = "loop") -> int:
    """The frame shown at position ``p`` of a cycle of ``n`` frames."""
    if cycle == "loop" or n < 2:
        return p % n
    if cycle != "pingpong":
        raise ValueError(f"unknown cycle {cycle!r}")
    m = p % (2 * n - 2)
    return m if m < n else 2 * n - 2 - m


def build_config(config: Dict[str, Any], cls):
    """``cls`` (the port's ``SLAMConfig`` or the reference's) from the
    configuration file: ``preset`` (or the defaults), then ``overrides``
    merged section by section."""
    base = cls.preset(config["preset"]) if config.get("preset") else cls()
    d = base.to_dict()
    for section, vals in config.get("overrides", {}).items():
        d[section] = {**d[section], **vals}
    return cls.from_dict(d)


class Driver:
    """Common state: the frames, the stamps, what each step handed over."""

    per_step = 1          # frames handed over a step
    extract_frames = 1    # frames in one extraction (one B1, one B2 launch)
    streams = 1

    def __init__(self, cell, frames: List[Dict[str, np.ndarray]],
                 device: torch.device, probes):
        from dynamic_visual_slam_tpu_torch.config import SLAMConfig
        self.cell = cell
        self.traffic = cell.traffic
        self.frames = frames
        self.device = device
        self.probes = probes
        self.cfg = build_config(cell.config, SLAMConfig)
        self.k = 0                    # steps made, warm-up included
        self.handed: Dict[Any, List[Tuple[int, float]]] = {}
        self.returned = 0             # results that came back, all steps
        self.tracked = 0              # of them, frames with tracking_ok
        self.cycle = self.traffic.get("cycle", "loop")

    def frame(self, p: int) -> int:
        return frame_at(p, len(self.frames), self.cycle)

    def indices(self, k: int) -> List[Tuple[int, float]]:
        return [(self.frame(k * self.per_step + j),
                 (k * self.per_step + j) / FPS_IN)
                for j in range(self.per_step)]

    def step(self) -> Tuple[int, Optional[List[float]]]:
        """One entry call → (results that came back, per-frame latencies in
        seconds or None)."""
        items = self.indices(self.k)
        if self.probes.tag == self.k:
            self.handed[self.k] = items
        n, lat = self._step(items)
        self.k += 1
        self.returned += n
        return n, lat

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        raise NotImplementedError

    def finish(self) -> int:
        """Results that come back once the input ends."""
        return 0

    def counters(self) -> Dict[str, int]:
        """Counts so far (for per-unit layer metrics): results back, of
        them tracked, keyframes, BA rounds, relocalizations."""
        return {"returned": self.returned, "tracked": self.tracked}

    def close(self) -> None:
        pass


class SystemDriver(Driver):
    """``SLAMSystem`` on one stream."""

    def __init__(self, cell, frames, device, probes):
        super().__init__(cell, frames, device, probes)
        from dynamic_visual_slam_tpu_torch.pipeline.slam import SLAMSystem
        tr = self.traffic
        vocab = str(ROOT / tr["vocab"]) if tr.get("vocab") else None
        self.system = SLAMSystem(
            self.cfg, enable_place_recognition=bool(
                tr.get("place_recognition", True)),
            sync_every=int(tr.get("sync_every", 1)), vocab_path=vocab,
            device=device)
        probes.extra["track"] = self.system.generator.get_state
        self._seen = 0                # trajectory entries counted

    def counters(self) -> Dict[str, int]:
        traj = self.system.trajectory
        self.tracked += sum(1 for fr in traj[self._seen:] if fr.tracking_ok)
        self._seen = len(traj)
        s = self.system.stats
        return {"returned": self.returned, "tracked": self.tracked,
                "keyframes": s["keyframes"], "ba_runs": s["ba_runs"],
                "loop_candidates": s["loop_candidates"],
                "loops_applied": s.get("loops_applied", 0),
                "relocalizations": s["relocalizations"]}

    def warmup(self) -> None:
        """Until ``warmup_steps`` steps are made and BA has fired
        ``warmup_ba_rounds`` times (at most ``warmup_max_steps``)."""
        tr = self.traffic
        if self.system._bow_db is not None:
            self.system.warmup_place()
        need_ba = int(tr.get("warmup_ba_rounds", 1))
        while self.k < int(tr["warmup_steps"]) or \
                self.system.stats["ba_runs"] < need_ba:
            if self.k >= int(tr.get("warmup_max_steps", 10 ** 6)):
                raise RuntimeError(
                    f"warm-up: BA fired {self.system.stats['ba_runs']} times "
                    f"in {self.k} steps, {need_ba} needed")
            self.step()
        self.sync()

    def finish(self) -> int:
        n = len(self.system.trajectory)
        self.system.finalize()
        self.sync()
        got = len(self.system.trajectory) - n
        self.returned += got
        return got

    def close(self) -> None:
        del self.system


class ReplayDriver(SystemDriver):
    """``process_batch`` on batches of ``batch`` host frames (uint8 gray,
    uint16 millimetres: a bag reader's arrays), ``sync_every`` batches
    pending before results come back."""

    def __init__(self, cell, frames, device, probes):
        super().__init__(cell, frames, device, probes)
        self.per_step = self.extract_frames = int(self.traffic["batch"])
        self._stacks: Dict[Tuple[int, ...], Tuple[np.ndarray, np.ndarray]] = {}

    def _step(self, items):
        idx = tuple(i for i, _ in items)
        if idx not in self._stacks:     # the cycle has few distinct batches
            self._stacks[idx] = (
                np.stack([self.frames[i]["gray"] for i in idx]),
                np.stack([self.frames[i]["depth"] for i in idx]))
        gs, ds = self._stacks[idx]
        out = self.system.process_batch(gs, ds, np.asarray(
            [ts for _, ts in items]))
        return len(out), None


class FrameDriver(SystemDriver):
    """``process`` a frame at ``sync_every`` 1: the pose is on the host when
    the call returns.  With a ``detector`` in the mix, ``YoloDetector`` runs
    on the frame's RGB first and its detections go to ``process``; the
    frame's latency counts both."""

    def __init__(self, cell, frames, device, probes):
        super().__init__(cell, frames, device, probes)
        self.detector = None
        det = self.traffic.get("detector")
        if det:
            from dynamic_visual_slam_tpu_torch.semantic.detector import (
                YoloDetector)
            self.detector = YoloDetector(
                self.cfg, weights_path=str(ROOT / det["weights"]),
                device=device)
        self.detections: Dict[Any, Any] = {}

    def _step(self, items):
        (i, ts), = items
        f = self.frames[i]
        t0 = time.perf_counter()
        det = self.detector(f["rgb"]) if self.detector is not None else None
        fr = self.system.process(f["gray"], f["depth"], ts, detections=det)
        lat = time.perf_counter() - t0
        return int(fr is not None), [lat]


TELEM_TRACKING_OK = 7    # step_batch's telemetry: q_wc, t_wc, tracking_ok, ...


class FleetDriver(Driver):
    """``SLAMFleet.step_batch`` of ``steps`` scan steps over ``streams``
    streams, each playing the cycle at its own phase (stream s at offset
    s), from host arrays; the telemetry is read back to the host a call."""

    def __init__(self, cell, frames, device, probes):
        super().__init__(cell, frames, device, probes)
        from dynamic_visual_slam_tpu_torch.parallel.mesh import SLAMFleet
        tr = self.traffic
        self.streams = self.extract_frames = int(tr["streams"])
        self.scan = int(tr["steps"])
        self.per_step = self.scan * self.streams
        self.fleet = SLAMFleet(self.cfg, self.streams, device=device)
        probes.extra["track_streams"] = self.fleet.shards[0].generator.get_state
        self._stacks: Dict[Tuple[int, ...], Tuple[np.ndarray,
                                                  np.ndarray]] = {}

    def indices(self, k: int) -> List[Tuple[int, float]]:
        """Scan step t, stream s: the frame at position k * steps + t + s
        at stamp (k * steps + t) / 30 s, in (t, s) order."""
        return [(self.frame(k * self.scan + t + s),
                 (k * self.scan + t) / FPS_IN)
                for t in range(self.scan) for s in range(self.streams)]

    def _step(self, items):
        i0 = tuple(i for i, _ in items)
        if i0 not in self._stacks:
            idx = list(i0)
            shape = (self.scan, self.streams)
            self._stacks[i0] = (
                np.stack([self.frames[i]["gray"] for i in idx]).reshape(
                    shape + self.frames[0]["gray"].shape),
                np.stack([self.frames[i]["depth"] for i in idx]).reshape(
                    shape + self.frames[0]["depth"].shape))
        gs, ds = self._stacks[i0]
        ts = np.asarray([t for _, t in items], np.float32).reshape(
            self.scan, self.streams)
        telem = self.fleet.step_batch(torch.from_numpy(gs).to(self.device),
                                      torch.from_numpy(ds).to(self.device),
                                      ts)
        host = telem.cpu().numpy()
        self.tracked += int((host[..., TELEM_TRACKING_OK] > 0.5).sum())
        return int(host.shape[0] * host.shape[1]), None

    def counters(self) -> Dict[str, int]:
        return {"returned": self.returned, "tracked": self.tracked,
                "ba_runs": self.fleet.ba_runs}

    def warmup(self) -> None:
        """``warmup_steps`` calls and a BA round."""
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        self.fleet.run_ba(now=self.k * self.scan / FPS_IN)
        self.sync()

    def close(self) -> None:
        del self.fleet


DRIVERS = {"process_batch": ReplayDriver, "process": FrameDriver,
           "step_batch": FleetDriver}
