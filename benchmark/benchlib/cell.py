"""One run of one cell: render, warm up, measure for ``seconds``, then
compare what the window produced with the plain reference.

Timeline: the process starts (``t_start``); frames render; the driver
builds the system, warms it up and flushes the warm-up's results; the
window opens (``setup_s`` ends here), the driver makes entry calls until
``seconds`` have passed, and the window closes once the results still
pending (``sync_every`` > 1) have come back: ``fps`` counts each frame of
the window once, whatever the emission cadence.  In
a traced run the window's first ``profile_steps`` calls run under
``torch.profiler`` (no spans: their synchronisations would fill the device's
idle gaps) and the rest with host spans, the window running on past
``seconds`` until the spans hold a BA round and a keyframe insert (traced
runs report no end-to-end metric).  Steps that the check drew and
had not reached when the window closed run after it, untimed.  Then the
tail is flushed, the peak memory read, the port's system freed, and the
reference run.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchlib import check, drivers, frames as frames_mod, probes as probes_mod
from benchlib import spec, stats, trace as trace_mod

CACHE = spec.ROOT / "build" / "benchmark"
LATE_S = 60.0        # how long past the close a drawn step may still come
# captures armed in a drawn step; the fleet's only in its first scan steps
STEP_KINDS = {"process_batch": ("extract", "track"),
              "process": ("extract", "track", "detect"),
              "step_batch": ("extract", "track_streams")}


def _plan(traffic: Dict[str, Any], seed: int, first: int) -> List[int]:
    """The steps whose outputs are compared: ``check.steps`` of the
    ``check.span`` steps after ``first + check.from``, drawn from the
    seed."""
    c = traffic["check"]
    rng = np.random.default_rng(frames_mod.scene_seed(seed))
    lo = first + int(c.get("from", 0))
    picks = rng.choice(np.arange(lo, lo + int(c["span"])),
                       size=int(c["steps"]), replace=False)
    return sorted(int(p) for p in picks)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, workers: int = 8,
        log=sys.stderr, control: bool = False) -> Dict[str, Any]:
    """One run → the result line's fields (``check`` last).  ``control``
    also reads the control's numbers (``check.numbers``) into
    ``control``; the benchmark's runs do not."""
    from slamref.config import SLAMConfig as RefConfig
    ref_cfg = drivers.build_config(cell.config, RefConfig)
    tr = cell.traffic
    t0 = time.time()
    frames = frames_mod.render(dataclasses.asdict(ref_cfg.camera), tr, seed,
                               workers)
    t1 = time.time()
    probes = probes_mod.Probes(device)
    probes.install()
    try:
        driver = drivers.DRIVERS[tr["entry"]](cell, frames, device, probes)
        t2 = time.time()
        driver.warmup()
        print(f"set-up: {t0 - t_start:.3f} s imports, {t1 - t0:.3f} s "
              f"rendering {len(frames)} frames, {t2 - t1:.3f} s building "
              f"the system, {time.time() - t2:.3f} s warming up "
              f"({driver.k} steps)", file=log)
        res = _window(cell, driver, probes, seed, seconds, traced, ref_cfg,
                      t_start, log)
    finally:
        probes.uninstall()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    driver.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.Reference(cell, device)
    values = check.numbers(driver, probes.captured, ref)
    print("compared: " + ", ".join(
        f"{len(v)} {k}" for k, v in sorted(probes.captured.items())),
        file=log)
    judged = check.judge(values, cell.limits, tr["check"].get("require", []))
    res["correct"] = check.is_correct(judged) and res["failed"] == 0
    res["device"]["memory_peak_bytes"] = int(peak)
    if control:
        res["control"] = check.numbers(driver, probes.captured, ref,
                                       control=True)
    res["check"] = judged
    return res


def _window(cell, driver, probes, seed, seconds, traced, ref_cfg, t_start,
            log) -> Dict[str, Any]:
    tr = cell.traffic
    c = tr["check"]
    first = driver.k
    n_profile = int(tr.get("profile_steps", 1)) if traced else 0
    plan = _plan(tr, seed, first + n_profile)
    scan = int(c.get("scan_steps", 0))
    ba_kind = "ba_streams" if tr["entry"] == "step_batch" else "ba"
    kinds = STEP_KINDS[tr["entry"]]

    insert_kind = "insert_streams" if tr["entry"] == "step_batch" \
        else "insert"

    def step():
        """One entry call; a drawn step runs with its captures armed, and
        the first drawn step arms the next BA round's and keyframe
        insert's."""
        k = driver.k
        if k not in plan:
            return driver.step()
        probes.tag = k
        for kind in kinds:
            probes.arm(kind, scan or math.inf)
        if k == plan[0]:
            probes.arm(ba_kind, int(c.get("ba", 0)))
            probes.arm(insert_kind, int(c.get("insert", 1)))
        try:
            return driver.step()
        finally:
            for kind in kinds:
                probes.disarm(kind)
            probes.tag = None

    driver.finish()        # nothing of the warm-up pending at the open
    returned0 = driver.returned
    probes.arm("verify", int(c.get("verify", 0)))
    for kind in ("loop", "loop_pgo"):
        probes.arm(kind, int(c.get("loop", 1)))
    lat: List[float] = []
    prof = prof_res = span_from = None
    prof_steps = 0
    prof_wall = prof_read = 0.0
    driver.sync()
    open_counts = driver.counters()
    mhz0 = _cpu_mhz()
    gc_clock = _GcClock()
    setup_s = time.time() - t_start
    cpu_w0 = time.process_time()
    t_w0 = t_end = time.perf_counter()
    if n_profile:
        probes.annotate = True
        prof = trace_mod.start(driver.device.type == "cuda")
    while True:
        _, l = step()
        lat += l or []
        t_end = time.perf_counter()
        if prof is not None and driver.k - first >= n_profile:
            driver.sync()
            prof_steps = driver.k - first
            t_stop = time.perf_counter()
            prof_wall = t_stop - t_w0
            prof_res = trace_mod.stop(prof, CACHE / "trace.json")
            prof_read = time.perf_counter() - t_stop
            # reading the trace is not the window's time
            t_w0 += prof_read
            prof = None
            probes.annotate = False
            probes.tracing = True
            span_from = dict(driver.counters(), k=driver.k,
                             t=time.perf_counter())
        if t_end - t_w0 >= seconds and prof is None and (
                span_from is None or driver.k > span_from["k"]
                and (_spans_whole(probes)
                     or t_end - t_w0 >= seconds + LATE_S)):
            break
    flushed = driver.finish()    # the window's last results, inside it
    t_end = time.perf_counter()
    window_s = t_end - t_w0
    cpu_s = time.process_time() - cpu_w0
    gc_clock.stop()
    capture_s = probes.capture_s
    returned = driver.returned - returned0
    probes.tracing = False
    span_to = dict(driver.counters(), k=driver.k, t=t_end)
    attempted = (driver.k - first) * driver.per_step
    # drawn steps, a BA round and an insert that the window did not reach:
    # untimed
    t_late = time.perf_counter()
    while (driver.k <= plan[-1] or probes.armed.get(ba_kind, 0) > 0
           or probes.armed.get(insert_kind, 0) > 0) \
            and time.perf_counter() - t_late < LATE_S:
        step()
    late = driver.k - first - attempted // driver.per_step
    driver.finish()
    failed = max(0, attempted - returned)
    res: Dict[str, Any] = {
        "correct": False, "attempted": int(attempted), "failed": int(failed),
        "metrics": {},
        "device": {"platform": "gpu", "kind": _device_name(driver.device),
                   "count": cell.chips},
    }
    names = {m["name"] for m in cell.end_to_end}
    if not traced:
        m = res["metrics"]
        m["fps"] = {"value": stats.rate(returned, window_s),
                    "unit": "frames/s"}
        if "frame_ms_p95" in names:
            m["frame_ms_p95"] = {"value": stats.percentile(lat, 95) * 1e3,
                                 "unit": "ms"}
        m["setup_s"] = {"value": setup_s, "unit": "s"}
    print(f"window {window_s:.3f} s, {returned} results, "
          f"{len(lat)} frame latencies, {late} late steps, "
          f"{flushed} flushed; the process's CPU time {cpu_s:.3f} s; "
          f"{gc_clock.n} garbage collections, {gc_clock.s:.3f} s; "
          f"captures copied in {capture_s:.3f} s; host "
          f"cores' mean clock {mhz0} MHz at the open, {_cpu_mhz()} at the "
          f"close; counts in the window {_delta(open_counts, span_to)}",
          file=log)
    if traced:
        ctx = _context(cell, driver, probes, ref_cfg, prof_res, prof_steps,
                       span_from, span_to)
        ctx["window_frames"] = attempted
        ctx["window_counts"] = _delta(open_counts, span_to)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.bench_dir).read(ctx)
            if v is not None:
                res["metrics"][m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        res["device"]["busy_s"] = prof_res["busy_s"]
        res["device"]["window_s"] = prof_res["window_s"]
        res["breakdown"] = {"device_ops": prof_res["device_ops"],
                            "idle_gaps": prof_res["idle_gaps"]}
        print(f"profiled {prof_steps} steps in {prof_wall:.3f} s, the trace "
              f"read in {prof_read:.3f} s: {prof_res['launches']} "
              f"launches, busy {prof_res['busy_s']:.6f} of "
              f"{prof_res['window_s']:.6f} s; longest gaps "
              f"{prof_res['longest_gaps']}", file=log)
    return res


def _spans_whole(probes) -> bool:
    """Whether the traced spans hold a BA round and a keyframe insert: the
    traced window runs on past ``seconds`` (by ``LATE_S`` at most) until
    they do, so that every span metric has something to read."""
    return probes.calls.get("ba", 0) > 0 and probes.calls.get("insert", 0) > 0


class _GcClock:
    """The number and seconds of Python's garbage collections from its
    creation to ``stop``."""

    def __init__(self):
        self.n, self.s, self._t0 = 0, 0.0, 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.n += 1
            self.s += time.perf_counter() - self._t0

    def stop(self):
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)


def _cpu_mhz():
    """The host cores' mean clock as the kernel reports it, or None."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return round(sum(mhz) / len(mhz), 1) if mhz else None


def _delta(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    return {k: b[k] - a[k] for k in a if k in b and k not in ("k", "t")}


def _context(cell, driver, probes, ref_cfg, prof_res, prof_steps, span_from,
             span_to) -> Dict[str, Any]:
    """What a per-layer metric's reader may read."""
    span_steps = span_to["k"] - span_from["k"]
    return {
        "cell": cell, "cfg": ref_cfg, "traffic": cell.traffic,
        "extract_frames": driver.extract_frames,
        "detector_size": getattr(getattr(driver, "detector", None), "size",
                                 None),
        "profile": prof_res, "profile_frames": prof_steps * driver.per_step,
        "self_s": dict(probes.self_s), "total_s": dict(probes.total_s),
        "calls": dict(probes.calls),
        "span_frames": span_steps * driver.per_step,
        "span_wall_s": span_to["t"] - span_from["t"],
        "span_keyframes": span_to.get("keyframes", 0)
        - span_from.get("keyframes", 0),
        "span_ba_rounds": span_to.get("ba_runs", 0)
        - span_from.get("ba_runs", 0),
    }


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or why
    it could not."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()
