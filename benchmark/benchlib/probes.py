"""Spans and captures around the port's public functions.

``Probes.install`` replaces each function of ``TARGETS`` by a wrapper, on
the module or class the port calls it through, and ``uninstall`` puts the
originals back.  A wrapper does up to three things:

- in a traced window (``tracing``): a host span between two
  ``torch.cuda.synchronize()`` calls, summed by layer as total and self time
  (a span less the spans inside it);
- under the profiler (``annotate``): a ``torch.profiler.record_function``
  range named after the layer, so that an idle gap of the device can be put
  down to what the host was doing;
- when its capture kind is armed (``arm``): a copy of its arguments before
  the call and of its result after it, for the comparison with the plain
  reference once the window has closed.
"""

from __future__ import annotations

import collections
import functools
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# (module or class path, attribute, layer or None, capture kind or None)
TARGETS: Tuple[Tuple[str, str, Optional[str], Optional[str]], ...] = (
    ("frontend.orb", "extract_batch", "extract", "extract"),
    ("frontend.tracker", "track_batch", "track", "track"),
    ("frontend.tracker", "track_step", "track", "track"),
    ("frontend.tracker", "track_streams", "track", "track_streams"),
    ("backend.mapping", "insert_keyframe", "insert", "insert"),
    ("backend.mapping", "insert_keyframe_streams", "insert",
     "insert_streams"),
    ("backend.ba", "run_ba", "ba", None),
    ("backend.ba", "run_ba_streams", "ba", "ba_streams"),
    ("pipeline.slam", "run_ba_fb", None, "ba"),
    ("pipeline.slam", "verify_loop", "place", "verify"),
    ("pipeline.slam", "apply_loop", "place", "loop"),
    ("pipeline.slam", "apply_loop_pgo", "place", "loop_pgo"),
    ("place.bow:Database", "add", "place", None),
    ("place.bow:Database", "query", "place", None),
    ("pipeline.slam:SLAMSystem", "process", "pipeline", None),
    ("pipeline.slam:SLAMSystem", "process_batch", "pipeline", None),
    ("parallel.mesh:SLAMFleet", "step_batch", "pipeline", None),
    ("semantic.detector:YoloDetector", "__call__", "detector", None),
    ("models.yolov8", "detect", None, "detect"),
)
PACKAGE = "dynamic_visual_slam_tpu_torch"


def tree_clone(x: Any) -> Any:
    """A copy of every tensor in ``x`` (tuples, named tuples, lists and
    dicts are walked); anything else is kept as it is."""
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: tree_clone(v) for k, v in x.items()}
    return x


def _owner(path: str):
    import importlib
    mod, _, cls = path.partition(":")
    owner = importlib.import_module(f"{PACKAGE}.{mod}")
    return getattr(owner, cls) if cls else owner


class Probes:
    """The wrappers' shared state; one per run."""

    def __init__(self, device: torch.device):
        self.device = device
        self.tracing = False
        self.annotate = False
        self.total_s: Dict[str, float] = collections.defaultdict(float)
        self.self_s: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.Counter()
        self._child: List[float] = []
        self.armed: Dict[str, float] = {}
        self.captured: Dict[str, List[Dict[str, Any]]] = \
            collections.defaultdict(list)
        self.tag: Any = None
        # kind -> callable returning extra state to keep with a capture
        self.extra: Dict[str, Callable[[], Any]] = {}
        self.capture_s = 0.0      # host seconds spent copying captures
        self._originals: List[Tuple[Any, str, Any]] = []

    # -- installation ------------------------------------------------------
    def install(self, targets=TARGETS) -> None:
        for path, attr, layer, kind in targets:
            owner = _owner(path)
            fn = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            self._originals.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, layer, kind))

    def uninstall(self) -> None:
        while self._originals:
            owner, attr, fn = self._originals.pop()
            setattr(owner, attr, fn)

    # -- captures ----------------------------------------------------------
    def arm(self, kind: str, count: float = math.inf) -> None:
        """Capture the next ``count`` calls of ``kind``."""
        self.armed[kind] = count

    def disarm(self, kind: str) -> None:
        self.armed.pop(kind, None)

    def _capture_pre(self, kind: Optional[str], args, kwargs):
        if kind is None or self.armed.get(kind, 0) <= 0:
            return None
        t0 = time.perf_counter()
        self.armed[kind] -= 1
        rec = {"tag": self.tag, "args": tree_clone(args),
               "kwargs": tree_clone(kwargs)}
        if kind in self.extra:
            rec["extra"] = self.extra[kind]()
        if kind == "detect":
            heads: List[Any] = []
            rec["hook"] = args[0].register_forward_hook(
                lambda m, i, o: heads.append(tree_clone(o)))
            rec["heads"] = heads
        self.captured[kind].append(rec)
        self.capture_s += time.perf_counter() - t0
        return rec

    def _capture_post(self, rec, out) -> None:
        if rec is None:
            return
        t0 = time.perf_counter()
        rec["out"] = tree_clone(out)
        if "hook" in rec:
            rec.pop("hook").remove()
        self.capture_s += time.perf_counter() - t0

    # -- the wrapper -------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap(self, fn, layer: Optional[str], kind: Optional[str]):
        probes = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rec = probes._capture_pre(kind, args, kwargs)
            if layer is not None and probes.tracing:
                probes._sync()
                probes._child.append(0.0)
                t0 = time.perf_counter()
                try:
                    out = fn(*args, **kwargs)
                    probes._sync()
                finally:
                    dur = time.perf_counter() - t0
                    child = probes._child.pop()
                    probes.total_s[layer] += dur
                    probes.self_s[layer] += dur - child
                    probes.calls[layer] += 1
                    if probes._child:
                        probes._child[-1] += dur
            elif layer is not None and probes.annotate:
                with torch.profiler.record_function(f"layer:{layer}"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            probes._capture_post(rec, out)
            return out
        return wrapped
