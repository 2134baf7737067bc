"""Stream pairing + bounded queues — the middleware layer (a copy of the
reference package's ``pipeline/sync.py``).

The reference relies on ROS 2 for transport: depth-30 QoS pub/sub
(frontend.cpp:178), message_filters::ApproximateTime pairing of RGB+depth
(frontend.cpp:185-187) and of detections+keyframes (backend.cpp:183-190).
In-process equivalents here:

- BoundedQueue: drop-oldest ring (QoS depth semantics);
- ApproximateTimeSync: the ApproximateTime policy — greedily emit the
  pair (a, b) whose stamps are closest within a slop window, dropping
  older unmatched entries, matching message_filters behavior for the
  two-stream case;
- this module is the implementation the threaded pipeline
  (pipeline/runner.py) uses.

Quirk fix (SURVEY.md §3.3): the reference backend *stalls* without a YOLO
publisher because the synchronizer never fires.  Here a stream can be marked
optional: when it has produced nothing within the slop of a primary entry,
the primary is emitted alone (detections default to empty).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class BoundedQueue(Generic[T]):
    """Drop-oldest bounded queue (QoS history depth)."""

    def __init__(self, depth: int = 30):
        self._q: Deque[T] = deque(maxlen=depth)
        self.dropped = 0

    def push(self, item: T) -> None:
        if len(self._q) == self._q.maxlen:
            self.dropped += 1
        self._q.append(item)

    def pop(self) -> Optional[T]:
        return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)


class ApproximateTimeSync:
    """Two-stream approximate-time pairing.

    push_a/push_b enqueue (stamp, payload); poll() yields matched
    (stamp_a, payload_a, payload_b) tuples.  If `b_optional`, an `a` entry
    older than the newest `b` by more than `slop` (or with no `b` pending)
    is emitted with payload_b=None once `timeout` newer `a`s have arrived.
    """

    def __init__(self, queue_size: int = 10, slop: float = 0.05,
                 b_optional: bool = False, timeout_entries: int = 2):
        self.slop = slop
        self.b_optional = b_optional
        self.timeout_entries = timeout_entries
        self._a: Deque[Tuple[float, Any]] = deque(maxlen=queue_size)
        self._b: Deque[Tuple[float, Any]] = deque(maxlen=queue_size)
        # push_b arrives from the detector thread while the device thread
        # polls; CPython deques raise on mutation-during-iteration, so all
        # three entry points share one lock.
        self._lock = threading.Lock()

    def push_a(self, stamp: float, payload: Any) -> None:
        with self._lock:
            self._a.append((stamp, payload))

    def push_b(self, stamp: float, payload: Any) -> None:
        with self._lock:
            self._b.append((stamp, payload))

    def poll(self, flush: bool = False) -> List[Tuple[float, Any, Any]]:
        """Emit matched pairs.  With ``flush=True`` (end-of-stream), every
        remaining `a` entry is emitted — paired if a `b` is within slop,
        else with payload_b=None — so shutdown never strands tail frames."""
        with self._lock:
            out = []
            while self._a:
                ta, pa = self._a[0]
                best_j, best_dt = None, self.slop
                for j, (tb, _) in enumerate(self._b):
                    dt = abs(tb - ta)
                    if dt <= best_dt:
                        best_j, best_dt = j, dt
                if best_j is not None:
                    tb, pb = self._b[best_j]
                    # drop all b entries up to and including the match
                    for _ in range(best_j + 1):
                        self._b.popleft()
                    self._a.popleft()
                    out.append((ta, pa, pb))
                    continue
                if self.b_optional and (len(self._a) > self.timeout_entries
                                        or (self._b and self._b[-1][0] > ta + self.slop)):
                    self._a.popleft()
                    out.append((ta, pa, None))
                    continue
                if flush:
                    self._a.popleft()
                    out.append((ta, pa, None))
                    continue
                break
            return out
