"""TUM RGB-D dataset reader — the bag-playback equivalent (a copy of the
reference package's ``io/tum.py``).

The reference replays rosbags (launch/bag_playback.launch.xml, README bag
workflow); the rebuild reads TUM RGB-D directories directly:
    rgb.txt / depth.txt    "timestamp filename" indexes
    rgb/*.png (8-bit), depth/*.png (16-bit, 1/5000 m per unit)
    groundtruth.txt        TUM-format trajectory
Pairs rgb↔depth by nearest timestamp within a slop — the same
ApproximateTime semantics as the reference's message_filters sync
(frontend.cpp:185-187).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

TUM_DEPTH_SCALE = 1.0 / 5000.0


def _read_index(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            stamp, fname = line.split()[:2]
            out.append((float(stamp), fname))
    return out


def associate(a: List[Tuple[float, str]], b: List[Tuple[float, str]],
              max_dt: float = 0.02) -> List[Tuple[float, str, str]]:
    """Greedy nearest-timestamp pairing (TUM associate.py semantics)."""
    pairs = []
    j = 0
    used = set()
    for ta, fa in a:
        best, best_dt = None, max_dt
        while j > 0 and b[j - 1][0] > ta - max_dt:
            j -= 1
        for k in range(j, len(b)):
            tb, fb = b[k]
            if tb > ta + max_dt:
                break
            dt = abs(tb - ta)
            if dt <= best_dt and k not in used:
                best, best_dt = k, dt
        if best is not None:
            used.add(best)
            pairs.append((ta, fa, b[best][1]))
    return pairs


class TUMDataset:
    def __init__(self, root: str, max_dt: float = 0.02):
        self.root = root
        rgb = _read_index(os.path.join(root, "rgb.txt"))
        depth = _read_index(os.path.join(root, "depth.txt"))
        self.pairs = associate(rgb, depth, max_dt)
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth: Optional[np.ndarray] = None
        if os.path.exists(gt_path):
            from dynamic_visual_slam_tpu_torch.io.trajectory import read_tum
            stamps, txyz = read_tum(gt_path)
            self.groundtruth = np.concatenate([stamps[:, None], txyz], axis=1)

    def __len__(self) -> int:
        return len(self.pairs)

    def frames(self, limit: Optional[int] = None
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        """Yields (gray float32 [0,255], depth_m float32, timestamp)."""
        import cv2  # local import: optional dependency of the IO layer only
        n = len(self.pairs) if limit is None else min(limit, len(self.pairs))
        for ts, frgb, fdep in self.pairs[:n]:
            bgr = cv2.imread(os.path.join(self.root, frgb), cv2.IMREAD_COLOR)
            gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY).astype(np.float32)
            d16 = cv2.imread(os.path.join(self.root, fdep), cv2.IMREAD_UNCHANGED)
            depth = d16.astype(np.float32) * TUM_DEPTH_SCALE
            yield gray, depth, ts

    def gt_positions_at(self, stamps: np.ndarray) -> Optional[np.ndarray]:
        """Interpolated ground-truth positions at the given timestamps."""
        if self.groundtruth is None:
            return None
        g = self.groundtruth
        return np.stack([np.interp(stamps, g[:, 0], g[:, 1 + i])
                         for i in range(3)], axis=1)
