"""Synthetic RGB-D sequence generator with exact ground truth.

The reference has no test fixtures beyond a circles image
(test_dbow2_integration.cpp:14-17); trajectory validation was manual bag
playback.  This module gives the rebuild what SURVEY.md §4 calls
"deterministic synthetic-scene tests": a procedurally-textured multi-plane
world rendered by exact ray-plane intersection, so every frame comes with
perfect depth and ground-truth camera pose (→ exact ATE, reprojection
residuals, keyframe geometry).

Host-side numpy on purpose: this is the data source, not the compute path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from dynamic_visual_slam_tpu_torch.config import CameraConfig


def _rot_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


@dataclass
class SyntheticScene:
    """Fronto-parallel textured planes at staggered depths (world z),
    partitioned by world-x strips — non-planar overall, so neither the
    fundamental matrix nor DLT-PnP degenerates."""

    camera: CameraConfig
    seed: int = 0
    # stays inside the reference's 0.3-3.0 m depth-validity window for the
    # trajectories below (frontend.cpp:241-242)
    plane_depths: Tuple[float, ...] = (1.7, 2.3, 2.9)
    strip_edges: Tuple[float, ...] = (-0.6, 0.6)   # world-x boundaries
    texture_px_per_m: float = 220.0
    texture_extent_m: float = 14.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = int(self.texture_extent_m * self.texture_px_per_m)
        # multi-scale value noise → corner-rich, locally distinctive texture
        tex = rng.uniform(0, 52, (n, n)).astype(np.float32)
        for scale, amp in ((11, 55.0), (31, 70.0), (101, 45.0)):
            coarse = rng.uniform(0, 1, (n // scale + 2, n // scale + 2))
            ups = np.kron(coarse, np.ones((scale, scale)))[:n, :n]
            tex += (ups * amp).astype(np.float32)
        # sharp-edged random squares (strong FAST corners)
        for _ in range(n * n // 4000):
            y, x = rng.integers(0, n - 40, 2)
            s = int(rng.integers(6, 36))
            tex[y:y + s, x:x + s] += float(rng.uniform(-70, 90))
        self._tex = np.clip(tex, 0, 255)
        self._n = n

    def _sample_texture(self, x_m: np.ndarray, y_m: np.ndarray,
                        plane_id: np.ndarray) -> np.ndarray:
        """World (x, y) metres → texture intensity (bilinear, plane-offset so
        each plane has distinct content)."""
        half = self.texture_extent_m / 2
        u = (x_m + half) * self.texture_px_per_m + plane_id * 977.0
        v = (y_m + half) * self.texture_px_per_m + plane_id * 1409.0
        u = np.mod(u, self._n - 1)
        v = np.mod(v, self._n - 1)
        u0 = u.astype(np.int64)
        v0 = v.astype(np.int64)
        fu, fv = u - u0, v - v0
        t = self._tex
        return (t[v0, u0] * (1 - fu) * (1 - fv) + t[v0, u0 + 1] * fu * (1 - fv)
                + t[v0 + 1, u0] * (1 - fu) * fv + t[v0 + 1, u0 + 1] * fu * fv)

    def _strip_id(self, x_w: np.ndarray) -> np.ndarray:
        sid = np.zeros(x_w.shape, np.int64)
        for e in self.strip_edges:
            sid += (x_w >= e).astype(np.int64)
        return sid

    def render(self, r_wc: np.ndarray, t_wc: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Camera-to-world pose (optical frame: z forward) → (gray, depth_m),
        both (H, W) float32; gray quantized to uint8 levels."""
        c = self.camera
        us, vs = np.meshgrid(np.arange(c.width), np.arange(c.height))
        d = np.stack([(us - c.cx) / c.fx, (vs - c.cy) / c.fy,
                      np.ones_like(us, np.float64)], -1)      # (H,W,3) ray, z=1
        dw = d @ r_wc.T                                        # world ray dirs
        best_s = np.full((c.height, c.width), np.inf)
        best_gray = np.zeros((c.height, c.width), np.float32)
        for pid, z_pl in enumerate(self.plane_depths):
            dz = dw[..., 2]
            s = np.where(np.abs(dz) > 1e-9, (z_pl - t_wc[2]) / dz, np.inf)
            px = t_wc[0] + s * dw[..., 0]
            py = t_wc[1] + s * dw[..., 1]
            valid = (s > 0.05) & (self._strip_id(px) == pid) & (s < best_s)
            gray = self._sample_texture(px, py, np.full_like(px, pid))
            best_gray = np.where(valid, gray, best_gray)
            best_s = np.where(valid, s, best_s)
        depth = np.where(np.isfinite(best_s), best_s, 0.0).astype(np.float32)
        return np.round(best_gray).astype(np.float32), depth


def orbit_trajectory(n_frames: int, step_t: float = 0.012,
                     step_r: float = 0.004, seed: int = 1
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Smooth wandering camera: small per-frame rotations + translations,
    staying near the origin looking at +z.  Returns [(R_wc, t_wc)]."""
    rng = np.random.default_rng(seed)
    poses = []
    r = np.eye(3)
    t = np.zeros(3)
    vel = rng.normal(size=3) * step_t
    rvel = rng.normal(size=3) * step_r
    for _ in range(n_frames):
        poses.append((r.copy(), t.copy()))
        vel = 0.92 * vel + rng.normal(size=3) * step_t * 0.4
        rvel = 0.92 * rvel + rng.normal(size=3) * step_r * 0.4
        t = t + r @ vel
        r = r @ _rot_xyz(*rvel)
        # soft-limit drift so planes stay in view and inside the depth gate
        t = np.clip(t, [-0.8, -0.6, -0.05], [0.8, 0.6, 0.9])
    return poses


def generate_sequence(camera: CameraConfig, n_frames: int, seed: int = 0,
                      depth_noise: float = 0.0, **traj_kw
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                          np.ndarray, float]]:
    """Yields (gray, depth_m, R_wc_gt, t_wc_gt, timestamp) per frame at 30 Hz."""
    scene = SyntheticScene(camera, seed=seed)
    rng = np.random.default_rng(seed + 7)
    for i, (r, t) in enumerate(orbit_trajectory(n_frames, seed=seed + 1, **traj_kw)):
        gray, depth = scene.render(r, t)
        if depth_noise > 0:
            depth = depth * (1.0 + rng.normal(size=depth.shape) * depth_noise
                             ).astype(np.float32)
        yield gray, depth, r, t, i / 30.0
