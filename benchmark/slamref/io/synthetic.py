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

from slamref.config import CameraConfig


def _rot_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


@dataclass
class MovingObject:
    """A fronto-parallel textured rectangle crossing the static world — the
    synthetic 'person'.  The reference's entire semantic stage exists to keep
    such objects out of the map (backend.cpp:746-751, 1011-1029); this gives
    the rebuild a dynamic fixture with exact ground-truth bboxes, so the
    culling path can be proven end-to-end without pretrained YOLO weights.

    The rectangle lives on the plane world-z = `z` (in front of the static
    planes, so it occludes them), is corner-rich (same multi-scale texture as
    the walls, offset to distinct content), and translates at `velocity` m/s
    in world x/y.

    Harder-dynamics knobs (real people don't translate at constant depth,
    backend.cpp:746-751's whole reason to exist):
    - `vz`: world-z velocity — an approaching/receding walker whose image
      footprint CHANGES SCALE over the run (negative = toward the camera);
    - `stop_go`: (period_s, duty) — the walker moves only during the first
      `duty` fraction of every period, freezing in between (a stationary
      'dynamic' object is the classic culling blind spot: zero flow, but it
      will move again and poison any landmark triangulated on it);
    - mutual occlusion needs no knob: objects render depth-sorted, so two
      walkers on crossing paths at different z occlude each other exactly.
    """

    z: float = 1.2                       # inside the 0.3–3.0 m depth gate
    center0: Tuple[float, float] = (-0.75, 0.05)   # world (x, y) at t=0
    velocity: Tuple[float, float] = (0.35, 0.0)    # m/s
    half_size: Tuple[float, float] = (0.16, 0.30)  # metres (person-shaped)
    tex_id: int = 11                     # texture-content offset
    vz: float = 0.0                      # m/s along world z
    stop_go: Tuple[float, float] = None  # (period_s, duty in (0, 1])

    def travel_time(self, t_s: float) -> float:
        """Effective motion time: identity without stop_go; with it, the
        piecewise-linear time warp that freezes the object outside the
        'go' window of each period."""
        if self.stop_go is None:
            return t_s
        period, duty = self.stop_go
        go = period * duty
        return float(np.floor(t_s / period) * go + min(t_s % period, go))

    def center(self, t_s: float) -> np.ndarray:
        tau = self.travel_time(t_s)
        return np.asarray(self.center0) + np.asarray(self.velocity) * tau

    def z_at(self, t_s: float) -> float:
        return self.z + self.vz * self.travel_time(t_s)


@dataclass
class SyntheticScene:
    """Fronto-parallel textured planes at staggered depths (world z),
    partitioned by world-x strips — non-planar overall, so neither the
    fundamental matrix nor DLT-PnP degenerates.  Optional `objects` are
    moving textured rectangles rendered with correct occlusion (their depth
    wins where closer) — see MovingObject."""

    camera: CameraConfig
    seed: int = 0
    # stays inside the reference's 0.3-3.0 m depth-validity window for the
    # trajectories below (frontend.cpp:241-242)
    plane_depths: Tuple[float, ...] = (1.7, 2.3, 2.9)
    strip_edges: Tuple[float, ...] = (-0.6, 0.6)   # world-x boundaries
    texture_px_per_m: float = 220.0
    texture_extent_m: float = 14.0
    objects: Tuple[MovingObject, ...] = ()

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

    def render(self, r_wc: np.ndarray, t_wc: np.ndarray, t_s: float = 0.0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Camera-to-world pose (optical frame: z forward) → (gray, depth_m),
        both (H, W) float32; gray quantized to uint8 levels.  `t_s` drives
        the moving objects (ignored when the scene has none)."""
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
        for obj in self.objects:
            cx_o, cy_o = obj.center(t_s)
            z_o = obj.z_at(t_s)
            dz = dw[..., 2]
            s = np.where(np.abs(dz) > 1e-9, (z_o - t_wc[2]) / dz, np.inf)
            px = t_wc[0] + s * dw[..., 0]
            py = t_wc[1] + s * dw[..., 1]
            hit = ((s > 0.05) & (np.abs(px - cx_o) <= obj.half_size[0])
                   & (np.abs(py - cy_o) <= obj.half_size[1]) & (s < best_s))
            # texture in OBJECT-local coords: the pattern rides along with
            # the walker, so its ORB features track the object, not the world
            gray = self._sample_texture(px - cx_o, py - cy_o,
                                        np.full_like(px, 20 + obj.tex_id))
            best_gray = np.where(hit, gray, best_gray)
            best_s = np.where(hit, s, best_s)
        depth = np.where(np.isfinite(best_s), best_s, 0.0).astype(np.float32)
        return np.round(best_gray).astype(np.float32), depth

    def object_bboxes(self, r_wc: np.ndarray, t_wc: np.ndarray, t_s: float,
                      margin_px: float = 3.0) -> np.ndarray:
        """Exact ground-truth image bboxes of the moving objects at time
        `t_s` for the given camera pose → (K, 4) float32 [x1,y1,x2,y2],
        visible objects only.  (A planar convex rectangle projects to a
        convex quad, so the bbox of the projected corners is exact.)"""
        c = self.camera
        r_cw = r_wc.T
        out = []
        for obj in self.objects:
            cx_o, cy_o = obj.center(t_s)
            z_o = obj.z_at(t_s)
            hx, hy = obj.half_size
            corners = np.array([[cx_o - hx, cy_o - hy, z_o],
                                [cx_o + hx, cy_o - hy, z_o],
                                [cx_o - hx, cy_o + hy, z_o],
                                [cx_o + hx, cy_o + hy, z_o]])
            xc = (corners - t_wc) @ r_cw.T
            if np.any(xc[:, 2] <= 0.05):
                continue
            u = c.fx * xc[:, 0] / xc[:, 2] + c.cx
            v = c.fy * xc[:, 1] / xc[:, 2] + c.cy
            x1 = max(u.min() - margin_px, 0.0)
            y1 = max(v.min() - margin_px, 0.0)
            x2 = min(u.max() + margin_px, c.width - 1.0)
            y2 = min(v.max() + margin_px, c.height - 1.0)
            if x2 - x1 > 2.0 and y2 - y1 > 2.0:
                out.append([x1, y1, x2, y2])
        return (np.asarray(out, np.float32) if out
                else np.zeros((0, 4), np.float32))


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


def default_walkers(n_frames: int, n: int = 2) -> Tuple[MovingObject, ...]:
    """Walkers sized/paced for the realistic poisoning regime: image flow
    from object motion ≈ 1–2 px/frame at the default intrinsics — INSIDE
    the tracker's RANSAC gates (2 px F / 4 px PnP), so without semantic
    culling their coherent rigid motion contaminates the pose refinement
    every frame instead of being rejected as outliers.  Faster objects are
    trivially rejected as epipolar outliers; these are the hard case."""
    objs = []
    for i in range(n):
        objs.append(MovingObject(
            z=1.1 + 0.25 * i,
            center0=(-0.55 + 0.45 * i, 0.05 - 0.12 * i),
            velocity=(0.2 * (1 if i % 2 == 0 else -1),
                      0.015 * (1 if i % 2 == 0 else -1)),
            half_size=(0.26 - 0.05 * i, 0.42 - 0.06 * i),
            tex_id=11 + 3 * i))
    return tuple(objs)


def hard_walkers(n_frames: int) -> Tuple[MovingObject, ...]:
    """Out-of-distribution walker set (VERDICT r3 weak #6 / next #6): the
    behaviors real people exhibit that the constant-z training family
    (default_walkers / semantic.train's randomized variants) deliberately
    does NOT cover —

    - walker 0 APPROACHES the camera (vz < 0): its image footprint grows
      ~2x over the run (scale change, the classic detector OOD axis);
    - walker 1 runs STOP-AND-GO (1.6 s period, 50 % duty): repeated
      zero-flow stretches where motion gating would pass it as static;
    - walkers 1 and 2 cross paths at different z: MUTUAL OCCLUSION — the
      nearer one periodically erases the farther one's features.

    Speeds stay in the 1-2 px/frame poisoning regime (default_walkers
    docstring) so culling, not RANSAC, must do the protecting."""
    return (
        MovingObject(z=2.1, vz=-0.12, center0=(-0.35, 0.0),
                     velocity=(0.12, 0.01), half_size=(0.20, 0.34),
                     tex_id=11),
        MovingObject(z=1.35, center0=(0.55, -0.05),
                     velocity=(-0.22, 0.015), stop_go=(1.6, 0.5),
                     half_size=(0.24, 0.40), tex_id=14),
        MovingObject(z=1.05, center0=(-0.55, 0.10),
                     velocity=(0.18, -0.012), half_size=(0.18, 0.32),
                     tex_id=17),
    )


def loop_trajectory(n_frames: int, radius: float = 0.35
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Closed orbit that returns to the start: one smooth x/z ellipse with
    a small vertical bob, identity orientation, so the last frames see the
    view of frame 0 (the revisit fixture for loop closure)."""
    poses = []
    for i in range(n_frames):
        th = 2.0 * np.pi * i / max(n_frames - 1, 1)
        t = np.array([radius * np.sin(th),
                      0.05 * np.sin(2.0 * th),
                      0.12 * (1.0 - np.cos(th))])
        poses.append((np.eye(3), t))
    return poses


def walker_swept_hits(xyz: np.ndarray, objects: Tuple[MovingObject, ...],
                      duration_s: float) -> np.ndarray:
    """(L,3) world points → bool mask of points inside any walker's swept
    slab (|z - obj.z| small, x/y within the band the object covered during
    [0, duration_s]).  The map-contamination oracle for dynamic-robustness
    tests: a landmark inside this volume was triangulated ON a moving
    object — exactly what the reference's semantic culling exists to
    prevent (backend.cpp:746-751)."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    hit = np.zeros(len(xyz), bool)
    # TIME-SAMPLED union of the walker's instantaneous boxes, not the
    # bounding box of its whole excursion: a z-moving walker's excursion
    # box is the (x-band × z-range) PRODUCT, which contains x/z
    # combinations the walker never occupied — for hard_walkers'
    # approaching walker that product overlaps a static wall plane and
    # falsely flags genuine wall landmarks. The union tube is exact for
    # constant-z walkers (reduces to the old slab) and tight otherwise.
    ts = np.arange(0.0, duration_s + 1e-6, 0.1)
    for o in objects:
        cs = np.stack([o.center(t) for t in ts])            # (T, 2)
        zs = np.asarray([o.z_at(t) for t in ts])            # (T,)
        inx = np.abs(xyz[:, None, 0] - cs[None, :, 0]) <= o.half_size[0]
        iny = np.abs(xyz[:, None, 1] - cs[None, :, 1]) <= o.half_size[1]
        inz = np.abs(xyz[:, None, 2] - zs[None, :]) < 0.08
        hit |= np.any(inx & iny & inz, axis=1)
    return hit


def generate_dynamic_sequence(
        camera: CameraConfig, n_frames: int, seed: int = 0,
        objects: Tuple[MovingObject, ...] = None, depth_noise: float = 0.0,
        **traj_kw
        ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            float, np.ndarray]]:
    """Dynamic-scene variant: yields (gray, depth_m, R_wc_gt, t_wc_gt,
    timestamp, gt_bboxes (K,4)) per frame at 30 Hz.  The bboxes are the
    exact image-space bounds of the moving objects — a ground-truth stand-in
    for the reference's /yolo/tracking stream (backend.cpp:183-190), so the
    semantic culling path can be validated without pretrained weights."""
    if objects is None:
        objects = default_walkers(n_frames)
    scene = SyntheticScene(camera, seed=seed, objects=objects)
    rng = np.random.default_rng(seed + 7)
    for i, (r, t) in enumerate(orbit_trajectory(n_frames, seed=seed + 1,
                                                **traj_kw)):
        ts = i / 30.0
        gray, depth = scene.render(r, t, t_s=ts)
        if depth_noise > 0:
            depth = depth * (1.0 + rng.normal(size=depth.shape) * depth_noise
                             ).astype(np.float32)
        yield gray, depth, r, t, ts, scene.object_bboxes(r, t, ts)
