"""CPU oracle SLAM pipeline — the reference algorithm on the reference's
own libraries (OpenCV ORB/BFMatcher/solvePnPRansac + the f64 scipy BA of
`oracle/ba_cpu`), used as the trajectory-parity baseline for BASELINE
configs 1-2 (bag playback, the reference's launch/bag_playback.launch.xml,
README.md:143-153).

Faithful to the reference frontend per stage:
- cv2.ORB_create(1000, 1.2, 8, fastThreshold=20)     (frontend.cpp:205-211)
- depth validity 0.3-3.0 m                           (frontend.cpp:241-242,457-473)
- BFMatcher(NORM_HAMMING), distance < 50             (frontend.cpp:220,1123-1127)
- findFundamentalMat FM_RANSAC 2.0 px / 0.99         (frontend.cpp:1146-1147)
- back-project prev depth -> solvePnPRansac
  (100 iters, 4.0 px, conf 0.99)                     (frontend.cpp:843-948)
- motion gate 0.5 m / 0.2 rad                        (frontend.cpp:549-570)
- T_wc accumulation + keyframe policy
  (<150 matches to last KF or 30 frames)             (frontend.cpp:601-662,947-948)
- optional sliding-window BA (f64 TRF oracle) every
  period_s over the last window_size keyframes       (backend.cpp:874-990)

Validation-only: numpy/OpenCV/scipy, never on the device path. A copy of
the reference package's `oracle/pipeline_cpu.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from dynamic_visual_slam_tpu_torch.config import SLAMConfig


@dataclass
class OracleFrame:
    timestamp: float
    r_wc: np.ndarray
    t_wc: np.ndarray
    tracking_ok: bool
    is_keyframe: bool
    n_inliers: int


@dataclass
class OracleSLAM:
    config: SLAMConfig
    run_ba: bool = True

    def __post_init__(self):
        import cv2
        cfg = self.config
        o = cfg.orb
        self._orb = cv2.ORB_create(
            nfeatures=o.n_features, scaleFactor=o.scale_factor,
            nlevels=o.n_levels, fastThreshold=o.ini_th_fast)
        self._bf = cv2.BFMatcher(cv2.NORM_HAMMING)
        self._k = np.array([[cfg.camera.fx, 0, cfg.camera.cx],
                            [0, cfg.camera.fy, cfg.camera.cy],
                            [0, 0, 1]], np.float64)
        self._r_wc = np.eye(3)
        self._t_wc = np.zeros(3)
        self._prev = None            # (kps, desc, depth_at_kp)
        self._kf_desc = None
        self._frames_since_kf = 0
        self._has_kf = False
        self.trajectory: List[OracleFrame] = []
        # keyframe store for BA: list of dicts
        self.keyframes: List[Dict] = []
        self._last_ba_t: Optional[float] = None
        self._t0: Optional[float] = None
        self.ba_rounds = 0
        # frames whose F estimate raised in OpenCV (taken as no inliers)
        self.fm_errors = 0

    # ------------------------------------------------------------------
    def process(self, gray: np.ndarray, depth_m: np.ndarray,
                timestamp: float) -> OracleFrame:
        import cv2
        cfg = self.config
        if self._t0 is None:
            self._t0 = timestamp
        g8 = np.asarray(gray, np.float32).clip(0, 255).astype(np.uint8)
        kps, desc = self._orb.detectAndCompute(g8, None)
        ok_frame = True
        n_inl = 0
        is_kf = False
        if kps:
            uv = np.asarray([k.pt for k in kps], np.float32)
            xi = np.clip(np.round(uv[:, 0]).astype(int), 0,
                         depth_m.shape[1] - 1)
            yi = np.clip(np.round(uv[:, 1]).astype(int), 0,
                         depth_m.shape[0] - 1)
            z = np.asarray(depth_m, np.float32)[yi, xi]
            keep = (z > cfg.depth.min_depth) & (z < cfg.depth.max_depth)
            kps = [k for k, m in zip(kps, keep) if m]
            uv, z = uv[keep], z[keep]
            desc = desc[keep]
        else:
            desc = None

        if desc is None or len(desc) == 0:
            # tracking reset (frontend.cpp:1107-1117)
            self._prev = None
            fr = OracleFrame(timestamp, self._r_wc.copy(), self._t_wc.copy(),
                             False, False, 0)
            self.trajectory.append(fr)
            return fr

        if self._prev is not None:
            p_uv, p_desc, p_z = self._prev
            matches = self._bf.match(desc, p_desc)
            matches = [m for m in matches
                       if m.distance < cfg.match.max_hamming]
            accept = False
            if len(matches) >= 8:
                cur = np.asarray([uv[m.queryIdx] for m in matches],
                                 np.float32)
                prv = np.asarray([p_uv[m.trainIdx] for m in matches],
                                 np.float32)
                try:
                    _, inl = cv2.findFundamentalMat(
                        prv, cur, cv2.FM_RANSAC,
                        cfg.ransac.fm_threshold_px, 0.99)
                except cv2.error:
                    # OpenCV 4.13's RANSAC fails an internal assertion on
                    # some inputs that other versions estimate; a failed
                    # estimate is one with no inliers, as when F is None
                    inl = None
                    self.fm_errors += 1
                inl = (inl.ravel() > 0) if inl is not None else \
                    np.zeros(len(matches), bool)
                n_inl = int(inl.sum())
                zp = np.asarray([p_z[m.trainIdx] for m in matches])
                pnp_ok = inl & (zp > cfg.depth.min_depth) & \
                    (zp <= cfg.depth.max_depth)
                if pnp_ok.sum() >= cfg.ransac.min_pnp_matches:
                    fx, fy = self._k[0, 0], self._k[1, 1]
                    cx, cy = self._k[0, 2], self._k[1, 2]
                    zs = zp[pnp_ok]
                    xyz_prev = np.stack([
                        (prv[pnp_ok, 0] - cx) * zs / fx,
                        (prv[pnp_ok, 1] - cy) * zs / fy, zs], -1)
                    ok, rvec, tvec, _ = cv2.solvePnPRansac(
                        xyz_prev.astype(np.float64),
                        cur[pnp_ok].astype(np.float64), self._k, None,
                        iterationsCount=cfg.ransac.pnp_iterations,
                        reprojectionError=cfg.ransac.pnp_threshold_px,
                        confidence=0.99)
                    if ok:
                        r_rel, _ = cv2.Rodrigues(rvec)
                        # invert: pose of current camera in prev frame
                        # (frontend.cpp:930-938)
                        r_inv = r_rel.T
                        t_inv = -r_rel.T @ tvec.ravel()
                        rv_n = float(np.linalg.norm(rvec))
                        if (np.linalg.norm(t_inv) <=
                                cfg.motion.max_translation_m and
                                rv_n <= cfg.motion.max_rotation_rad):
                            self._t_wc = self._r_wc @ t_inv + self._t_wc
                            self._r_wc = self._r_wc @ r_inv
                            accept = True
            ok_frame = accept
            # keyframe policy (frontend.cpp:601-662)
            n_kf_matches = 0
            if self._has_kf and self._kf_desc is not None:
                kfm = self._bf.match(desc, self._kf_desc)
                n_kf_matches = sum(1 for m in kfm
                                   if m.distance < cfg.match.max_hamming)
            is_kf = ((not self._has_kf)
                     or n_kf_matches < cfg.keyframe.min_matches_to_last_kf
                     or self._frames_since_kf >=
                     cfg.keyframe.max_frames_between_kf)
            is_kf = is_kf and accept
        else:
            is_kf = True   # first-frame keyframe (frontend.cpp:1277-1316)

        if is_kf:
            self._kf_desc = desc
            self._has_kf = True
            self._frames_since_kf = 0
            self._store_keyframe(uv, z, desc, timestamp)
        else:
            self._frames_since_kf += 1

        self._prev = (uv, desc, z)
        fr = OracleFrame(timestamp, self._r_wc.copy(), self._t_wc.copy(),
                         ok_frame, is_kf, n_inl)
        self.trajectory.append(fr)
        if self.run_ba:
            self._maybe_ba(timestamp)
        return fr

    # ------------------------------------------------------------------
    def _store_keyframe(self, uv, z, desc, timestamp):
        fx, fy = self._k[0, 0], self._k[1, 1]
        cx, cy = self._k[0, 2], self._k[1, 2]
        xyz_c = np.stack([(uv[:, 0] - cx) * z / fx,
                          (uv[:, 1] - cy) * z / fy, z], -1)
        xyz_w = xyz_c @ self._r_wc.T + self._t_wc
        self.keyframes.append(dict(
            timestamp=timestamp, r_wc=self._r_wc.copy(),
            t_wc=self._t_wc.copy(), uv=uv.copy(), desc=desc.copy(),
            xyz_w=xyz_w))

    def _maybe_ba(self, timestamp: float) -> None:
        """Sliding-window BA over the last window_size keyframes with
        landmarks built by descriptor association across the window
        (backend.cpp:874-990 made minimal: frontier-triangulated points,
        f64 TRF solve, write poses back)."""
        cfg = self.config
        ts_rel = timestamp - self._t0
        if self._last_ba_t is None:
            self._last_ba_t = ts_rel
        if ts_rel - self._last_ba_t < cfg.ba.period_s or \
                len(self.keyframes) < 2:
            return
        self._last_ba_t = ts_rel
        from dynamic_visual_slam_tpu_torch.io.trajectory import quat_from_mat
        from dynamic_visual_slam_tpu_torch.oracle import ba_cpu
        win = self.keyframes[-min(cfg.ba.window_size, len(self.keyframes)):]
        w = len(win)
        # associate features of each window KF to the FIRST KF's by
        # descriptor (one landmark per first-KF feature)
        base = win[0]
        l_n = len(base["uv"])
        uv_grid = np.zeros((l_n, w, 2))
        valid = np.zeros((l_n, w), bool)
        uv_grid[:, 0] = base["uv"]
        valid[:, 0] = True
        import cv2
        bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        for j, kf in enumerate(win[1:], start=1):
            # association gate: Hamming < 50 AND reprojection < 5 px
            # (associateObservation, backend.cpp:1064-1120)
            xc = (base["xyz_w"] - kf["t_wc"]) @ kf["r_wc"]
            zs = np.where(np.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
            u = self._k[0, 0] * xc[:, 0] / zs + self._k[0, 2]
            v = self._k[1, 1] * xc[:, 1] / zs + self._k[1, 2]
            for m in bf.match(base["desc"], kf["desc"]):
                if m.distance >= cfg.match.max_hamming:
                    continue
                du = u[m.queryIdx] - kf["uv"][m.trainIdx, 0]
                dv = v[m.queryIdx] - kf["uv"][m.trainIdx, 1]
                if xc[m.queryIdx, 2] > 0.1 and \
                        du * du + dv * dv < \
                        cfg.association.max_reprojection_px ** 2:
                    uv_grid[m.queryIdx, j] = kf["uv"][m.trainIdx]
                    valid[m.queryIdx, j] = True
        seen = valid.sum(1) >= 2
        if seen.sum() < 8:
            return
        # quat_from_mat is TUM xyzw order; ba_cpu speaks the package's wxyz
        q_wc = np.stack([np.roll(quat_from_mat(k["r_wc"]), 1) for k in win])
        t_wc = np.stack([k["t_wc"] for k in win])
        res = ba_cpu.solve(
            q_wc, t_wc, base["xyz_w"][seen], uv_grid[seen], valid[seen],
            self._k[0, 0], self._k[1, 1], self._k[0, 2], self._k[1, 2],
            sigma=cfg.ba.sigma_px, huber_delta=cfg.ba.huber_delta,
            irls_iters=4, xtol=1e-10, strict=False)
        if not res.ok:
            # failed solve: discard, like the reference's CONVERGENCE gate
            # (backend.cpp:974-978)
            return
        self.ba_rounds += 1
        # write back optimized keyframe poses (backend.cpp:1356-1392)
        from scipy.spatial.transform import Rotation
        for kf, q, t in zip(win, res.q_wc, res.t_wc):
            kf["r_wc"] = Rotation.from_quat(np.roll(q, -1)).as_matrix()
            kf["t_wc"] = np.asarray(t)

    # ------------------------------------------------------------------
    def frontend_trajectory(self) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        stamps = np.asarray([f.timestamp for f in self.trajectory])
        rs = np.stack([f.r_wc for f in self.trajectory])
        ts = np.stack([f.t_wc for f in self.trajectory])
        return stamps, rs, ts

    def keyframe_trajectory(self) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        stamps = np.asarray([k["timestamp"] for k in self.keyframes])
        rs = np.stack([k["r_wc"] for k in self.keyframes])
        ts = np.stack([k["t_wc"] for k in self.keyframes])
        return stamps, rs, ts
