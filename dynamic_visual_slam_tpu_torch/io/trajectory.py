"""TUM-format trajectory files and the absolute trajectory error, as the
standard TUM RGB-D evaluation computes it: rigid Umeyama/Horn alignment of
the estimated positions onto the ground truth, then the RMSE of the
translational residuals."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def quat_from_mat(r: np.ndarray) -> np.ndarray:
    """(3,3) → (qx, qy, qz, qw) — TUM file order."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        w = (r[2, 1] - r[1, 2]) / s
        x = 0.25 * s
        y = (r[0, 1] + r[1, 0]) / s
        z = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        w = (r[0, 2] - r[2, 0]) / s
        x = (r[0, 1] + r[1, 0]) / s
        y = 0.25 * s
        z = (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        w = (r[1, 0] - r[0, 1]) / s
        x = (r[0, 2] + r[2, 0]) / s
        y = (r[1, 2] + r[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def write_tum(path: str, stamps: Sequence[float], poses:
              Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
    """poses: [(R_wc (3,3), t_wc (3,))] → 'stamp tx ty tz qx qy qz qw' lines."""
    with open(path, "w") as f:
        for s, (r, t) in zip(stamps, poses):
            q = quat_from_mat(np.asarray(r))
            f.write(f"{s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def read_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """→ (stamps (N,), txyz (N,3)); quaternions ignored for ATE."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            rows.append(vals[:4])
    arr = np.asarray(rows)
    return arr[:, 0], arr[:, 1:4]


def umeyama_alignment(src: np.ndarray, dst: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares rigid transform aligning src (N,3) → dst (N,3).
    Returns (R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    u, _, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1
    r = u @ sgn @ vt
    return r, mu_d - r @ mu_s


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray) -> float:
    """Absolute trajectory error RMSE after rigid alignment (TUM ATE)."""
    est_t = np.asarray(est_t, np.float64)
    gt_t = np.asarray(gt_t, np.float64)
    r, t = umeyama_alignment(est_t, gt_t)
    est_t = est_t @ r.T + t
    return float(np.sqrt(np.mean(np.sum((est_t - gt_t) ** 2, axis=1))))


def rpe_rmse(est_t: np.ndarray, gt_t: np.ndarray, delta: int = 1) -> float:
    """Relative pose error (translation) RMSE over `delta`-frame intervals."""
    de = est_t[delta:] - est_t[:-delta]
    dg = gt_t[delta:] - gt_t[:-delta]
    return float(np.sqrt(np.mean(np.sum((de - dg) ** 2, axis=1))))
