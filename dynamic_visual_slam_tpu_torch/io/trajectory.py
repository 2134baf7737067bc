"""Absolute trajectory error, as the standard TUM RGB-D evaluation computes
it: rigid Umeyama/Horn alignment of the estimated positions onto the ground
truth, then the RMSE of the translational residuals."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
