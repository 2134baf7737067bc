"""Visualization exports — the reference's RViz surface (C9) as files.

Reference outputs: annotated feature image with green circles on inliers
(/feature_detector/features_image, frontend.cpp:1229-1232) and a landmark
sphere MarkerArray, cyan for observation_count > 1 else green, 5 mm spheres
(backend.cpp:1437-1510), in ROS axes via the optical→ROS basis change.

Here (a copy of the reference package's ``utils/viz.py``, numpy only):
numpy image annotation (PNG via cv2 when available) and PLY point-cloud
export with the same color policy, plus a trajectory PLY polyline.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


GREEN = (0, 255, 0)
CYAN = (0, 255, 255)
# camera-optical axes (z fwd, x right, y down) → ROS body axes (x fwd,
# y left, z up), the reference's core/lie.OPTICAL_TO_ROS
OPTICAL_TO_ROS = np.array([[0.0, 0.0, 1.0],
                           [-1.0, 0.0, 0.0],
                           [0.0, -1.0, 0.0]])


def annotate_features(gray: np.ndarray, uv: np.ndarray,
                      inlier_mask: Optional[np.ndarray] = None,
                      radius: int = 3) -> np.ndarray:
    """(H,W) gray + (N,2) keypoints → (H,W,3) uint8 BGR with green circles
    on inliers (all points when no mask), like the reference debug image."""
    img = np.stack([np.clip(gray, 0, 255).astype(np.uint8)] * 3, axis=-1)
    keep = np.ones(len(uv), bool) if inlier_mask is None else inlier_mask
    try:
        import cv2
        for (x, y), k in zip(np.asarray(uv), keep):
            if k:
                cv2.circle(img, (int(round(x)), int(round(y))), radius,
                           GREEN, 1)
    except ImportError:  # dependency-free fallback: plot single pixels
        for (x, y), k in zip(np.asarray(uv).astype(int), keep):
            if k and 0 <= y < img.shape[0] and 0 <= x < img.shape[1]:
                img[y, x] = GREEN[::-1]
    return img


def landmarks_to_ply(path: str, xyz: np.ndarray, n_obs: np.ndarray,
                     to_ros_axes: bool = True) -> None:
    """Landmark cloud → ASCII PLY; cyan for n_obs>1 else green
    (backend.cpp:1490-1501 color policy), optionally in ROS axes."""
    pts = np.asarray(xyz, np.float64)
    if to_ros_axes and len(pts):
        pts = pts @ OPTICAL_TO_ROS.T
    colors = np.where((np.asarray(n_obs) > 1)[:, None],
                      np.asarray([[0, 255, 255]]), np.asarray([[0, 255, 0]]))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, colors):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} "
                    f"{c[0]} {c[1]} {c[2]}\n")


def trajectory_to_ply(path: str, txyz: np.ndarray,
                      to_ros_axes: bool = True) -> None:
    """Camera path as a PLY polyline (the /backend/trajectory equivalent)."""
    pts = np.asarray(txyz, np.float64)
    if to_ros_axes and len(pts):
        pts = pts @ OPTICAL_TO_ROS.T
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {max(n - 1, 0)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        for i in range(n - 1):
            f.write(f"{i} {i + 1}\n")


def save_image(path: str, img: np.ndarray) -> bool:
    try:
        import cv2
        return bool(cv2.imwrite(path, img))
    except ImportError:
        return False
