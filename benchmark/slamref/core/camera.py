"""Pinhole camera model — batched project / back-project.

- back-projection ``pt3d = ((u-cx)·d/fx, (v-cy)·d/fy, d)``;
- projection ``u = fx·X/Z + cx, v = fy·Y/Z + cy`` with camera-frame point
  ``X_c = Rᵀ(X_w − t)`` for a camera-to-world pose.

Intrinsics are Python floats: they come from the frozen config, and scalar
arithmetic with a float32 tensor stays in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slamref.config import CameraConfig
from slamref.core import lie


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_config(cls, c: CameraConfig) -> "Intrinsics":
        return cls(float(c.fx), float(c.fy), float(c.cx), float(c.cy))

    def matrix(self, device=None) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=device)


def backproject(k: Intrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) + depth (...,) → camera-frame points (...,3)."""
    x = (uv[..., 0] - k.cx) * depth / k.fx
    y = (uv[..., 1] - k.cy) * depth / k.fy
    return torch.stack([x, y, depth], dim=-1)


def project(k: Intrinsics, xyz: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Camera-frame points (...,3) → pixels (...,2). Caller masks Z<=0."""
    z = torch.where(torch.abs(xyz[..., 2]) < eps, eps, xyz[..., 2])
    u = k.fx * xyz[..., 0] / z + k.cx
    v = k.fy * xyz[..., 1] / z + k.cy
    return torch.stack([u, v], dim=-1)


def world_to_camera(q_wc, t_wc, xyz_w) -> torch.Tensor:
    """Camera-to-world pose (q,t) ⇒ X_c = Rᵀ(X_w − t)."""
    return lie.quat_rotate(lie.quat_conj(q_wc), xyz_w - t_wc)


def camera_to_world(q_wc, t_wc, xyz_c) -> torch.Tensor:
    """X_w = R X_c + t."""
    return lie.quat_rotate(q_wc, xyz_c) + t_wc


def reproject_world(k: Intrinsics, q_wc, t_wc, xyz_w) -> torch.Tensor:
    return project(k, world_to_camera(q_wc, t_wc, xyz_w))


def in_bounds(uv: torch.Tensor, width: int, height: int, margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= margin) & (uv[..., 0] <= width - 1 - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] <= height - 1 - margin))
