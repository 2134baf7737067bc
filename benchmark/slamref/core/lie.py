"""SO(3)/SE(3) primitives on quaternions — batched torch.

Conventions (same as the reference package's ``core/lie.py``):

- quaternions are ``[w, x, y, z]`` tensors, unit norm, Hamilton convention;
- a pose ``(q, t)`` denotes the rigid map ``X ↦ R(q) X + t``;
- camera-to-world ("T_wc") stores the camera pose in world coordinates, so
  ``X_world = R X_cam + t``; world-to-camera is its inverse.

Every function is shape-polymorphic over leading batch dims and runs on the
device of its inputs.
"""

from __future__ import annotations

import torch


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(1, 4, dtype=dtype, device=device)[0]


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=eps)
    # canonicalize sign (w >= 0) so parity checks are stable
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product along the last dim."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w, xyz = q[..., :1], q[..., 1:]
    t = 2.0 * cross(xyz, v)
    return v + w * t + cross(xyz, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(...,4) → (...,3,3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(...,3,3) → (...,4) wxyz.  Branch-free Shepperd via 4-candidate select."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (...,4cand,4)
    q = torch.gather(cand, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle (...,3) → quaternion (...,4)."""
    theta = torch.linalg.vector_norm(phi, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-8
    k = torch.where(small, 0.5 - theta * theta / 48.0,
                    torch.sin(half) / torch.clamp(theta, min=1e-20))
    w = torch.cos(half)
    return quat_normalize(torch.cat([w, k * phi], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (...,4) → axis-angle (...,3)."""
    q = quat_normalize(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-8
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-20),
                    theta / torch.clamp(vn, min=1e-20))
    return k * v


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (...,3) → rotation matrix (...,3,3)."""
    return quat_to_mat(so3_exp(rvec))


def se3_inverse(q: torch.Tensor, t: torch.Tensor):
    """Invert (q,t): X↦RX+t  ⇒  X↦Rᵀ(X−t)."""
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_compose(qa, ta, qb, tb):
    """(qa,ta)∘(qb,tb): first apply b, then a."""
    return quat_normalize(quat_mul(qa, qb)), quat_rotate(qa, tb) + ta


def se3_apply(q, t, x):
    return quat_rotate(q, x) + t


# Optical↔ROS basis change (frontend.cpp:393-397, backend.cpp:1441-1445).
# C maps camera-optical axes (z fwd, x right, y down) to ROS body axes
# (x fwd, y left, z up):  T_ros = C · R_optical · Cᵀ.
OPTICAL_TO_ROS = ((0.0, 0.0, 1.0),
                  (-1.0, 0.0, 0.0),
                  (0.0, -1.0, 0.0))


def _optical_to_ros(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(OPTICAL_TO_ROS, dtype=like.dtype, device=like.device)


def optical_to_ros_rotation(r_opt: torch.Tensor) -> torch.Tensor:
    c = _optical_to_ros(r_opt)
    return c @ r_opt @ c.T


def optical_to_ros_point(p_opt: torch.Tensor) -> torch.Tensor:
    return p_opt @ _optical_to_ros(p_opt).T


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (...,3,3) — no LU, no host sync."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))
