"""SE(3) Lie-group operations on batched tensors.

Counterpart of ``orbslam2_tpu/geometry/se3.py``. Poses are homogeneous
``[..., 4, 4]`` float32 matrices ``T = [[R, t], [0, 1]]`` mapping world
points into the frame (Tcw). Tangent vectors are ``[..., 6]`` with
translation first: ``xi = (rho, phi)``, ``exp(xi) = [[exp(phi^), V(phi) rho],
[0, 1]]``; updates are left-multiplicative.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector; batched over leading dims."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _so3_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) coefficients for Rodrigues / left-Jacobian with small-angle
    Taylor fallbacks."""
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - a) / theta_sq)
    return a, b, c


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    a, b, _ = _so3_coeffs(theta_sq)
    k = hat(phi)
    return _eye_like(k) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3]."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(cos_theta)
    w = torch.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    scale = torch.where(
        theta < 1e-4,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * sin_theta + _EPS),
    )
    generic = scale[..., None] * w
    # Near theta = pi the vee part vanishes; recover the axis from the
    # diagonal: axis_i^2 = (R_ii + 1) / 2, signs from the off-diagonal sums.
    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0)
    axis = torch.sqrt(axis_sq)
    sxy = r[..., 0, 1] + r[..., 1, 0]
    sxz = r[..., 0, 2] + r[..., 2, 0]
    syz = r[..., 1, 2] + r[..., 2, 1]
    big = torch.argmax(axis_sq, dim=-1)
    one = torch.ones_like(sxy)
    sgn_y = torch.where(big == 0, torch.sign(sxy + _EPS), one)
    sgn_z = torch.where(big == 0, torch.sign(sxz + _EPS),
                        torch.where(big == 1, torch.sign(syz + _EPS), one))
    sgn_x = torch.where(big == 1, torch.sign(sxy + _EPS),
                        torch.where(big == 2, torch.sign(sxz + _EPS), one))
    near_pi_axis = axis * torch.stack([sgn_x, sgn_y, sgn_z], dim=-1)
    near_pi = theta[..., None] * near_pi_axis
    return torch.where((math.pi - theta < 1e-3)[..., None], near_pi, generic)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: twist [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(phi * phi, dim=-1)
    a, b, c = _so3_coeffs(theta_sq)
    k = hat(phi)
    kk = k @ k
    eye = _eye_like(k)
    rot = eye + a[..., None, None] * k + b[..., None, None] * kk
    v = eye + b[..., None, None] * k + c[..., None, None] * kk
    t = torch.einsum("...ij,...j->...i", v, rho)
    return from_rt(rot, t)


def log(t_mat: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: [..., 4, 4] -> twist [..., 6] (rho, phi)."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    phi = so3_log(r)
    theta_sq = torch.sum(phi * phi, dim=-1)
    k = hat(phi)
    kk = k @ k
    # V^{-1} = I - 1/2 K + (1/theta^2)(1 - A/(2B)) K^2
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    half = torch.where(
        theta_sq < 1e-8,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - 0.5 * theta * torch.sin(theta)
         / (1.0 - torch.cos(theta) + _EPS)) / (theta_sq + _EPS),
    )
    v_inv = _eye_like(k) - 0.5 * k + half[..., None, None] * kk
    rho = torch.einsum("...ij,...j->...i", v_inv, t)
    return torch.cat([rho, phi], dim=-1)


def from_rt(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    out = torch.zeros(batch + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    # fill_, not `= 1.0`: a Python number assigned to a CUDA element goes
    # through a host tensor, which no CUDA graph capture may copy from
    out[..., 3, 3].fill_(1.0)
    return out


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (4, 4))


def inverse(t_mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse: [R^T, -R^T t]."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    rt = r.transpose(-1, -2)
    return from_rt(rt, -torch.einsum("...ij,...j->...i", rt, t))


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def apply(t_mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform points [..., 3] by pose(s) [..., 4, 4] (broadcasting)."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    return torch.einsum("...ij,...j->...i", r, points) + t


def rotation(t_mat: torch.Tensor) -> torch.Tensor:
    return t_mat[..., :3, :3]


def translation(t_mat: torch.Tensor) -> torch.Tensor:
    return t_mat[..., :3, 3]


def camera_center(tcw: torch.Tensor) -> torch.Tensor:
    """Camera center in world coords: Ow = -Rcw^T tcw."""
    r = tcw[..., :3, :3]
    t = tcw[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", r, t)


def retract(t_mat: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) * T."""
    return compose(exp(xi), t_mat)


def to_quaternion(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (x, y, z, w),
    TUM trajectory convention. Shepperd's branchless method."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate quaternions (unnormalized, wxyz), pick the best-scaled
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4 cand, 4 (wxyz)]
    gather_idx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, gather_idx)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([x, y, z, w], dim=-1)


def from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (x, y, z, w) -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / (n + _EPS), torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )
