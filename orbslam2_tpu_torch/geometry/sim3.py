"""Sim(3) similarity-transform operations on batched tensors.

Counterpart of ``orbslam2_tpu/geometry/sim3.py``. A similarity is a
``[..., 4, 4]`` matrix ``S = [[s R, t], [0, 1]]`` (scale folded into the
rotation block); tangent vectors are ``[..., 7]`` = ``(rho, phi, sigma)``
with ``s = exp(sigma)``. Used by loop closing (Sim3 RANSAC and its
optimisation) and the essential-graph optimizer.
"""
from __future__ import annotations

import torch

from orbslam2_tpu_torch.geometry import se3

_EPS = 1e-8


def from_srt(s: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return se3.from_rt(s[..., None, None] * r, t)


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def scale(s_mat: torch.Tensor) -> torch.Tensor:
    """|det(sR)|^(1/3) = s."""
    det = torch.clamp(_det3(s_mat[..., :3, :3]), min=_EPS)
    return torch.pow(det, 1.0 / 3.0)


def split(s_mat: torch.Tensor):
    """-> (s, R, t) with R orthonormal."""
    s = scale(s_mat)
    return s, s_mat[..., :3, :3] / s[..., None, None], s_mat[..., :3, 3]


def inverse(s_mat: torch.Tensor) -> torch.Tensor:
    """S^-1 = [[(1/s) R^T, -(1/s) R^T t], [0, 1]]."""
    s, r, t = split(s_mat)
    rt = r.transpose(-1, -2)
    inv_s = 1.0 / (s + _EPS)
    return from_srt(inv_s, rt, -inv_s[..., None] * (rt @ t[..., None])[..., 0])


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def apply(s_mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """p' = s R p + t; broadcasts [..., 4, 4] against [..., 3]."""
    return (s_mat[..., :3, :3] @ points[..., None])[..., 0] + s_mat[..., :3, 3]


def from_se3(t_mat: torch.Tensor, s=1.0) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=t_mat.dtype, device=t_mat.device)
    return from_srt(s.expand(t_mat.shape[:-2]), t_mat[..., :3, :3], t_mat[..., :3, 3])


def to_se3(s_mat: torch.Tensor) -> torch.Tensor:
    """SE3 with the translation de-scaled: [R, t/s] (how an optimized Sim3
    becomes a keyframe pose again)."""
    s, r, t = split(s_mat)
    return se3.from_rt(r, t / (s[..., None] + _EPS))


def _w_matrix(phi: torch.Tensor, sigma: torch.Tensor, s: torch.Tensor):
    """-> W with t = W rho (Strasdat's thesis). Theta and sigma are
    clamped away from zero; the error that leaves near the singular points
    is O(clamp^2) ~ 1e-8, below float32 resolution."""
    k = se3.hat(phi)
    theta = torch.clamp(torch.sqrt(torch.sum(phi * phi, dim=-1) + _EPS * _EPS), min=1e-4)
    sig_small = torch.abs(sigma) < 1e-5
    a = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / torch.where(sig_small, 1.0, sigma))
    denom = sigma * sigma + theta * theta
    sin, cos = torch.sin(theta), torch.cos(theta)
    b = (s * sin * sigma + (1.0 - s * cos) * theta) / (theta * denom)
    c = (a - ((s * cos - 1.0) * sigma + s * sin * theta) / denom) / (theta * theta)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(k.shape)
    w = a[..., None, None] * eye + b[..., None, None] * k + c[..., None, None] * (k @ k)
    return w


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential map: [..., 7] (rho, phi, sigma) -> [..., 4, 4]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    w = _w_matrix(phi, sigma, s)
    return from_srt(s, se3.so3_exp(phi), (w @ rho[..., None])[..., 0])


def log(s_mat: torch.Tensor) -> torch.Tensor:
    """Sim(3) logarithm: rho from t = W rho through the closed-form adjugate
    of W."""
    s, r, t = split(s_mat)
    phi = se3.so3_log(r)
    sigma = torch.log(torch.clamp(s, min=_EPS))
    w = _w_matrix(phi, sigma, s)
    c00 = w[..., 1, 1] * w[..., 2, 2] - w[..., 1, 2] * w[..., 2, 1]
    c01 = w[..., 0, 2] * w[..., 2, 1] - w[..., 0, 1] * w[..., 2, 2]
    c02 = w[..., 0, 1] * w[..., 1, 2] - w[..., 0, 2] * w[..., 1, 1]
    c10 = w[..., 1, 2] * w[..., 2, 0] - w[..., 1, 0] * w[..., 2, 2]
    c11 = w[..., 0, 0] * w[..., 2, 2] - w[..., 0, 2] * w[..., 2, 0]
    c12 = w[..., 0, 2] * w[..., 1, 0] - w[..., 0, 0] * w[..., 1, 2]
    c20 = w[..., 1, 0] * w[..., 2, 1] - w[..., 1, 1] * w[..., 2, 0]
    c21 = w[..., 0, 1] * w[..., 2, 0] - w[..., 0, 0] * w[..., 2, 1]
    c22 = w[..., 0, 0] * w[..., 1, 1] - w[..., 0, 1] * w[..., 1, 0]
    det = w[..., 0, 0] * c00 + w[..., 0, 1] * c10 + w[..., 0, 2] * c20
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]
    rho = torch.stack([
        (c00 * t0 + c01 * t1 + c02 * t2) * inv_det,
        (c10 * t0 + c11 * t1 + c12 * t2) * inv_det,
        (c20 * t0 + c21 * t1 + c22 * t2) * inv_det,
    ], dim=-1)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
