"""Batched DLT triangulation and epipolar geometry helpers.

Counterpart of ``orbslam2_tpu/geometry/triangulate.py``: the reference's
per-point SVD loop becomes one batched closed-form solve over all candidate
pairs at once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from orbslam2_tpu_torch.geometry.se3 import hat


def projection_matrix(k: torch.Tensor, tcw: torch.Tensor) -> torch.Tensor:
    """P = K [R|t], [..., 3, 4]."""
    return k @ tcw[..., :3, :4]


def triangulate_dlt(p1: torch.Tensor, p2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Linear triangulation of point pairs.

    p1, p2: [..., 3, 4] projection matrices; uv1, uv2: [..., 2] pixels.
    Returns world points [..., 3]: the inhomogeneous DLT least squares
    B X = -a (the 4x4 system's first three columns against its last, i.e.
    the w=1 gauge) through closed-form 3x3 normal equations. There is no
    null vector to normalise and hence no sign to agree on. Points near
    infinity (w ~ 0) get garbage; the callers' parallax, cheirality and
    chi-square gates reject them.
    """
    rows = torch.stack(
        [
            uv1[..., 0, None] * p1[..., 2, :] - p1[..., 0, :],
            uv1[..., 1, None] * p1[..., 2, :] - p1[..., 1, :],
            uv2[..., 0, None] * p2[..., 2, :] - p2[..., 0, :],
            uv2[..., 1, None] * p2[..., 2, :] - p2[..., 1, :],
        ],
        dim=-2,
    )  # [..., 4, 4]
    b = rows[..., :, :3]
    rhs = -rows[..., :, 3]
    ata = torch.einsum("...ki,...kj->...ij", b, b)      # [..., 3, 3] SPD
    atb = torch.einsum("...ki,...k->...i", b, rhs)
    a00, a01, a02 = ata[..., 0, 0], ata[..., 0, 1], ata[..., 0, 2]
    a11, a12, a22 = ata[..., 1, 1], ata[..., 1, 2], ata[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    tiny = torch.where(det < 0, -1e-20, 1e-20)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, tiny, det)
    b0, b1, b2 = atb[..., 0], atb[..., 1], atb[..., 2]
    x = torch.stack([
        c00 * b0 + c01 * b1 + c02 * b2,
        c01 * b0 + c11 * b1 + c12 * b2,
        c02 * b0 + c12 * b1 + c22 * b2,
    ], dim=-1) * inv_det[..., None]
    return x


def fundamental_from_poses(k1: torch.Tensor, tcw1: torch.Tensor,
                           k2: torch.Tensor, tcw2: torch.Tensor) -> torch.Tensor:
    """F12 such that x1^T F12 x2 = 0 for corresponding pixels
    (LocalMapping::ComputeF12)."""
    r1, t1 = tcw1[..., :3, :3], tcw1[..., :3, 3]
    r2, t2 = tcw2[..., :3, :3], tcw2[..., :3, 3]
    r12 = r1 @ r2.transpose(-1, -2)
    t12 = t1 - torch.einsum("...ij,...j->...i", r12, t2)
    k1_inv_t = torch.linalg.inv(k1.transpose(-1, -2))
    k2_inv = torch.linalg.inv(k2)
    return k1_inv_t @ hat(t12) @ r12 @ k2_inv


def epipolar_distance_sq(uv1: torch.Tensor, uv2: torch.Tensor,
                         f12: torch.Tensor) -> torch.Tensor:
    """Squared distance of x2 from the epipolar line l2 = x1^T F12 of x1
    (ORBmatcher::CheckDistEpipolarLine)."""
    a = uv1[..., 0] * f12[..., 0, 0] + uv1[..., 1] * f12[..., 1, 0] + f12[..., 2, 0]
    b = uv1[..., 0] * f12[..., 0, 1] + uv1[..., 1] * f12[..., 1, 1] + f12[..., 2, 1]
    c = uv1[..., 0] * f12[..., 0, 2] + uv1[..., 1] * f12[..., 1, 2] + f12[..., 2, 2]
    num = a * uv2[..., 0] + b * uv2[..., 1] + c
    den = a * a + b * b
    return num * num / torch.where(den < 1e-12, 1e-12, den)


def parallax_cos(center1: torch.Tensor, center2: torch.Tensor,
                 pts: torch.Tensor) -> torch.Tensor:
    """Cosine of the ray parallax angle at each point [..., 3] between two
    camera centers."""
    r1 = pts - center1
    r2 = pts - center2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)


def reprojection_error_sq(k: torch.Tensor, tcw: torch.Tensor, pts_w: torch.Tensor,
                          uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (squared pixel error, depth) for world points under pose tcw."""
    pc = torch.einsum("...ij,...j->...i", tcw[..., :3, :3], pts_w) + tcw[..., :3, 3]
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    u = k[..., 0, 0] * pc[..., 0] * inv_z + k[..., 0, 2]
    v = k[..., 1, 1] * pc[..., 1] * inv_z + k[..., 1, 2]
    du = u - uv[..., 0]
    dv = v - uv[..., 1]
    return du * du + dv * dv, z
