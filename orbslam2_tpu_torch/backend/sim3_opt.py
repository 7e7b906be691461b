"""Sim3 relative-pose optimization between two keyframes.

Counterpart of ``orbslam2_tpu/backend/sim3_opt.py`` (the reference's
Optimizer::OptimizeSim3): one Sim3, fixed matched point pairs, forward and
inverse projection residuals, Huber(sqrt(10)), a chi2-10 outlier re-gate
between two rounds of Gauss-Newton steps. All pairs are batched.

The JAX package differentiates the residuals with ``jax.jacfwd``; here the
7-dof Jacobian is written out: for the left perturbation exp(xi) S12 at
xi = 0 a point q = S12 p2 moves by [I | -q^ | q] xi, and p1 seen from frame
2, S12^-1 exp(-xi) p1, by -(1/s) R^T [I | -p1^ | p1] xi. That is the exact
derivative of the JAX package's exponential map at zero.
"""
from __future__ import annotations

from typing import Tuple

import torch

from orbslam2_tpu_torch.geometry import se3, sim3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera

CHI2_SIM3 = 10.0


def _residuals(s12: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
               uv1: torch.Tensor, uv2: torch.Tensor, cam: PinholeCamera):
    """e = [uv1 - proj(S12 p2); uv2 - proj(S12^-1 p1)] -> ([N, 4], camera
    points in frame 1 and in frame 2)."""
    p2in1 = sim3.apply(s12, pts2)
    p1in2 = sim3.apply(sim3.inverse(s12), pts1)
    uvp1, _ = cam.project(p2in1)
    uvp2, _ = cam.project(p1in2)
    return torch.cat([uv1 - uvp1, uv2 - uvp2], dim=-1), p2in1, p1in2


def _proj_jacobian(p: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """d proj / d p: [N, 2, 3]."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z * inv_z], -1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z * inv_z], -1),
    ], dim=-2)


def _point_jacobian(q: torch.Tensor) -> torch.Tensor:
    """d (exp(xi) q) / d xi at xi = 0: [N, 3, 7] = [I | -q^ | q]."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    return torch.cat([eye, -se3.hat(q), q[:, :, None]], dim=-1)


def _jacobian(s12, pts1, p2in1, p1in2, cam, fix_scale):
    """d e / d xi for the left perturbation exp(xi) S12 at xi = 0: [N, 4, 7]."""
    s, r, _ = sim3.split(s12)
    j1 = -_proj_jacobian(p2in1, cam) @ _point_jacobian(p2in1)
    j2 = _proj_jacobian(p1in2, cam) @ ((r.T / s) @ _point_jacobian(pts1))
    j = torch.cat([j1, j2], dim=-2)
    if fix_scale:
        j = torch.cat([j[..., :6], torch.zeros_like(j[..., 6:])], dim=-1)
    return j


def optimize_sim3(
    s12_0: torch.Tensor,     # [4, 4] initial Sim3 (frame2 -> frame1 coords)
    pts1: torch.Tensor,      # [N, 3] matched points in KF1 camera coords
    pts2: torch.Tensor,      # [N, 3] in KF2 camera coords
    uv1: torch.Tensor,       # [N, 2] observed pixels in image 1
    uv2: torch.Tensor,       # [N, 2] observed pixels in image 2
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    cam: PinholeCamera,
    fix_scale: bool = False,
    iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (s12, inlier mask, n_inliers). Two rounds of `iters` Gauss-Newton
    steps with chi2-10 reclassification between them; nothing waits for the
    host."""
    delta = CHI2_SIM3 ** 0.5
    eye7 = torch.eye(7, dtype=pts1.dtype, device=pts1.device)

    def chi2(e):
        c1 = torch.sum(e[:, :2] ** 2, dim=-1) * inv_sigma2_1
        c2 = torch.sum(e[:, 2:] ** 2, dim=-1) * inv_sigma2_2
        return c1, c2

    def gn_rounds(s12, active):
        for _ in range(iters):
            e, p2in1, p1in2 = _residuals(s12, pts1, pts2, uv1, uv2, cam)
            j = _jacobian(s12, pts1, p2in1, p1in2, cam, fix_scale)
            c1, c2 = chi2(e)
            s1 = torch.sqrt(torch.clamp(c1, min=1e-12))
            s2 = torch.sqrt(torch.clamp(c2, min=1e-12))
            w1 = torch.where(s1 > delta, delta / s1, 1.0) * inv_sigma2_1
            w2 = torch.where(s2 > delta, delta / s2, 1.0) * inv_sigma2_2
            w = torch.stack([w1, w1, w2, w2], dim=-1) * active[:, None]
            jw = j * w[:, :, None]
            h = torch.einsum("nri,nrj->ij", jw, j) + 1e-6 * eye7
            b = -torch.einsum("nri,nr->i", jw, e)
            xi = torch.linalg.solve_ex(h, b[:, None]).result[:, 0]
            if fix_scale:
                xi = torch.cat([xi[:6], torch.zeros_like(xi[6:])])
            s12 = sim3.compose(sim3.exp(xi), s12)
        return s12

    def classify(s12):
        e, p2in1, p1in2 = _residuals(s12, pts1, pts2, uv1, uv2, cam)
        c1, c2 = chi2(e)
        return (valid & (c1 < CHI2_SIM3) & (c2 < CHI2_SIM3)
                & (p2in1[:, 2] > 0) & (p1in2[:, 2] > 0))

    s12 = gn_rounds(s12_0, valid.to(pts1.dtype))
    s12 = gn_rounds(s12, classify(s12).to(pts1.dtype))
    inlier = classify(s12)
    return s12, inlier, inlier.sum()
