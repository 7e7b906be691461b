"""Horn/Umeyama absolute orientation and batched Sim3 RANSAC.

Counterpart of ``orbslam2_tpu/solvers/horn.py`` (the reference's
Sim3Solver): the closed-form 3D-3D similarity of a point set (the
SVD/Umeyama form of Horn's method), and a RANSAC over 3-point sets with
mutual-reprojection inlier checks. Scale is frozen for stereo and RGB-D.

The random draw is split from the scoring: ``draw_sample_sets`` draws the
index sets from an explicit ``torch.Generator``; ``sim3_ransac`` takes the
sets and scores every hypothesis at once (one [iters, N] inlier pass). The
JAX package draws with ``jax.random.choice``, which no torch generator
reproduces, so a test can hand this function the sets JAX drew.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.geometry import sim3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera


def draw_sample_sets(valid, iters: int, size: int, seed: int,
                     device="cpu") -> torch.Tensor:
    """`iters` sets of `size` distinct indices among the valid entries, each
    drawn uniformly, from a CPU generator seeded with `seed`. -> [iters,
    size] int64 on `device`."""
    w = torch.as_tensor(np.asarray(valid), dtype=torch.float32)
    gen = torch.Generator().manual_seed(int(seed))
    sets = torch.multinomial(w.expand(iters, -1), size, replacement=False,
                             generator=gen)
    return sets.to(device)


def umeyama(src: torch.Tensor, dst: torch.Tensor, w: Optional[torch.Tensor] = None,
            with_scale: bool = True):
    """Weighted least-squares similarity: dst ~= s R src + t.

    src, dst: [..., N, 3]; w: [..., N] nonnegative weights.
    -> (s [...], r [..., 3, 3], t [..., 3]).
    """
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    wn = w / wsum
    mu_s = torch.sum(src * wn[..., None], dim=-2)
    mu_d = torch.sum(dst * wn[..., None], dim=-2)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = (xd * wn[..., None]).transpose(-1, -2) @ xs
    u, d, vt = torch.linalg.svd(cov)
    det = sim3._det3(u) * sim3._det3(vt)
    sflip = torch.ones_like(d)
    sflip[..., 2] = torch.sign(det)
    r = u @ (sflip[..., :, None] * vt)
    if with_scale:
        var_s = torch.sum(torch.sum(xs * xs, dim=-1) * wn, dim=-1)
        s = torch.sum(d * sflip, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_d - s[..., None] * (r @ mu_s[..., None])[..., 0]
    return s, r, t


class Sim3RansacResult(NamedTuple):
    success: torch.Tensor   # [] bool
    s12: torch.Tensor       # [4, 4] Sim3 mapping frame-2 coords into frame 1
    inliers: torch.Tensor   # [N] bool
    n_inliers: torch.Tensor  # [] int


def sim3_ransac(
    pts1_cam: torch.Tensor,   # [N, 3] matched points in KF1 camera coords
    pts2_cam: torch.Tensor,   # [N, 3] the same points in KF2 camera coords
    valid: torch.Tensor,      # [N]
    sigma2_1: torch.Tensor,   # [N] octave sigma^2 in image 1
    sigma2_2: torch.Tensor,   # [N]
    cam: PinholeCamera,
    sets: torch.Tensor,       # [iters, 3] index sets (draw_sample_sets)
    fix_scale: bool = False,
    min_inliers: int = 20,
) -> Sim3RansacResult:
    """RANSAC over the given 3-point sets; inliers by mutual projection with
    chi2 9.210 per direction. The best hypothesis (first of the most
    inliers) is refined on its inliers and kept if that holds as many."""
    uv1, _ = cam.project(pts1_cam)
    uv2, _ = cam.project(pts2_cam)

    def count_inliers(s, r, t):
        """Batched over leading dims of (s, r, t) -> [..., N] bool."""
        p2in1 = s[..., None, None] * (pts2_cam @ r.transpose(-1, -2)) + t[..., None, :]
        s_inv = 1.0 / torch.clamp(s, min=1e-12)
        p1in2 = s_inv[..., None, None] * ((pts1_cam - t[..., None, :]) @ r)
        uv1_proj, z1 = cam.project(p2in1)
        uv2_proj, z2 = cam.project(p1in2)
        e1 = torch.sum((uv1_proj - uv1) ** 2, dim=-1) / sigma2_1
        e2 = torch.sum((uv2_proj - uv2) ** 2, dim=-1) / sigma2_2
        return valid & (e1 < 9.210) & (e2 < 9.210) & (z1 > 0) & (z2 > 0)

    ss, rs, ts = umeyama(pts2_cam[sets], pts1_cam[sets], with_scale=not fix_scale)
    counts = count_inliers(ss, rs, ts).sum(dim=-1)             # [iters]
    best = torch.argmax(counts)
    s_b, r_b, t_b = ss[best], rs[best], ts[best]
    inl = count_inliers(s_b, r_b, t_b)
    s_r, r_r, t_r = umeyama(pts2_cam, pts1_cam, inl.to(pts1_cam.dtype),
                            with_scale=not fix_scale)
    inl_r = count_inliers(s_r, r_r, t_r)
    better = inl_r.sum() >= inl.sum()
    s_f = torch.where(better, s_r, s_b)
    r_f = torch.where(better, r_r, r_b)
    t_f = torch.where(better, t_r, t_b)
    inl_f = torch.where(better, inl_r, inl)
    n_inl = inl_f.sum()
    return Sim3RansacResult(success=n_inl >= min_inliers,
                            s12=sim3.from_srt(s_f, r_f, t_f),
                            inliers=inl_f, n_inliers=n_inl)
