"""Monocular two-view bootstrap: batched H / F RANSAC and reconstruction.

Counterpart of ``orbslam2_tpu/solvers/initializer.py`` (the reference's
Initializer): the 200 eight-point sets are scored for the homography and for
the fundamental matrix as one batch each (one [200, 9, 9] ``eigh`` per model,
one [200, 3, 3] SVD for the rank-2 step of F), the model is chosen by the
rule RH = SH / (SH + SF) > 0.40, each model is refitted twice on all its
inliers, and the winner's motion hypotheses (4 from E, 8 from Faugeras's
decomposition of H) are triangulated and checked as one [8, N] batch.
Thresholds: chi2 5.991 (H symmetric transfer), 3.841 / 5.991 (F epipolar),
reprojection 4 sigma^2, minimum parallax 1 degree.

As in ``solvers/horn.py`` the random draw is split from the scoring: the
caller draws the index sets (``horn.draw_sample_sets``) and hands them in,
so that a test can hand in the sets the JAX package draws.

Everything runs on the device of the inputs and makes no host
synchronisation of its own, except the convergence checks of ``eigh`` and
``svd``: no inverse raises on a singular sample (``inv_ex``), and the
model choice and the acceptance gates are tensors. Eigenvectors and
singular vectors come out up to sign, which H, F and the set of motion
hypotheses do not see.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import triangulate as tri
from orbslam2_tpu_torch.geometry.sim3 import _det3

SIGMA = 1.0
CHI2_H = 5.991
CHI2_F_DIR = 3.841
CHI2_F_SCORE = 5.991


class InitResult(NamedTuple):
    success: torch.Tensor          # [] bool
    used_homography: torch.Tensor  # [] bool
    r21: torch.Tensor              # [3, 3] rotation frame 1 -> frame 2
    t21: torch.Tensor              # [3] unit-norm translation
    points: torch.Tensor           # [N, 3] triangulated points in frame-1 coords
    good: torch.Tensor             # [N] bool triangulation accepted
    n_good: torch.Tensor           # [] int


def _inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse that neither checks nor synchronises: a singular
    matrix gives non-finite entries, as in the JAX package."""
    return torch.linalg.inv_ex(a)[0]


def _normalize(uv: torch.Tensor, valid: torch.Tensor):
    """Hartley normalisation: zero mean, unit mean absolute deviation over
    the valid rows. -> (normalised uv, T [3, 3])."""
    w = valid.to(uv.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(uv * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(uv - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-9)
    uvn = (uv - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    t = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one])])
    return uvn, t


def _null_vector(a: torch.Tensor) -> torch.Tensor:
    """The eigenvector of AᵀA with the smallest eigenvalue, [..., 9]."""
    _, v = torch.linalg.eigh(a.transpose(-1, -2) @ a)
    return v[..., :, 0]


def _dlt_homography(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """H21 from >= 4 normalised correspondences [..., M, 2] by (weighted)
    DLT. -> [..., 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    rows_a = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1)
    rows_b = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], dim=-1)
    a = torch.cat([rows_a, rows_b], dim=-2)
    if w is not None:
        a = a * torch.cat([w, w], dim=-1)[..., None]
    return _null_vector(a).reshape(*a.shape[:-2], 3, 3)


def _eight_point_f(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """F21 from >= 8 normalised correspondences [..., M, 2] (weighted),
    rank 2 enforced. -> [..., 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)
    if w is not None:
        a = a * w[..., None]
    f = _null_vector(a).reshape(*a.shape[:-2], 3, 3)
    u, d, vt = torch.linalg.svd(f)
    d = torch.cat([d[..., :2], torch.zeros_like(d[..., 2:])], dim=-1)
    return u @ (d[..., :, None] * vt)


def _transfer(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared transfer error of b against h·a, h [..., 3, 3], a b [N, 2]."""
    h = h[..., None, :, :]
    x = h[..., 0, 0] * a[:, 0] + h[..., 0, 1] * a[:, 1] + h[..., 0, 2]
    y = h[..., 1, 0] * a[:, 0] + h[..., 1, 1] * a[:, 1] + h[..., 1, 2]
    z = h[..., 2, 0] * a[:, 0] + h[..., 2, 1] * a[:, 1] + h[..., 2, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    du = b[:, 0] - x * inv_z
    dv = b[:, 1] - y * inv_z
    return (du * du + dv * dv) / (SIGMA * SIGMA)


def _score_h(h21: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
             valid: torch.Tensor):
    """Symmetric transfer score of homographies [..., 3, 3].
    -> (score [...], inliers in both directions [..., N])."""
    eye = torch.eye(3, dtype=h21.dtype, device=h21.device)
    h12 = _inv(h21 + 1e-12 * eye)
    c1 = _transfer(h21, uv1, uv2)
    c2 = _transfer(h12, uv2, uv1)
    in1 = (c1 < CHI2_H) & valid
    in2 = (c2 < CHI2_H) & valid
    score = torch.sum(torch.where(in1, CHI2_H - c1, 0.0)
                      + torch.where(in2, CHI2_H - c2, 0.0), dim=-1)
    return score, in1 & in2


def _line_dist_sq(line: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Squared distance of pixels [N, 2] from lines [..., N, 3]
    (ax + by + c = 0)."""
    num = line[..., 0] * uv[:, 0] + line[..., 1] * uv[:, 1] + line[..., 2]
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num * num / torch.clamp(den, min=1e-12)


def _score_f(f21: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
             valid: torch.Tensor):
    """Epipolar distance score of fundamental matrices [..., 3, 3], with
    x2ᵀ F21 x1 = 0: the line in image 2 is F21 x1, in image 1 F21ᵀ x2.
    -> (score [...], inliers in both directions [..., N])."""
    ones = torch.ones_like(uv1[:, :1])
    x1h = torch.cat([uv1, ones], dim=1)
    x2h = torch.cat([uv2, ones], dim=1)
    line2 = x1h @ f21.transpose(-1, -2)   # [..., N, 3] rows (F21 x1)ᵀ
    line1 = x2h @ f21                     # [..., N, 3] rows (F21ᵀ x2)ᵀ
    d2 = _line_dist_sq(line2, uv2) / (SIGMA * SIGMA)
    d1 = _line_dist_sq(line1, uv1) / (SIGMA * SIGMA)
    in1 = (d2 < CHI2_F_DIR) & valid
    in2 = (d1 < CHI2_F_DIR) & valid
    score = torch.sum(torch.where(in1, CHI2_F_SCORE - d2, 0.0)
                      + torch.where(in2, CHI2_F_SCORE - d1, 0.0), dim=-1)
    return score, in1 & in2


def _check_rt(r: torch.Tensor, t: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
              valid: torch.Tensor, k: torch.Tensor):
    """Cheirality and reprojection gate of motion hypotheses r [H, 3, 3],
    t [H, 3] (the reference's CheckRT), all hypotheses at once.
    -> (n_good [H], good [H, N], the ~50th smallest parallax cosine [H],
    points [H, N, 3] in frame-1 coordinates)."""
    n_h = r.shape[0]
    eye34 = torch.eye(3, 4, dtype=r.dtype, device=r.device)
    rt = torch.cat([r, t[:, :, None]], dim=2)                      # [H, 3, 4]
    p1 = (k @ eye34).expand(n_h, 1, 3, 4)
    p2 = (k @ rt)[:, None]
    pts = tri.triangulate_dlt(p1, p2, uv1, uv2)                    # [H, N, 3]

    finite = torch.all(torch.isfinite(pts), dim=-1)
    z1 = pts[..., 2]
    pts2 = pts @ r.transpose(-1, -2) + t[:, None, :]
    z2 = pts2[..., 2]

    c1 = torch.zeros(3, dtype=r.dtype, device=r.device)
    c2 = -(r.transpose(-1, -2) @ t[:, :, None])[..., 0]            # [H, 3]
    pcos = tri.parallax_cos(c1, c2[:, None, :], pts)

    t1m = torch.eye(4, dtype=r.dtype, device=r.device)
    e1, _ = tri.reprojection_error_sq(k, t1m, pts, uv1)
    t2m = torch.cat([rt, t1m[3:].expand(n_h, 1, 4)], dim=1)[:, None]
    e2, _ = tri.reprojection_error_sq(k, t2m, pts, uv2)

    th = 4.0 * SIGMA * SIGMA
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (pcos < 0.99998)
            & (e1 < th) & (e2 < th))
    n_good = torch.sum(good, dim=-1)
    # parallax statistic: the ~50th best (the reference takes the 50th
    # smallest angle)
    pcos_sorted = torch.sort(torch.where(good, pcos, 1.0), dim=-1).values
    idx = torch.clamp(n_good - 1, min=0, max=49)
    parallax_cos50 = torch.gather(pcos_sorted, 1, idx[:, None])[:, 0]
    return n_good, good, parallax_cos50, pts


def _decompose_e(e: torch.Tensor):
    """E -> 4 (R, t) hypotheses (the reference's DecomposeE), in the order
    (R1, t), (R1, -t), (R2, t), (R2, -t)."""
    u, _, vt = torch.linalg.svd(e)
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=e.dtype, device=e.device)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    r1 = r1 * torch.sign(_det3(r1))
    r2 = r2 * torch.sign(_det3(r2))
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([r1, r1, r2, r2]), torch.stack([t, -t, t, -t])


def _decompose_h(h21: torch.Tensor, k: torch.Tensor):
    """Faugeras's SVD decomposition of a homography into 8 motion
    hypotheses (the reference's ReconstructH): 4 with d' > 0, then 4 with
    d' < 0."""
    a = _inv(k) @ h21 @ k
    u, d, vt = torch.linalg.svd(a)
    s = _det3(u) * _det3(vt)
    d1, d2, d3 = d[0], d[1], d[2]
    dd12, dd23 = d1 * d1 - d2 * d2, d2 * d2 - d3 * d3
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(dd12 / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp(dd23 / den13, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp(dd12 * dd23, min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def hypotheses(st, ct, sign_y, x3_sign, t_scale, flip):
        # d' > 0: Rp = [[c, 0, -s], [0, 1, 0], [s, 0, c]], tp = (x1, 0, -x3)
        # d' < 0: Rp = [[c, 0, s], [0, -1, 0], [s, 0, -c]], tp = (x1, 0, x3)
        z4, o4, c4 = zero.expand(4), one.expand(4), ct.expand(4)
        rp = torch.stack([
            torch.stack([c4, z4, flip * st], dim=-1),
            torch.stack([z4, sign_y * o4, z4], dim=-1),
            torch.stack([st, z4, -flip * c4], dim=-1)], dim=-2)
        r = s * u @ rp @ vt
        tp = torch.stack([x1s, z4, x3_sign * x3s], dim=-1) * t_scale
        t = tp @ u.T
        return r, t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)

    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    st = root / den_p
    ct = (d2 * d2 + d1 * d3) / den_p
    rs_pos, ts_pos = hypotheses(torch.stack([st, -st, -st, st]), ct, 1.0, -1.0,
                                d1 - d3, -1.0)
    den_n = torch.clamp((d1 - d3) * d2, min=1e-12)
    sp = root / den_n
    cp = (d1 * d3 - d2 * d2) / den_n
    rs_neg, ts_neg = hypotheses(torch.stack([sp, -sp, -sp, sp]), cp, -1.0, 1.0,
                                d1 + d3, 1.0)
    return torch.cat([rs_pos, rs_neg]), torch.cat([ts_pos, ts_neg])


def _denormalize_h(h_n: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    h = _inv(t2) @ h_n @ t1    # x2 = H21 x1 in pixels
    h22 = h[..., 2:3, 2:3]
    return h / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)


def _n_similar(n_goods: torch.Tensor, n_best: torch.Tensor) -> torch.Tensor:
    """Hypotheses whose good count is above 70 % of the best (the best one
    among them): a clear winner has 1. Compared in float32, as the JAX
    package computes it (its weakly typed 0.7 makes the product float32);
    in float64 a count such as 63 of 90 falls the other way."""
    f32 = torch.float32
    seventy = torch.tensor(0.7, dtype=f32, device=n_goods.device)
    return torch.sum(n_goods.to(f32) > seventy * n_best.to(f32))


def initialize_two_view(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                        k: torch.Tensor, sets: torch.Tensor) -> InitResult:
    """The monocular bootstrap on matched pairs (uv1[i] <-> uv2[i], [N, 2]),
    with the RANSAC index sets `sets` [iters, 8] drawn among the valid pairs
    (``horn.draw_sample_sets(valid, 200, 8, seed)``).

    Every hypothesis of both models is scored at once; the winning model is
    reconstructed with all its candidate motions checked by one batched
    triangulation; acceptance as the reference's: a clear cheirality winner
    (no other hypothesis above 70 % of its count, in float32 as the JAX
    package computes it), at least 50 good points and 90 % of the model's
    inliers, and a parallax above 1 degree."""
    dt, dev = uv1.dtype, uv1.device
    k = k.to(dt)
    uv1n, t1 = _normalize(uv1, valid)
    uv2n, t2 = _normalize(uv2, valid)

    # --- homography hypotheses, one batch ------------------------------
    hs = _denormalize_h(_dlt_homography(uv1n[sets], uv2n[sets]), t1, t2)
    h_scores, _ = _score_h(hs, uv1, uv2, valid)
    best_h_i = torch.argmax(h_scores)
    best_h, sh = hs[best_h_i], h_scores[best_h_i]

    # --- fundamental hypotheses, one batch -----------------------------
    fs = t2.T @ _eight_point_f(uv1n[sets], uv2n[sets]) @ t1
    f_scores, _ = _score_f(fs, uv1, uv2, valid)
    best_f_i = torch.argmax(f_scores)
    best_f, sf = fs[best_f_i], f_scores[best_f_i]

    rh = sh / torch.clamp(sh + sf, min=1e-12)
    use_h = rh > 0.40

    # refit the winning models on their full inlier sets, twice
    for _ in range(2):
        _, inl = _score_f(best_f, uv1, uv2, valid)
        best_f = t2.T @ _eight_point_f(uv1n, uv2n, inl.to(dt)) @ t1
    for _ in range(2):
        _, inl = _score_h(best_h, uv1, uv2, valid)
        best_h = _denormalize_h(_dlt_homography(uv1n, uv2n, inl.to(dt)), t1, t2)

    _, h_inliers = _score_h(best_h, uv1, uv2, valid)
    _, f_inliers = _score_f(best_f, uv1, uv2, valid)
    inliers = torch.where(use_h, h_inliers, f_inliers)

    # --- motion hypotheses: F's 4 padded to 8 --------------------------
    rs_f, ts_f = _decompose_e(k.T @ best_f @ k)
    eye = torch.eye(3, dtype=dt, device=dev)
    rs_f = torch.cat([rs_f, eye.expand(4, 3, 3)])
    ts_f = torch.cat([ts_f, torch.zeros(4, 3, dtype=dt, device=dev)])
    rs_h, ts_h = _decompose_h(best_h, k)
    rs = torch.where(use_h, rs_h, rs_f)
    ts = torch.where(use_h, ts_h, ts_f)
    hypo_valid = use_h | (torch.arange(8, device=dev) < 4)

    n_goods, goods, pcos, ptss = _check_rt(rs, ts, uv1, uv2, inliers, k)
    n_goods = torch.where(hypo_valid, n_goods, -1)
    best = torch.argmax(n_goods)
    n_best = n_goods[best]
    n_similar = _n_similar(n_goods, n_best)
    n_inliers = torch.sum(inliers)
    f32 = torch.float32
    min_good = torch.clamp((torch.tensor(0.9, dtype=f32, device=dev)
                            * n_inliers.to(f32)).to(torch.int64), min=50)
    cos_1deg = torch.cos(torch.deg2rad(torch.tensor(1.0, dtype=f32, device=dev)))
    parallax_ok = pcos[best] < cos_1deg
    success = (n_best >= min_good) & (n_similar == 1) & parallax_ok
    return InitResult(success=success, used_homography=use_h, r21=rs[best],
                      t21=ts[best], points=ptss[best], good=goods[best], n_good=n_best)
