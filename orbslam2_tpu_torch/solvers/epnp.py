"""EPnP and batched RANSAC: camera pose from 2D-3D correspondences.

Counterpart of ``orbslam2_tpu/solvers/epnp.py`` (the reference's PnPsolver):
Lepetit's EPnP (4 control points from the principal directions, barycentric
coordinates, the M-matrix null space, the beta cases N=1, 2, 3 refined by 5
Gauss-Newton steps against the control-point distances, plus the plain N=1
closed form), inside a RANSAC over 4-point sets. Every hypothesis is solved
and scored at once (the solver takes a leading batch of weight vectors);
the winner is refined on its inliers.

As in solvers/horn.py, the random draw is split from the scoring:
``horn.draw_sample_sets`` draws the sets, ``epnp_ransac`` takes them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.solvers.horn import umeyama

# the quadratic monomials of the betas: (b1b1, b1b2, b2b2, b1b3, b2b3, b3b3,
# b1b4, b2b4, b3b4, b4b4)
_PAIRS_I = (0, 0, 1, 0, 1, 2, 0, 1, 2, 3)
_PAIRS_J = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3)


def _control_points(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Centroid + principal directions scaled by their deviation.
    pts [N,3], w [B,N] -> [B, 4, 3]."""
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    c0 = torch.sum(pts * wn[..., None], dim=-2)
    x = (pts - c0[:, None, :]) * torch.sqrt(wn)[..., None]
    eigval, eigvec = torch.linalg.eigh(x.transpose(-1, -2) @ x)
    scales = torch.sqrt(torch.clamp(eigval, min=1e-12))
    cs = c0[:, None, :] + eigvec.transpose(-1, -2) * scales[..., None]
    return torch.cat([c0[:, None, :], cs], dim=1)


def _barycentric(pts: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """alphas [B, N, 4] with pts = alphas @ ctrl, sum(alphas) = 1."""
    b = ctrl.shape[0]
    ones = torch.ones((b, 1, 4), dtype=ctrl.dtype, device=ctrl.device)
    m = torch.cat([ctrl.transpose(-1, -2), ones], dim=-2)             # [B,4,4]
    rhs = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1).T      # [4,N]
    return torch.linalg.solve_ex(m, rhs.expand(b, 4, -1)).result.transpose(-1, -2)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a x = b for small SPD systems, b [..., n] -> [..., n]."""
    return torch.linalg.solve_ex(a, b[..., None]).result[..., 0]


def _sqrt_signed(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(torch.abs(x), min=1e-12)) * torch.sign(x + 1e-20)


def _b10(betas: torch.Tensor) -> torch.Tensor:
    return betas[..., _PAIRS_I] * betas[..., _PAIRS_J]


def _b10_jac(betas: torch.Tensor) -> torch.Tensor:
    """d b10 / d betas: [..., 10, 4]."""
    jac = torch.zeros(betas.shape[:-1] + (10, 4), dtype=betas.dtype,
                      device=betas.device)
    for row, (i, j) in enumerate(zip(_PAIRS_I, _PAIRS_J)):
        jac[..., row, i] += betas[..., j]
        jac[..., row, j] += betas[..., i]
    return jac


def _solve_epnp(pts: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
                cam: PinholeCamera) -> torch.Tensor:
    """Weighted EPnP for a batch of weight vectors: [N,3] world points, [N,2]
    pixels, weights [B,N] -> Tcw [B,4,4]."""
    bsz, n = w.shape
    eye = lambda k: torch.eye(k, dtype=pts.dtype, device=pts.device)
    ctrl_w = _control_points(pts, w)
    alphas = _barycentric(pts, ctrl_w)                                # [B,N,4]

    sw = torch.sqrt(torch.clamp(w, min=0.0))
    a = alphas * sw[..., None]
    zeros = torch.zeros_like(a)
    row_u = torch.stack([a * cam.fx, zeros, a * (cam.cx - uv[:, 0:1])], dim=-1)
    row_v = torch.stack([zeros, a * cam.fy, a * (cam.cy - uv[:, 1:2])], dim=-1)
    m = torch.cat([row_u.reshape(bsz, n, 12), row_v.reshape(bsz, n, 12)], dim=1)
    _, vecs = torch.linalg.eigh(m.transpose(-1, -2) @ m)
    # the 4 smallest eigenvectors, each [4 control points, 3]
    v = vecs[..., :4].transpose(-1, -2).reshape(bsz, 4, 4, 3)

    ii, jj = torch.triu_indices(4, 4, 1, device=pts.device)
    d_w = torch.linalg.norm(ctrl_w[:, ii] - ctrl_w[:, jj], dim=-1)    # [B,6]
    rho = d_w * d_w
    dv = v[:, :, ii, :] - v[:, :, jj, :]                              # [B,4,6,3]
    dd = torch.einsum("bpec,bqec->bepq", dv, dv)                      # [B,6,4,4]
    factor = torch.tensor([1.0 if i == j else 2.0 for i, j in zip(_PAIRS_I, _PAIRS_J)],
                          dtype=pts.dtype, device=pts.device)
    l10 = dd[..., _PAIRS_I, _PAIRS_J] * factor                        # [B,6,10]

    def lstsq_cols(cols):
        a_ = l10[..., list(cols)]
        return _solve(a_.transpose(-1, -2) @ a_ + 1e-9 * eye(len(cols)),
                      (a_.transpose(-1, -2) @ rho[..., None])[..., 0])

    zero = torch.zeros_like(rho[:, 0])
    # N=4 start (find_betas_approx_1): (b11, b12, b13, b14)
    s1 = lstsq_cols((0, 1, 3, 6))
    b1a = _sqrt_signed(s1[:, 0])
    betas_a = torch.stack([b1a, s1[:, 1] / b1a, s1[:, 2] / b1a, s1[:, 3] / b1a], -1)
    # N=2 (find_betas_approx_2): (b11, b12, b22)
    s2 = lstsq_cols((0, 1, 2))
    sgn2 = torch.sign(s2[:, 0] + 1e-20)
    b1b = torch.sqrt(torch.clamp(torch.abs(s2[:, 0]), min=1e-12)) * sgn2
    b2b = torch.sqrt(torch.clamp(torch.abs(s2[:, 2]), min=1e-12)) * torch.sign(s2[:, 1]) * sgn2
    betas_b = torch.stack([b1b, b2b, zero, zero], -1)
    # N=3 (find_betas_approx_3): (b11, b12, b22, b13, b23)
    s3 = lstsq_cols((0, 1, 2, 3, 4))
    b1c = _sqrt_signed(s3[:, 0])
    b2c = (torch.sqrt(torch.clamp(torch.abs(s3[:, 2]), min=1e-12)) * torch.sign(s3[:, 1])
           * torch.sign(s3[:, 0] + 1e-20))
    betas_c = torch.stack([b1c, b2c, s3[:, 3] / b1c, zero], -1)
    # plain N=1 closed form, no Gauss-Newton: immune to its divergence on a
    # minimal set, and the winner whenever v0 is the true null vector
    d_c1 = torch.sqrt(torch.clamp(l10[..., 0], min=0.0))
    beta1 = torch.sum(d_c1 * d_w, -1) / torch.clamp(torch.sum(l10[..., 0], -1), min=1e-12)
    betas_d = torch.stack([beta1, zero, zero, zero], -1)

    betas = torch.stack([betas_a, betas_b, betas_c, betas_d], dim=1)  # [B,4,4]
    l10c, rhoc = l10[:, None], rho[:, None]
    refined = betas
    for _ in range(5):   # Gauss-Newton on ||L b10(betas) - rho||^2
        r = (l10c @ _b10(refined)[..., None])[..., 0] - rhoc          # [B,4,6]
        j = l10c @ _b10_jac(refined)                                  # [B,4,6,4]
        refined = refined - _solve(j.transpose(-1, -2) @ j + 1e-9 * eye(4),
                                   (j.transpose(-1, -2) @ r[..., None])[..., 0])
    refine = torch.tensor([True, True, True, False], device=pts.device)
    betas = torch.where(refine[None, :, None], refined, betas)

    ctrl_c = torch.einsum("bci,bikd->bckd", betas, v)                 # [B,4,4,3]
    # control points must give positive depths
    z_pts = (alphas[:, None] @ ctrl_c[..., 2:3])[..., 0]              # [B,4,N]
    depth_sign = torch.sign(torch.sum(z_pts * w[:, None], -1) + 1e-12)
    ctrl_c = ctrl_c * depth_sign[..., None, None]
    pc = alphas[:, None] @ ctrl_c                                     # [B,4,N,3]
    _, r, t = umeyama(pts.expand_as(pc), pc, w[:, None].expand(pc.shape[:-1]),
                      with_scale=False)
    tcws = se3.from_rt(r, t)                                          # [B,4,4,4]
    # reprojection cost of each case, a behind-camera point penalised
    uvp, z = cam.project(se3.apply(tcws[:, :, None], pts))
    e = torch.sum((uvp - uv) ** 2, dim=-1)
    pen = torch.where(z <= 0, 1e6, 0.0)
    costs = torch.sum((e + pen) * w[:, None], dim=-1)                 # [B,4]
    best = torch.min(costs, dim=-1).indices     # first minimum, as jnp.argmin
    return tcws[torch.arange(bsz, device=pts.device), best]


class PnPResult(NamedTuple):
    success: torch.Tensor
    tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def epnp_ransac(
    pts: torch.Tensor,      # [N, 3] world points
    uv: torch.Tensor,       # [N, 2] observed pixels
    valid: torch.Tensor,    # [N]
    sigma2: torch.Tensor,   # [N] octave sigma^2
    cam: PinholeCamera,
    sets: torch.Tensor,     # [iters, 4] index sets (horn.draw_sample_sets)
    min_inliers: int = 10,
) -> PnPResult:
    """RANSAC over 4-point EPnP hypotheses (the reference's minimal set);
    chi2 gate 5.991 * sigma2."""
    def count_inliers(tcw):
        """tcw [..., 4, 4] -> [..., N] bool."""
        pc = pts @ tcw[..., :3, :3].transpose(-1, -2) + tcw[..., None, :3, 3]
        uvp, z = cam.project(pc)
        e = torch.sum((uvp - uv) ** 2, dim=-1) / sigma2
        return valid & (e < 5.991) & (z > 0)

    w = torch.zeros((sets.shape[0], pts.shape[0]), dtype=pts.dtype, device=pts.device)
    w.scatter_(1, sets, 1.0)
    tcws = _solve_epnp(pts, uv, w * valid, cam)
    counts = count_inliers(tcws).sum(dim=-1)
    tcw_b = tcws[torch.argmax(counts)]
    inl = count_inliers(tcw_b)
    # refine on all inliers (PnPsolver::Refine)
    tcw_r = _solve_epnp(pts, uv, inl.to(pts.dtype)[None], cam)[0]
    inl_r = count_inliers(tcw_r)
    better = inl_r.sum() >= inl.sum()
    tcw_f = torch.where(better, tcw_r, tcw_b)
    inl_f = torch.where(better, inl_r, inl)
    n_inl = inl_f.sum()
    return PnPResult(success=n_inl >= min_inliers, tcw=tcw_f, inliers=inl_f,
                     n_inliers=n_inl)
