"""New-map-point creation by epipolar matching + batched triangulation.

Counterpart of ``orbslam2_tpu/frontend/triangulation.py``
(LocalMapping::CreateNewMapPoints + ORBmatcher::SearchForTriangulation): for
a keyframe pair, match unassociated keypoints under the epipolar constraint
with one dense Hamming matrix, then triangulate and gate all candidates in
one batched pass (parallax, cheirality, reprojection chi2, scale
consistency).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from orbslam2_tpu_torch.geometry import se3, triangulate as tri
from orbslam2_tpu_torch.frontend.kernels import keyframe_keypoints
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops import hamming, match
from orbslam2_tpu_torch.ops.orb import Keypoints


class TriangulationResult(NamedTuple):
    kp2_idx: torch.Tensor   # [N1] matched keypoint in KF2, -1 if none survived
    points: torch.Tensor    # [N1, 3] world points (valid where kp2_idx >= 0)


def triangulate_pair(
    tcw1: torch.Tensor,
    kp1: Keypoints,
    free1: torch.Tensor,       # [N1] keypoint has no map point yet
    ur1: torch.Tensor,         # [N1] stereo virtual right-u (<0 mono)
    depth1: torch.Tensor,      # [N1] keypoint depth (<0 unknown)
    tcw2: torch.Tensor,
    kp2: Keypoints,
    free2: torch.Tensor,
    ur2: torch.Tensor,
    depth2: torch.Tensor,
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
) -> TriangulationResult:
    dev = tcw1.device
    k = cam.k_matrix(dev)
    n2 = kp2.n
    # epipolar geometry KF1 -> KF2
    f12 = tri.fundamental_from_poses(k, tcw1, k, tcw2)
    c1 = se3.camera_center(tcw1)
    c2 = se3.camera_center(tcw2)
    baseline = torch.linalg.norm(c2 - c1)

    # epipole of camera 1 in image 2
    ep2, _ = cam.project(se3.apply(tcw2, c1))

    # descriptor matrix with epipolar + availability masks
    dist = hamming.distance_matrix(kp1.desc, kp2.desc,
                                   kp1.valid & free1, kp2.valid & free2)
    ed = _pairwise_epipolar(kp1.xy, kp2.xy, f12)
    sigma2_2 = scale_factor ** (2.0 * kp2.octave.to(torch.float32))
    epi_ok = ed < 3.84 * sigma2_2[None, :]
    # reject kp2 too close to the epipole (reference: 100*scale^2 px^2)
    d_ep = torch.sum((kp2.xy - ep2[None, :]) ** 2, dim=-1)
    ep_ok = d_ep >= 100.0 * sigma2_2

    best_j, best_d, _ = hamming.best_and_second(dist, epi_ok & ep_ok[None, :])
    matched = best_d <= hamming.TH_LOW

    # rotation consistency
    j2 = best_j.clamp(0, n2 - 1)
    matched = hamming.rotation_consistency_mask(kp1.angle, kp2.angle[j2], matched)

    # --- triangulate all matches ---------------------------------------
    uv2 = kp2.xy[j2]
    p1 = tri.projection_matrix(k, tcw1)
    p2 = tri.projection_matrix(k, tcw2)
    pts_dlt = tri.triangulate_dlt(p1[None], p2[None], kp1.xy, uv2)

    # parallax between rays; for keypoints with depth, a direct
    # unprojection replaces near-parallel rays
    pcos = tri.parallax_cos(c1, c2, pts_dlt)
    pts_depth1 = se3.apply(se3.inverse(tcw1), cam.backproject(kp1.xy, depth1))
    has_d1 = depth1 > 0
    low_parallax = pcos > 0.9998
    pts = torch.where((low_parallax & has_d1)[:, None], pts_depth1, pts_dlt)
    usable = torch.where(low_parallax, has_d1, True)
    usable = usable & (pcos > 0) & (pcos < 0.99999)

    # cheirality + reprojection both views
    sigma2_1 = scale_factor ** (2.0 * kp1.octave.to(torch.float32))
    e1, z1 = tri.reprojection_error_sq(k, tcw1, pts, kp1.xy)
    e2, z2 = tri.reprojection_error_sq(k, tcw2, pts, uv2)
    geo_ok = (z1 > 0) & (z2 > 0) & (e1 <= 5.991 * sigma2_1) \
        & (e2 <= 5.991 * sigma2_2[j2])

    # scale consistency (LocalMapping.cc:455-480)
    d1 = torch.linalg.norm(pts - c1[None], dim=-1)
    d2 = torch.linalg.norm(pts - c2[None], dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_octave = scale_factor ** (kp1.octave - kp2.octave[j2]).to(torch.float32)
    ratio_factor = 1.5 * scale_factor
    scale_ok = (ratio_dist < ratio_octave * ratio_factor) & \
        (ratio_dist * ratio_factor > ratio_octave)

    # minimum baseline, per point (the reference's baseline/medianDepth)
    baseline_ok = baseline > 0.01 * torch.minimum(d1, d2)

    ok = matched & usable & geo_ok & scale_ok & baseline_ok & (d1 > 1e-6) & (d2 > 1e-6)
    # one kp2 can serve only one kp1: resolve by descriptor distance
    sel = torch.where(ok, best_j, -1)
    assoc2 = match.resolve_conflicts(
        sel, torch.where(ok, best_d, hamming.INVALID_DIST), n2)
    won = (sel >= 0) & (assoc2[sel.clamp(0, n2 - 1)]
                        == torch.arange(kp1.n, device=dev))
    return TriangulationResult(kp2_idx=torch.where(won, sel, -1), points=pts)


class BatchedTriangulation(NamedTuple):
    """Survivors compacted across neighbours into one flat list in
    (neighbour, slot) order, padded with -1 to `out_cap` rows."""
    nb_slot: torch.Tensor   # [G] neighbour batch index (-1 = pad)
    idx1: torch.Tensor      # [G] kp index in KF1 (-1 = pad)
    kp2_idx: torch.Tensor   # [G] matched kp index in the neighbour
    points: torch.Tensor    # [G, 3] world points


def triangulate_neighbors(
    kf: int,                      # keyframe row
    free1: torch.Tensor,          # [N] keypoint of kf has no map point yet
    nb_ids: Sequence[int],        # [B] neighbour rows, host values
    free2: torch.Tensor,          # [B, N]
    kf_pose_all: torch.Tensor,    # [K, 4, 4]
    kf_xy: torch.Tensor,          # [K, N, 2] device keyframe store
    kf_desc: torch.Tensor,
    kf_octave: torch.Tensor,
    kf_angle: torch.Tensor,
    kf_valid: torch.Tensor,
    kf_ur: torch.Tensor,
    kf_depth: torch.Tensor,
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    out_cap: int = 512,
) -> BatchedTriangulation:
    """CreateNewMapPoints' epipolar matching + triangulation against all
    neighbour keyframes, survivors compacted to `out_cap` rows across them.

    The neighbours run one after the other. Each pair builds dense [N, N]
    epipolar and Hamming matrices (16 MB each at N = 2000); a batch of all
    twelve neighbours would hold about 0.4 GB of temporaries to save a few
    hundred launches of the mapping thread, whose time is its host work. The
    JAX package maps over the neighbours sequentially for the same reason.
    """
    n = kf_xy.shape[1]
    dev = kf_xy.device
    kp1 = keyframe_keypoints(kf, kf_xy, kf_desc, kf_octave, kf_angle, kf_valid)
    tcw1 = kf_pose_all[kf]
    kp2i_all = torch.full((len(nb_ids), n), -1, dtype=torch.int64, device=dev)
    pts_all = torch.zeros((len(nb_ids), n, 3), dtype=torch.float32, device=dev)
    for b, nb in enumerate(nb_ids):
        kp2 = keyframe_keypoints(nb, kf_xy, kf_desc, kf_octave, kf_angle, kf_valid)
        res = triangulate_pair(
            tcw1, kp1, free1, kf_ur[kf], kf_depth[kf],
            kf_pose_all[nb], kp2, free2[b], kf_ur[nb], kf_depth[nb],
            cam, scale_factor, n_levels)
        kp2i_all[b] = res.kp2_idx
        pts_all[b] = res.points

    # winners from all neighbours in (neighbour, slot) order: the host apply's
    # first-wins dedup depends on this order
    flat = torch.nonzero(kp2i_all.reshape(-1) >= 0).squeeze(1)[:out_cap]
    g = flat.shape[0]
    nb_slot = torch.full((out_cap,), -1, dtype=torch.int64, device=dev)
    idx1 = torch.full((out_cap,), -1, dtype=torch.int64, device=dev)
    kp2i = torch.full((out_cap,), -1, dtype=torch.int64, device=dev)
    pts = torch.zeros((out_cap, 3), dtype=torch.float32, device=dev)
    nb_slot[:g] = flat // n
    idx1[:g] = flat % n
    kp2i[:g] = kp2i_all.reshape(-1)[flat]
    pts[:g] = pts_all.reshape(-1, 3)[flat]
    return BatchedTriangulation(nb_slot=nb_slot, idx1=idx1, kp2_idx=kp2i, points=pts)


def _pairwise_epipolar(xy1: torch.Tensor, xy2: torch.Tensor,
                       f12: torch.Tensor) -> torch.Tensor:
    """[N1, N2] squared distance of each kp2 from the epipolar line of kp1
    (line in image 2: l2 = x1^T F12)."""
    x1h = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=1)   # [N1, 3]
    lines = x1h @ f12                                            # [N1, 3] (a, b, c)
    num = (lines[:, None, 0] * xy2[None, :, 0]
           + lines[:, None, 1] * xy2[None, :, 1]
           + lines[:, None, 2])
    den = lines[:, 0] ** 2 + lines[:, 1] ** 2
    return num * num / torch.clamp(den[:, None], min=1e-12)
