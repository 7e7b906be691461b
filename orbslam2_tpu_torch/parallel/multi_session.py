"""Batched multi-camera tracking: B sessions stepped together on one card.

Counterpart of ``orbslam2_tpu/parallel/multi_session.py``, which runs
``vmap(track_step)`` over the sessions under ``shard_map``. The per-frame
step of a session is ORB extraction -> local-map projection matching ->
robust pose LM; sessions share nothing, every one has its own image and its
own slice of a local map, all of one static shape.

Here the B images are extracted in one batched frame build
(``ORBExtractor.extract_batch_with_pyramid``): the pyramids and FAST
selection image by image, then the orientation and descriptors of all B x L
levels in ceil(B * L / 16) launches of the fused kernel. Matching and the
pose LM then run session by session; the pose LM reads its convergence flag
every step (``backend/pose_opt.py``), so a batched LM is work for later.
The outputs equal ``make_single_camera_step``'s session by session.
"""
from __future__ import annotations

from typing import Tuple

import torch

from orbslam2_tpu_torch import resolve_device
from orbslam2_tpu_torch.backend import pose_opt
from orbslam2_tpu_torch.frontend import kernels
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig, Keypoints, ORBExtractor

# the descriptor distance of the session step's local-map search
MAX_HAMMING = 100


def _track_keypoints(kp: Keypoints, tcw0, pt_pos, pt_desc, pt_valid, pt_normal,
                     pt_min_dist, pt_max_dist, cam: PinholeCamera, orb_cfg: ORBConfig,
                     local_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step after extraction for one session: search the local map from
    ``tcw0``, then the pose LM on the matches. -> (tcw [4, 4], n_inliers)."""
    _, res = kernels.search_local_points(
        tcw0, pt_pos, pt_desc, pt_valid, pt_normal, pt_min_dist, pt_max_dist, kp,
        torch.zeros((kp.n,), dtype=torch.bool, device=kp.xy.device), 1.0, cam,
        orb_cfg.scale_factor, orb_cfg.n_levels, MAX_HAMMING)
    matched = res.assoc >= 0
    pos = pt_pos[torch.clamp(res.assoc, 0, local_cap - 1)]
    obs = kernels.build_pose_obs_from_frame(
        kp, torch.full((kp.n,), -1.0, device=kp.xy.device), pos, matched,
        orb_cfg.scale_factor)
    tcw, _, n_in = pose_opt.pose_optimization(tcw0, obs, cam)
    return tcw, n_in


def make_single_camera_step(cam: PinholeCamera, orb_cfg: ORBConfig, local_cap: int,
                            device="cuda"):
    """-> fn(image [H, W], tcw0 [4, 4], pt_pos [C, 3], pt_desc [C, 8] int32,
    pt_valid [C], pt_normal [C, 3], pt_min [C], pt_max [C]) -> (tcw [4, 4],
    n_inliers): one session's step, its image in a launch of its own (the
    port's twin of ``__graft_entry__.entry``'s step)."""
    extractor = ORBExtractor(orb_cfg, (cam.height, cam.width), device)

    def step(image, tcw0, *local_map):
        kp, _ = extractor.extract_with_pyramid(image)
        return _track_keypoints(kp, tcw0, *local_map, cam, orb_cfg, local_cap)

    return step


def make_multi_camera_step(cam: PinholeCamera, orb_cfg: ORBConfig, local_cap: int,
                           device="cuda"):
    """-> fn(images [B, H, W], tcw0 [B, 4, 4], pt_pos [B, C, 3], pt_desc
    [B, C, 8] int32 bit-views, pt_valid [B, C], pt_normal [B, C, 3], pt_min
    [B, C], pt_max [B, C]) -> (tcw [B, 4, 4], n_inliers [B]), every tensor on
    ``device``."""
    device = resolve_device(device)
    extractor = ORBExtractor(orb_cfg, (cam.height, cam.width), device)

    def step(images, tcw0, pt_pos, pt_desc, pt_valid, pt_normal, pt_min, pt_max):
        built = extractor.extract_batch_with_pyramid(images)
        out = [_track_keypoints(kp, tcw0[s], pt_pos[s], pt_desc[s], pt_valid[s],
                                pt_normal[s], pt_min[s], pt_max[s], cam, orb_cfg, local_cap)
               for s, (kp, _) in enumerate(built)]
        return (torch.stack([tcw for tcw, _ in out]),
                torch.stack([n_in for _, n_in in out]))

    return step
