"""Device-side steps of the tracking front-end.

Counterpart of ``orbslam2_tpu/frontend/kernels.py`` (the parts RGB-D tracking
and local mapping need). Each function is shape-static (fixed point/keypoint
capacities, masked) and works on tensors of one device. Together they replace
the scalar per-point loops of the reference's SearchLocalPoints,
isInFrustum, the SearchByProjection family and Fuse.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import se3, sim3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops import hamming, match
from orbslam2_tpu_torch.ops.orb import Keypoints
from orbslam2_tpu_torch.backend import pose_opt
from orbslam2_tpu_torch.utils import fixed_order, graph_capture


class FrustumInfo(NamedTuple):
    visible: torch.Tensor     # [C] bool passes all frustum gates
    uv: torch.Tensor          # [C, 2] projection
    pred_level: torch.Tensor  # [C] int32 predicted octave
    view_cos: torch.Tensor    # [C]


def _in_image(uv: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """Gate against the *undistorted* image rectangle: keypoint coords are
    undistorted, so on distorted cameras valid projections can land outside
    [0, width)."""
    min_x, max_x, min_y, max_y = cam.undistorted_bounds()
    return ((uv[..., 0] >= min_x) & (uv[..., 0] < max_x)
            & (uv[..., 1] >= min_y) & (uv[..., 1] < max_y))


def frustum_check(
    tcw: torch.Tensor,
    pt_pos: torch.Tensor,       # [C, 3]
    pt_valid: torch.Tensor,     # [C]
    pt_normal: torch.Tensor,    # [C, 3]
    pt_min_dist: torch.Tensor,  # [C]
    pt_max_dist: torch.Tensor,  # [C]
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    view_cos_limit: float = 0.5,
) -> FrustumInfo:
    """Frame::isInFrustum for all candidate points at once: positive depth,
    inside image, distance within scale band, viewing angle < 60 deg.
    With a session axis (tcw [B, 4, 4], points [B, C, ...]) the sums run in
    ``fixed_order``, so a session's bits do not depend on B."""
    if tcw.dim() == 2:
        pc = se3.apply(tcw, pt_pos)
        rays = pt_pos - se3.camera_center(tcw)[None, :]
        dist = torch.linalg.norm(rays, dim=-1)
        along = torch.sum(rays * pt_normal, dim=-1)
    else:
        pc = fixed_order.apply(tcw, pt_pos)
        rays = pt_pos - fixed_order.camera_center(tcw)[..., None, :]
        dist = torch.sqrt(fixed_order.dot(rays, rays))
        along = fixed_order.dot(rays, pt_normal)
    uv, z = cam.project(pc)
    in_band = (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    view_cos = along / torch.clamp(dist, min=1e-9)
    pred_level = match.predict_scale_level(dist, pt_max_dist, scale_factor, n_levels)
    visible = pt_valid & (z > 0.05) & _in_image(uv, cam) & in_band \
        & (view_cos > view_cos_limit)
    return FrustumInfo(visible=visible, uv=uv, pred_level=pred_level, view_cos=view_cos)


def search_local_points(
    tcw: torch.Tensor,
    pt_pos: torch.Tensor,
    pt_desc: torch.Tensor,
    pt_valid: torch.Tensor,
    pt_normal: torch.Tensor,
    pt_min_dist: torch.Tensor,
    pt_max_dist: torch.Tensor,
    kp: Keypoints,
    kp_taken: torch.Tensor,  # [N] bool keypoints already associated
    radius_mult: float,      # `th` in the reference (1 normally, larger post-reloc)
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    max_hamming: int = hamming.TH_HIGH,
):
    """Project local map points and match to free keypoints.

    Radius per point: 2.5 px if viewed head-on (viewCos > 0.998) else 4.0,
    scaled by the predicted octave and `radius_mult`. Takes a leading
    session axis on every tensor, as ``frustum_check`` does.
    -> (FrustumInfo, WindowedMatches over the full candidate array).
    """
    info = frustum_check(tcw, pt_pos, pt_valid, pt_normal, pt_min_dist, pt_max_dist,
                         cam, scale_factor, n_levels)
    base_r = torch.where(info.view_cos > 0.998, 2.5, 4.0)
    radius = base_r * radius_mult * scale_factor ** info.pred_level.to(torch.float32)
    res = match.windowed_match(
        info.uv, pt_desc, info.visible, radius,
        torch.clamp(info.pred_level - 1, min=0), info.pred_level,
        kp, max_dist=max_hamming, ratio=0.8,
        kp_free=~kp_taken,
    )
    return info, res


def search_local_points_gathered(
    tcw: torch.Tensor,
    ids: torch.Tensor,           # [C] int64 rows into the full device map
    sel_valid: torch.Tensor,     # [C] bool candidate mask (local selection)
    pt_pos_all: torch.Tensor,    # [P, 3] full device-resident map tensors
    pt_desc_all: torch.Tensor,
    pt_valid_all: torch.Tensor,
    pt_normal_all: torch.Tensor,
    pt_min_all: torch.Tensor,
    pt_max_all: torch.Tensor,
    kp: Keypoints,
    kp_taken: torch.Tensor,
    radius_mult: float,
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    max_hamming: int = hamming.TH_HIGH,
):
    """search_local_points reading straight from the device-resident map
    mirror (slammap/device_map): the host ships only the local-point id
    list."""
    return search_local_points(
        tcw, pt_pos_all[ids], pt_desc_all[ids], pt_valid_all[ids] & sel_valid,
        pt_normal_all[ids], pt_min_all[ids], pt_max_all[ids],
        kp, kp_taken, radius_mult, cam, scale_factor, n_levels, max_hamming)


def search_by_projection_last(
    tcw_pred: torch.Tensor,
    last_pt_pos: torch.Tensor,    # [N, 3] world pos of last frame's points
    last_pt_valid: torch.Tensor,  # [N]
    last_desc: torch.Tensor,      # [N, 8] descriptors (last frame keypoints)
    last_octave: torch.Tensor,    # [N]
    last_angle: torch.Tensor,     # [N]
    kp: Keypoints,
    radius_px: float,
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    max_hamming: int = hamming.TH_HIGH,
) -> match.WindowedMatches:
    """Motion-model tracking search: project last frame's map points with
    the predicted pose; window scaled by the last observation's octave;
    octave window +-1; rotation-consistency filter."""
    pc = se3.apply(tcw_pred, last_pt_pos)
    uv, z = cam.project(pc)
    visible = last_pt_valid & (z > 0.05) & _in_image(uv, cam)
    radius = radius_px * scale_factor ** last_octave.to(torch.float32)
    res = match.windowed_match(
        uv, last_desc, visible, radius,
        torch.clamp(last_octave - 1, min=0),
        torch.clamp(last_octave + 1, max=n_levels - 1),
        kp, max_dist=max_hamming,
    )
    # rotation-consistency: compare matched keypoint angles
    matched = res.best_kp >= 0
    kp_angle = kp.angle[res.best_kp.clamp(0, kp.n - 1)]
    keep = hamming.rotation_consistency_mask(last_angle, kp_angle, matched)
    best_kp = torch.where(keep, res.best_kp, -1)
    assoc = match.resolve_conflicts(best_kp, res.best_dist, kp.n)
    return res._replace(best_kp=best_kp, assoc=assoc)


def search_by_descriptor(
    q_desc: torch.Tensor,     # [Q, 8] query descriptors (e.g. ref-KF keypoints)
    q_valid: torch.Tensor,    # [Q]
    q_angle: torch.Tensor,    # [Q]
    kp: Keypoints,
    cam: PinholeCamera,
    max_hamming: int = hamming.TH_LOW,
    ratio: float = 0.7,
):
    """Global (vocabulary-free) descriptor match: the dense-matrix equivalent
    of ORBmatcher::SearchByBoW. Ratio test + rotation consistency.
    -> (best_kp [Q], best_dist [Q])."""
    dist = hamming.distance_matrix(q_desc, kp.desc, q_valid, kp.valid)
    best_j, best_d, second_d = hamming.best_and_second(dist)
    ok = (best_d <= max_hamming) & (
        best_d.to(torch.float32) <= ratio * second_d.to(torch.float32))
    kp_angle = kp.angle[best_j.clamp(0, kp.n - 1)]
    keep = hamming.rotation_consistency_mask(q_angle, kp_angle, ok)
    best_kp = torch.where(keep, best_j, -1)
    best_dist = torch.where(keep, best_d, hamming.INVALID_DIST)
    assoc = match.resolve_conflicts(best_kp, best_dist, kp.n)
    q = q_desc.shape[0]
    won = (best_kp >= 0) & (assoc[best_kp.clamp(0, kp.n - 1)]
                            == torch.arange(q, device=best_kp.device))
    return torch.where(won, best_kp, -1), best_dist


def search_by_sim3_dir(
    s_dst_src: torch.Tensor,    # [4, 4] Sim3 mapping src-camera -> dst-camera
    t_src_w: torch.Tensor,      # [4, 4] src keyframe pose (world -> camera)
    pt_pos: torch.Tensor,       # [P, 3] world positions (src KF's map points)
    pt_desc: torch.Tensor,      # [P, 8]
    pt_valid: torch.Tensor,     # [P]
    pt_min_dist: torch.Tensor,  # [P]
    pt_max_dist: torch.Tensor,  # [P]
    kp_dst: Keypoints,
    radius_th: float,
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    max_hamming: int = hamming.TH_HIGH,
) -> torch.Tensor:
    """One direction of ORBmatcher::SearchBySim3: project one keyframe's map
    points through the candidate Sim3 into the other's image and take the
    best descriptor match within th*scale^pred; no view-angle gate and no
    ratio test (the two directions' mutual agreement replaces them).
    -> [P] best dst keypoint per point, -1 = none."""
    p_dst = sim3.apply(s_dst_src, se3.apply(t_src_w, pt_pos))
    uv, z = cam.project(p_dst)
    dist = torch.linalg.norm(p_dst, dim=-1)
    in_band = (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    pred = match.predict_scale_level(dist, pt_max_dist, scale_factor, n_levels)
    radius = radius_th * scale_factor ** pred.to(torch.float32)
    res = match.windowed_match(
        uv, pt_desc, pt_valid & (z > 0.0) & _in_image(uv, cam) & in_band, radius,
        torch.clamp(pred - 1, min=0), pred, kp_dst, max_dist=max_hamming)
    return res.best_kp


def keyframe_keypoints(row: int, kf_xy, kf_desc, kf_octave, kf_angle,
                       kf_valid) -> Keypoints:
    """Keypoints view of one keyframe row of the device keyframe store. The
    fields are views of the store's rows: read, never written."""
    n = kf_xy.shape[1]
    dev = kf_xy.device
    return Keypoints(
        xy=kf_xy[row], response=torch.zeros(n, device=dev), angle=kf_angle[row],
        octave=kf_octave[row], size=torch.ones(n, device=dev), desc=kf_desc[row],
        valid=kf_valid[row])


def fuse_targets(
    target_ids,                    # [T] keyframe rows, host values
    kf_pose_all: torch.Tensor,     # [K, 4, 4] device keyframe poses
    kf_xy: torch.Tensor,           # [K, N, 2] device keyframe store
    kf_desc: torch.Tensor,
    kf_octave: torch.Tensor,
    kf_angle: torch.Tensor,
    kf_valid: torch.Tensor,
    ids: torch.Tensor,             # [C] candidate point rows into the mirror
    sel_valid: torch.Tensor,       # [T, C] per-target candidate mask (forward
                                   # and backward fuse share one call: each
                                   # target sees only its own candidate set)
    pt_pos_all: torch.Tensor,
    pt_desc_all: torch.Tensor,
    pt_valid_all: torch.Tensor,
    pt_normal_all: torch.Tensor,
    pt_min_all: torch.Tensor,
    pt_max_all: torch.Tensor,
    radius_mult: float,
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    max_hamming: int = 50,
) -> torch.Tensor:
    """ORBmatcher::Fuse against T keyframes (LocalMapping::SearchInNeighbors
    projects the keyframe's points into ~20 neighbours). Candidate points and
    keyframe features are gathered on the device from the resident mirror and
    store. -> assoc [T, N] int32: keypoint -> candidate row, -1 = none.

    The targets run one after the other: each materialises a [C, N] distance
    matrix (33 MB at C = 4096, N = 2000), so all T at once would hold close
    to 1 GB to save launches on the mapping thread."""
    n = kf_xy.shape[1]
    ids = ids.long()
    out = torch.full((len(target_ids), n), -1, dtype=torch.int32, device=kf_xy.device)
    no_prior = torch.zeros(n, dtype=torch.bool, device=kf_xy.device)
    for i, t in enumerate(target_ids):
        kp = keyframe_keypoints(t, kf_xy, kf_desc, kf_octave, kf_angle, kf_valid)
        _, res = search_local_points_gathered(
            kf_pose_all[t], ids, sel_valid[i], pt_pos_all, pt_desc_all,
            pt_valid_all, pt_normal_all, pt_min_all, pt_max_all,
            kp, no_prior, radius_mult, cam, scale_factor, n_levels, max_hamming)
        out[i] = res.assoc.to(torch.int32)
    return out


class TrackStepResult(NamedTuple):
    """Fused search+optimize step outputs."""
    tcw: torch.Tensor        # [4, 4] optimized pose
    n_inliers: torch.Tensor  # [] int32
    inlier: torch.Tensor     # [N] bool per keypoint slot
    assoc: torch.Tensor      # [N] keypoint -> candidate row (-1 = none)
    n_matches: torch.Tensor  # [] matches fed to the optimizer
    visible: torch.Tensor    # [C] bool candidate passed the frustum gates


def _search_last_widening(tcw_pred, last_pos, last_valid, last_desc,
                          last_octave, last_angle, kp, cam, scale_factor,
                          n_levels, host_branch=None) -> torch.Tensor:
    """Projection search at radius 15, repeated at 30 when fewer than 20
    matches came back (the reference's 2*th retry). With ``host_branch`` the
    count is read on the host, one synchronisation a frame, and the second
    search runs only when it is needed; without it both searches run and the
    count selects on the device, as the JAX package's ``lax.cond``. None
    takes ``pose_opt.host_may_read``. -> assoc [N]."""
    def search(radius):
        return search_by_projection_last(
            tcw_pred, last_pos, last_valid, last_desc, last_octave,
            last_angle, kp, radius, cam, scale_factor, n_levels).assoc

    assoc = search(15.0)
    n15 = (assoc >= 0).sum()
    if host_branch is None:
        host_branch = pose_opt.host_may_read(assoc)
    if host_branch:
        return search(30.0) if int(n15) < 20 else assoc
    return torch.where(n15 < 20, search(30.0), assoc)


def motion_model_step(
    tcw_pred: torch.Tensor,
    last_pt_pos: torch.Tensor,    # [N, 3] world pos per last-frame slot
    last_pt_valid: torch.Tensor,  # [N]
    last_desc: torch.Tensor,
    last_octave: torch.Tensor,
    last_angle: torch.Tensor,
    kp: Keypoints,
    frame_ur: torch.Tensor,
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    host_reads=None,
) -> TrackStepResult:
    """TrackWithMotionModel's device work: projection search at radius 15,
    conditional widen to 30, observation staging, and robust pose LM.
    ``host_reads`` as in ``_fused_track_core``: False is the capture form
    (the widening selected on the device, every LM step run)."""
    assoc = _search_last_widening(
        tcw_pred, last_pt_pos, last_pt_valid, last_desc, last_octave,
        last_angle, kp, cam, scale_factor, n_levels, host_reads)
    matched = assoc >= 0
    pos_kp = last_pt_pos[assoc.clamp(0, last_pt_pos.shape[0] - 1)]
    obs = build_pose_obs_from_frame(kp, frame_ur, pos_kp, matched, scale_factor)
    tcw, inlier, n_in = pose_opt.pose_optimization(tcw_pred, obs, cam, stop_early=host_reads)
    return TrackStepResult(
        tcw=tcw, n_inliers=n_in, inlier=inlier, assoc=assoc,
        n_matches=matched.sum(),
        visible=torch.zeros((1,), dtype=torch.bool, device=assoc.device))


def local_map_step(
    tcw: torch.Tensor,
    ids: torch.Tensor,            # [C] rows into the device map mirror
    sel_valid: torch.Tensor,      # [C] candidate mask
    pt_pos_all: torch.Tensor,
    pt_desc_all: torch.Tensor,
    pt_valid_all: torch.Tensor,
    pt_normal_all: torch.Tensor,
    pt_min_all: torch.Tensor,
    pt_max_all: torch.Tensor,
    kp: Keypoints,
    frame_ur: torch.Tensor,
    prior_pos: torch.Tensor,      # [N, 3] world pos for already-matched slots
    prior_mask: torch.Tensor,     # [N] bool slot already has an association
    radius_mult,                  # a number or a 0-d float32 tensor
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    host_reads=None,
) -> TrackStepResult:
    """TrackLocalMap's device work: gathered local-point projection search +
    merged observation staging + the frame's second pose optimization.
    ``host_reads`` as in ``motion_model_step``."""
    info, res = search_local_points_gathered(
        tcw, ids, sel_valid, pt_pos_all, pt_desc_all, pt_valid_all,
        pt_normal_all, pt_min_all, pt_max_all, kp, prior_mask,
        radius_mult, cam, scale_factor, n_levels)
    assoc = res.assoc
    newly = assoc >= 0
    cand_pos = pt_pos_all[ids][assoc.clamp(0, ids.shape[0] - 1)]
    pos = torch.where(newly[:, None], cand_pos, prior_pos)
    used = prior_mask | newly
    obs = build_pose_obs_from_frame(kp, frame_ur, pos, used, scale_factor)
    tcw_new, inlier, n_in = pose_opt.pose_optimization(tcw, obs, cam, stop_early=host_reads)
    return TrackStepResult(
        tcw=tcw_new, n_inliers=n_in, inlier=inlier, assoc=assoc,
        n_matches=used.sum(), visible=info.visible)


@dataclasses.dataclass
class FusedFrameOut:
    """Outputs of the fused whole-frame step.

    `kp/ur/depth` stay on the device (the Frame's tensors + next frame's
    motion-model carry); everything else is the compact host fetch."""
    kp: Keypoints
    ur: torch.Tensor          # [N]
    depth: torch.Tensor       # [N]
    tcw: torch.Tensor         # [4, 4] pose after the local-map optimization
    pt_ids: torch.Tensor      # [N] int64 final map-point id per keypoint (-1 = none)
    is_outlier: torch.Tensor  # [N] associated but chi2-rejected
    visible: torch.Tensor     # [C] local candidate passed the frustum gates
    mm_matches: torch.Tensor  # [] motion-model matches (widened if needed)
    mm_inliers: torch.Tensor  # [] motion-model pose inliers
    n_inliers: torch.Tensor   # [] final (local-map) pose inliers


def _fused_track_core(kp, ur, depth, tcw_pred, last_kp, last_pid,
                      local_ids, local_sel, radius_mult,
                      pt_pos, pt_desc, pt_valid, pt_normal, pt_min, pt_max,
                      cam, scale_factor, n_levels, host_reads=None) -> FusedFrameOut:
    """Motion-model search + pose opt + local-map search + second pose opt
    on the freshly built frame — the device side of one whole tracked frame.

    ``host_reads`` (None: ``pose_opt.host_may_read``) picks the eager form,
    which reads the widening's match count and the LM's convergence flags
    on the host, or the capture form, which reads nothing back and gives
    the same outputs.

    - last frame's map-point positions are gathered from the resident
      mirror via `last_pid` (the carry is one [N] integer tensor);
    - the local candidate list `local_ids` is the HOST's selection from the
      PREVIOUS frame (one-frame lag): covisibility changes per keyframe
      event, not per frame. The host refreshes the list after each frame.
    """
    p_cap = pt_pos.shape[0]
    last_pid = last_pid.long()
    local_ids = local_ids.long()

    # --- motion-model search (radius 15 -> widen 30) + first pose opt ---
    last_safe = last_pid.clamp(0, p_cap - 1)
    last_pos = pt_pos[last_safe]
    last_valid = (last_pid >= 0) & pt_valid[last_safe]
    assoc = _search_last_widening(
        tcw_pred, last_pos, last_valid, last_kp.desc, last_kp.octave,
        last_kp.angle, kp, cam, scale_factor, n_levels, host_reads)
    matched = assoc >= 0
    n_last = last_pid.shape[0]
    pid_mm = torch.where(matched, last_pid[assoc.clamp(0, n_last - 1)], -1)
    pos_mm = pt_pos[pid_mm.clamp(0, p_cap - 1)]
    obs1 = build_pose_obs_from_frame(kp, ur, pos_mm, matched, scale_factor)
    tcw1, inlier1, n_in1 = pose_opt.pose_optimization(
        tcw_pred, obs1, cam, stop_early=host_reads)
    mm_matches = matched.sum()
    # outlier associations are dropped before the local-map stage
    pid1 = torch.where(matched & inlier1, pid_mm, -1)

    # --- local-map search + second pose opt ---------------------------
    # [P+1] taken-mask by scatter; slot P collects the unassociated slots
    taken = torch.zeros(p_cap + 1, dtype=torch.bool, device=pt_pos.device)
    taken.index_fill_(0, torch.where(pid1 >= 0, pid1, p_cap), True)
    sel = local_sel & ~taken[local_ids]
    prior_mask = pid1 >= 0
    info, res2 = search_local_points_gathered(
        tcw1, local_ids, sel, pt_pos, pt_desc, pt_valid, pt_normal,
        pt_min, pt_max, kp, prior_mask, radius_mult, cam,
        scale_factor, n_levels)
    newly = res2.assoc >= 0
    c_cap = local_ids.shape[0]
    pid2 = torch.where(newly, local_ids[res2.assoc.clamp(0, c_cap - 1)], pid1)
    used = pid2 >= 0
    pos2 = pt_pos[pid2.clamp(0, p_cap - 1)]
    obs2 = build_pose_obs_from_frame(kp, ur, pos2, used, scale_factor)
    tcw2, inlier2, n_in2 = pose_opt.pose_optimization(
        tcw1, obs2, cam, stop_early=host_reads)
    is_outlier = used & ~inlier2
    pid_final = torch.where(used & inlier2, pid2, -1)
    return FusedFrameOut(
        kp=kp, ur=ur, depth=depth, tcw=tcw2, pt_ids=pid_final,
        is_outlier=is_outlier, visible=info.visible,
        mm_matches=mm_matches, mm_inliers=n_in1, n_inliers=n_in2)


def _resolve_pred(tcw_pred) -> torch.Tensor:
    """The motion-model prediction, given as a [4, 4] pose or as a
    ``(velocity, tcw_prev)`` pair composed here, on the tensors' device, in
    float32. The pair lets a pipelined tracker chain a frame off the previous
    step's pose while that pose is still on the device and not fetched."""
    if isinstance(tcw_pred, tuple):
        vel, tcw_prev = tcw_pred
        return vel @ tcw_prev
    return tcw_pred


_KP_FIELDS = tuple(f.name for f in dataclasses.fields(Keypoints))


def _kp_tensors(kp: Keypoints) -> list:
    return [getattr(kp, f) for f in _KP_FIELDS]


def _kp_of(tensors) -> Keypoints:
    """Keypoints of its fields' tensors, in ``_KP_FIELDS``' order."""
    return Keypoints(**dict(zip(_KP_FIELDS, tensors)))


def _out_tensors(out: FusedFrameOut) -> dict:
    """The tensors of a FusedFrameOut by name, the keypoints' as ``kp.<field>``."""
    fields = {f"kp.{f}": getattr(out.kp, f) for f in _KP_FIELDS}
    fields.update((f.name, getattr(out, f.name)) for f in dataclasses.fields(out)
                  if f.name != "kp")
    return fields


def _clone_out(out: FusedFrameOut) -> FusedFrameOut:
    kp = _kp_of([x.clone() for x in _kp_tensors(out.kp)])
    return dataclasses.replace(out, kp=kp, **{
        f.name: getattr(out, f.name).clone() for f in dataclasses.fields(out) if f.name != "kp"})


@dataclasses.dataclass
class _Captured:
    """One captured graph: its input and output buffers, the describe
    launches one replay makes, and the tensors last copied in."""
    graph: "torch.cuda.CUDAGraph"
    inputs: list
    outputs: object
    describe_launches: int
    sources: list


class StepProgram:
    """A step as one program, as ``jax.jit`` makes one XLA program of it.

    On the CPU a call is the eager step. On a card the first call for a key
    (the inputs' shapes and dtypes, and what the subclass adds) runs the
    step in its capture form (no host read) on a side stream of the
    program's own, returns those outputs and captures the same step into a
    ``torch.cuda.CUDAGraph`` there (through ``graph_capture.capture``);
    every later call copies its inputs into the graph's buffers on the
    current stream, replays the graph there and returns copies of its
    outputs, which a later replay leaves alone. The last ``n_mirror`` inputs
    are the map mirror's tensors, which a sync replaces and never writes in
    place: a replay copies them only when they are not the tensors last
    copied in. A new key captures a new graph, as ``jax.jit`` traces again.
    A graph's buffers are not reentrant: one caller owns a program. A
    capture or a replay that fails raises; nothing falls back to the eager
    step. ``release()`` frees the graphs once their last replay has run
    (``graph_capture.release``); the next call captures again.

    ``made_for`` holds the constructor's arguments (a deep copy of a program
    is a new program made for the same, with no graph; ``program_for``
    replaces a program made for something else). ``captures`` counts the
    graphs captured, ``capture_ms`` keeps each capture's milliseconds, and
    ``replays`` counts the replays; each replay adds the describe launches
    it holds to ``cuda_orb.fused_orient_describe.launches``, which no wrapper
    call counts inside a graph.

    A subclass gives ``_step(inputs, extra)``, the step's capture form on
    the flat list of input tensors, and ``_tensors(out)`` and
    ``_clone(out)`` for its outputs."""

    n_mirror = 0

    def __init__(self, *made_for):
        self.made_for = made_for
        self._graphs: dict = {}
        self._stream = None
        self._done = None       # recorded behind the last replay
        self.captures = 0
        self.capture_ms: list = []
        self.replays = 0

    def __deepcopy__(self, memo):
        return type(self)(*self.made_for)

    def release(self) -> None:
        """Free the program's graphs after their last replay."""
        graphs, self._graphs = self._graphs, {}
        graph_capture.release([c.graph for c in graphs.values()], self._done)
        self._done = None

    def _program(self, flat: list, extra=()):
        """The step through its graph for these inputs (on a card)."""
        key = (extra,) + tuple((tuple(x.shape), x.dtype) for x in flat)
        with torch.cuda.device(flat[0].device):
            captured = self._graphs.get(key)
            if captured is None:
                return self._capture(key, flat, extra)
            return self._replay(captured, flat)

    def _capture(self, key, flat, extra):
        from orbslam2_tpu_torch.ops import cuda_orb

        inputs = [x.clone() for x in flat]
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        side, current = self._stream, torch.cuda.current_stream()
        # warm-up on the capture stream (library handles and workspaces are
        # made outside the capture): the call's own outputs
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._step(inputs, extra)
        current.wait_stream(side)
        for t in self._tensors(out):
            t.record_stream(current)
        counted = cuda_orb.fused_orient_describe.launches
        captured = {}

        def step():
            captured["outputs"] = self._step(inputs, extra)

        # thread_local: the mapping worker goes on queueing work on its own
        # stream while this thread captures
        graphs, _, ms = graph_capture.capture({"step": step}, side)
        held = cuda_orb.fused_orient_describe.launches - counted
        cuda_orb.fused_orient_describe.launches = counted   # a capture runs nothing
        self._graphs[key] = _Captured(graphs["step"], inputs, captured["outputs"], held,
                                      list(flat))
        self.captures += 1
        self.capture_ms.append(ms)
        return out

    def _copy_in(self, captured: _Captured, flat: list) -> None:
        n_copy = len(flat) - self.n_mirror
        for i, (dst, src) in enumerate(zip(captured.inputs, flat)):
            if i < n_copy or src is not captured.sources[i]:
                dst.copy_(src)

    def _replay(self, captured: _Captured, flat: list):
        from orbslam2_tpu_torch.ops import cuda_orb

        self._copy_in(captured, flat)
        captured.sources = list(flat)
        captured.graph.replay()
        if self._done is None:
            self._done = torch.cuda.Event()
        self._done.record()
        self.replays += 1
        cuda_orb.fused_orient_describe.launches += captured.describe_launches
        return self._clone(captured.outputs)


def program_for(programs: dict, name, make, *made_for) -> StepProgram:
    """``programs[name]`` when it was made for ``made_for``; else a new
    ``make(*made_for)`` put there, the program it replaces released first
    (its graphs hold the old extractor's and camera's constants)."""
    prog = programs.get(name)
    if prog is None or prog.made_for != made_for:
        if prog is not None:
            prog.release()
        prog = programs[name] = make(*made_for)
    return prog


def _radius_tensor(radius_mult, dev) -> torch.Tensor:
    """A search radius multiplier as a 0-d float32 tensor on ``dev``: an
    input of a graph, not a constant of it."""
    if isinstance(radius_mult, torch.Tensor):
        return radius_mult.to(device=dev, dtype=torch.float32)
    return torch.full((), float(radius_mult), dtype=torch.float32, device=dev)


class FrameProgram(StepProgram):
    """The fused whole-frame step of one sensor as one program
    (``StepProgram``): the counterpart of the JAX package's jitted
    ``_fused_*_program``.

    Called with the images, then the arguments of ``_fused_track_core``
    after the frame's own (``tcw_pred`` a pose or a ``(velocity, tcw_prev)``
    pair, ``last_kp``, ``last_pid``, ``local_ids``, ``local_sel``,
    ``radius_mult``, the six mirror tensors). On the CPU a call is the eager
    step (``run``). Each tracker owns its programs (``fused_frame_step(...,
    programs=)``). A replay holds one describe launch."""

    n_mirror = 6

    def __init__(self, kind, extractor, cam, scale_factor, n_levels):
        super().__init__(kind, extractor, cam, scale_factor, n_levels)
        self.kind = kind
        self.n_images = 1 if kind == "mono" else 2
        self.extractor, self.cam = extractor, cam
        self.scale_factor, self.n_levels = scale_factor, n_levels

    def run(self, *args, host_reads=None) -> FusedFrameOut:
        """The step, eagerly: frame build, then `_fused_track_core`."""
        from orbslam2_tpu_torch.frontend import frame as frame_mod

        imgs, (tcw_pred, *rest) = args[:self.n_images], args[self.n_images:]
        kp, ur, depth = frame_mod.BUILDS[self.kind](self.extractor, self.cam, *imgs)
        return _fused_track_core(
            kp, ur, depth, _resolve_pred(tcw_pred), *rest, self.cam,
            self.scale_factor, self.n_levels, host_reads=host_reads)

    def __call__(self, *args) -> FusedFrameOut:
        if args[0].device.type != "cuda":
            return self.run(*args)
        flat, pair = self._flatten(args)
        return self._program(flat, pair)

    def _flatten(self, args):
        """-> (the inputs as one list of tensors, ids as int64 and the
        radius as a 0-d float32 tensor; whether the prediction is a pair)."""
        n = self.n_images
        tcw_pred, last_kp, last_pid, local_ids, local_sel, radius_mult, *pt = args[n:]
        pair = isinstance(tcw_pred, tuple)
        pred = list(tcw_pred) if pair else [tcw_pred]
        return [*args[:n], *pred, *_kp_tensors(last_kp), last_pid.long(), local_ids.long(),
                local_sel, _radius_tensor(radius_mult, args[0].device), *pt], pair

    def _unflatten(self, flat, pair):
        i = self.n_images
        pred = (flat[i], flat[i + 1]) if pair else flat[i]
        i += 2 if pair else 1
        kp = _kp_of(flat[i:i + len(_KP_FIELDS)])
        return (*flat[:self.n_images], pred, kp, *flat[i + len(_KP_FIELDS):])

    def _step(self, inputs, pair) -> FusedFrameOut:
        return self.run(*self._unflatten(inputs, pair), host_reads=False)

    def _tensors(self, out: FusedFrameOut):
        return _out_tensors(out).values()

    def _clone(self, out: FusedFrameOut) -> FusedFrameOut:
        return _clone_out(out)


def _fused_rgbd_program(extractor, cam, scale_factor, n_levels) -> FrameProgram:
    return FrameProgram("rgbd", extractor, cam, scale_factor, n_levels)


def _fused_stereo_program(extractor, cam, scale_factor, n_levels) -> FrameProgram:
    return FrameProgram("stereo", extractor, cam, scale_factor, n_levels)


def _fused_mono_program(extractor, cam, scale_factor, n_levels) -> FrameProgram:
    return FrameProgram("mono", extractor, cam, scale_factor, n_levels)


def fused_frame_step(sensor_images, extractor, cam, scale_factor, n_levels,
                     *args, programs=None) -> FusedFrameOut:
    """The fused whole-frame step for the sensor's image tuple, through the
    sensor's program. `sensor_images` is ``("rgbd", (gray, depth))``,
    ``("stereo", (left, right))`` or ``("mono", (gray,))``; a monocular frame
    has no depth, so its keypoints enter both pose optimizations as
    monocular observations (uR = depth = -1). `args`: ``tcw_pred`` (a pose or
    a ``(velocity, tcw_prev)`` pair, `_resolve_pred`) and the rest of
    `_fused_track_core`'s arguments after the frame's own. `programs`: the
    caller's programs by sensor, filled here (a tracker keeps one;
    ``program_for``); without it a call makes a program of its own, which on
    a card captures a graph it never replays."""
    kind, imgs = sensor_images
    programs = {} if programs is None else programs
    prog = program_for(programs, kind, FrameProgram, kind, extractor, cam, scale_factor,
                       n_levels)
    return prog(*imgs, *args)


class _TrackStepProgram(StepProgram):
    """A classic-path tracking step (``step_name``, a function of this
    module) as one program: the counterpart of the JAX package's jitted
    step of that name. Called with the step's arguments up to ``cam`` ->
    TrackStepResult. On the CPU a call is the eager step, the module's
    function looked up at each call; on a card one CUDA graph of its
    capture form (``host_reads=False``). A replay holds no describe launch.
    The tracker owns one of each (``Tracker.classic_programs``)."""

    step_name = ""

    def __init__(self, cam, scale_factor, n_levels):
        super().__init__(cam, scale_factor, n_levels)
        self.cam, self.scale_factor, self.n_levels = cam, scale_factor, n_levels

    def run(self, *args, host_reads=None) -> TrackStepResult:
        """The step, eagerly (``host_reads`` as the step takes it)."""
        return globals()[self.step_name](*args, self.cam, self.scale_factor, self.n_levels,
                                         host_reads=host_reads)

    def __call__(self, *args) -> TrackStepResult:
        if args[0].device.type != "cuda":
            return self.run(*args)
        return self._program(self._flatten(args))

    def _step(self, inputs, extra) -> TrackStepResult:
        return self.run(*self._unflatten(inputs), host_reads=False)

    def _tensors(self, out: TrackStepResult):
        return out

    def _clone(self, out: TrackStepResult) -> TrackStepResult:
        return TrackStepResult(*(t.clone() for t in out))


class MotionModelProgram(_TrackStepProgram):
    """``motion_model_step`` as one program (the JAX package's jitted
    ``motion_model_step``): the widening selected on the device, as its
    ``lax.cond``, and every LM step run."""

    step_name = "motion_model_step"

    def _flatten(self, args) -> list:
        *head, kp, frame_ur = args
        return [*head, *_kp_tensors(kp), frame_ur]

    def _unflatten(self, flat) -> tuple:
        return (*flat[:6], _kp_of(flat[6:-1]), flat[-1])


class LocalMapProgram(_TrackStepProgram):
    """``local_map_step`` as one program (the JAX package's jitted
    ``local_map_step``): every LM step run, the radius multiplier a 0-d
    input, the six mirror tensors copied in only when the mirror replaced
    them."""

    step_name = "local_map_step"
    n_mirror = 6

    def _flatten(self, args) -> list:
        tcw, ids, sel_valid, *rest = args
        mirror, (kp, frame_ur, prior_pos, prior_mask, radius_mult) = rest[:6], rest[6:]
        return [tcw, ids.long(), sel_valid, *_kp_tensors(kp), frame_ur, prior_pos,
                prior_mask, _radius_tensor(radius_mult, tcw.device), *mirror]

    def _unflatten(self, flat) -> tuple:
        k = 3 + len(_KP_FIELDS)
        return (*flat[:3], *flat[-6:], _kp_of(flat[3:k]), *flat[k:k + 4])


def build_pose_obs_from_frame(
    frame_kp: Keypoints,
    frame_ur: torch.Tensor,
    matched_pt_pos: torch.Tensor,   # [N, 3] world position per keypoint slot
    matched_valid: torch.Tensor,    # [N] bool keypoint has a map point
    scale_factor: float = 1.2,
) -> pose_opt.PoseObs:
    """Assemble the pose-optimization observation set from per-keypoint
    associations (stereo rows where uR >= 0); takes a leading session
    axis."""
    uv3 = torch.cat([frame_kp.xy, frame_ur[..., None]], dim=-1)
    inv_sigma2 = (1.0 / scale_factor ** 2) ** frame_kp.octave.to(torch.float32)
    return pose_opt.PoseObs(
        pts_w=matched_pt_pos,
        uv=uv3,
        inv_sigma2=inv_sigma2,
        is_stereo=frame_ur >= 0,
        valid=matched_valid & frame_kp.valid,
    )
