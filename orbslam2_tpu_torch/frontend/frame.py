"""Per-frame container: ORB features + undistorted coords + depth.

Counterpart of ``orbslam2_tpu/frontend/frame.py`` (RGB-D, stereo and monocular): fixed-capacity
masked tensors on the tracker's device for the matching and pose steps, numpy
for host bookkeeping.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops.orb import Keypoints, ORBExtractor
from orbslam2_tpu_torch.ops.stereo import match_stereo


@dataclasses.dataclass
class HostKeypoints:
    """Numpy copies of a frame's device tensors, fetched once per frame."""
    xy: np.ndarray
    octave: np.ndarray
    angle: np.ndarray
    response: np.ndarray
    desc: np.ndarray      # uint32
    valid: np.ndarray
    ur: np.ndarray
    depth: np.ndarray


@dataclasses.dataclass
class Frame:
    """One processed input frame. Device tensors for the matching and pose
    steps, numpy for host bookkeeping."""
    frame_id: int
    timestamp: float
    kp: Keypoints            # xy = undistorted level-0 coords
    ur: torch.Tensor         # [N] virtual right-image u (<0: mono / no depth)
    depth: torch.Tensor      # [N] keypoint depth (<0: unknown)
    tcw: np.ndarray          # [4, 4] float32 pose estimate (world->cam)
    pt_ids: np.ndarray       # [N] int32 map-point id per keypoint (-1 = none)
    is_outlier: np.ndarray   # [N] bool pose-opt outlier flag
    _host: Optional[HostKeypoints] = None
    _host_depth: Optional[tuple] = None

    @property
    def n(self) -> int:
        return self.kp.n

    def host_depth_ur(self):
        """-> (depth [N], ur [N]) numpy, cached (the per-frame keyframe
        decision reads depth)."""
        if self._host is not None:
            return self._host.depth, self._host.ur
        if self._host_depth is None:
            both = torch.stack([self.depth, self.ur]).cpu().numpy()
            self._host_depth = (both[0], both[1])
        return self._host_depth

    def host_kp(self) -> HostKeypoints:
        """Full keypoint fetch (keyframe creation / init / reloc), cached.
        Floats travel as one tensor, integers as another."""
        if self._host is None:
            kp = self.kp
            f = torch.cat([kp.xy, kp.angle[:, None], kp.response[:, None],
                           self.ur[:, None], self.depth[:, None]], dim=1
                          ).cpu().numpy()
            i = torch.cat([kp.desc, kp.octave[:, None].to(torch.int32),
                           kp.valid[:, None].to(torch.int32)], dim=1
                          ).cpu().numpy()
            self._host = HostKeypoints(
                xy=np.ascontiguousarray(f[:, 0:2]), angle=f[:, 2].copy(),
                response=f[:, 3].copy(), ur=f[:, 4].copy(), depth=f[:, 5].copy(),
                desc=np.ascontiguousarray(i[:, 0:8]).view(np.uint32),
                octave=i[:, 8].copy(), valid=i[:, 9].astype(bool))
        return self._host


def _rgbd_build(extractor: ORBExtractor, cam: PinholeCamera,
                gray: torch.Tensor, depth_img: torch.Tensor):
    """RGB-D frame build: ORB extraction, keypoint undistortion, depth
    sampling, and virtual-right synthesis uR = u - bf/d. Shared by the
    standalone frame build and the fused whole-frame step
    (frontend/kernels.fused_frame_step)."""
    kp = extractor(gray)
    und_xy = cam.undistort_points(kp.xy)
    # depth lookup at raw (distorted) keypoint coords
    xs = torch.round(kp.xy[:, 0]).long().clamp(0, cam.width - 1)
    ys = torch.round(kp.xy[:, 1]).long().clamp(0, cam.height - 1)
    d = depth_img[ys, xs]
    has_depth = (d > 0) & kp.valid
    neg = torch.full_like(d, -1.0)
    ur = torch.where(has_depth,
                     und_xy[:, 0] - cam.bf / torch.where(d > 0, d, torch.ones_like(d)),
                     neg)
    return kp.replace(xy=und_xy), ur, torch.where(has_depth, d, neg)


def build_frame_rgbd(
    frame_id: int,
    timestamp: float,
    gray,
    depth_img,
    extractor: ORBExtractor,
    cam: PinholeCamera,
) -> Frame:
    """RGB-D frame on the extractor's device; images may be numpy arrays or
    tensors."""
    dev = extractor.device
    kp, ur, depth = _rgbd_build(
        extractor, cam,
        torch.as_tensor(gray, dtype=torch.float32).to(dev),
        torch.as_tensor(depth_img, dtype=torch.float32).to(dev))
    n = kp.n
    return Frame(
        frame_id=frame_id,
        timestamp=timestamp,
        kp=kp,
        ur=ur,
        depth=depth,
        tcw=np.eye(4, dtype=np.float32),
        pt_ids=np.full(n, -1, np.int32),
        is_outlier=np.zeros(n, bool),
    )


def _stereo_build(extractor: ORBExtractor, cam: PinholeCamera,
                  gl: torch.Tensor, gr: torch.Tensor):
    """Stereo frame build: extract both images (one kernel launch for both
    images' levels), match left to right on the extractor's blurred
    pyramids, then undistort the left keypoints. Shared by the standalone
    frame build and the fused whole-frame step. -> (kp with undistorted xy,
    ur, depth)."""
    (kp_l, pyr_l), (kp_r, pyr_r) = extractor.extract_pair_with_pyramid(gl, gr)
    ur, depth = match_stereo(kp_l, kp_r, pyr_l, pyr_r, cam, extractor.config.scale_factor,
                             level_budgets=extractor.level_budgets)
    return kp_l.replace(xy=cam.undistort_points(kp_l.xy)), ur, depth


def build_frame_stereo(
    frame_id: int,
    timestamp: float,
    gray_left,
    gray_right,
    extractor: ORBExtractor,
    cam: PinholeCamera,
) -> Frame:
    """Stereo frame on the extractor's device; images may be numpy arrays or
    tensors."""
    dev = extractor.device
    kp, ur, depth = _stereo_build(
        extractor, cam,
        torch.as_tensor(gray_left, dtype=torch.float32).to(dev),
        torch.as_tensor(gray_right, dtype=torch.float32).to(dev))
    n = kp.n
    return Frame(
        frame_id=frame_id,
        timestamp=timestamp,
        kp=kp,
        ur=ur,
        depth=depth,
        tcw=np.eye(4, dtype=np.float32),
        pt_ids=np.full(n, -1, np.int32),
        is_outlier=np.zeros(n, bool),
    )


def _mono_build(extractor: ORBExtractor, cam: PinholeCamera, gray: torch.Tensor):
    """Monocular frame build: ORB extraction (one describe launch) and
    keypoint undistortion; no keypoint has a depth or a right coordinate.
    Shared by the standalone frame build and the fused whole-frame step.
    -> (kp with undistorted xy, ur, depth), the last two all -1."""
    kp = extractor(gray)
    neg = torch.full((kp.n,), -1.0, dtype=torch.float32, device=kp.xy.device)
    return kp.replace(xy=cam.undistort_points(kp.xy)), neg, neg


def build_frame_mono(
    frame_id: int,
    timestamp: float,
    gray,
    extractor: ORBExtractor,
    cam: PinholeCamera,
) -> Frame:
    """Monocular frame on the extractor's device; the image may be a numpy
    array or a tensor."""
    kp, ur, depth = _mono_build(
        extractor, cam, torch.as_tensor(gray, dtype=torch.float32).to(extractor.device))
    n = kp.n
    return Frame(
        frame_id=frame_id,
        timestamp=timestamp,
        kp=kp,
        ur=ur,
        depth=depth,
        tcw=np.eye(4, dtype=np.float32),
        pt_ids=np.full(n, -1, np.int32),
        is_outlier=np.zeros(n, bool),
    )
