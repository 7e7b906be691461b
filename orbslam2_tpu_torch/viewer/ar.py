"""Augmented-reality overlay: plane detection and a virtual cube.

Counterpart of ``orbslam2_tpu/viewer/ar.py``, the equivalent of the
reference MonoAR demo's ViewerAR (Examples/ROS/ORB_SLAM2/src/AR/
ViewerAR.cc): RANSAC a dominant plane through the currently tracked map
points (ViewerAR::DetectPlane, the same seeded numpy draw as the JAX
package) and draw a virtual cube anchored to it, projected with the live
camera pose each frame through ``geometry/camera.py``. Drawing is headless
(``viewer/raster.py`` lines into the frame) instead of an OpenGL window.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from orbslam2_tpu_torch.viewer import raster


@dataclasses.dataclass
class Plane:
    normal: np.ndarray      # [3] unit, world frame
    origin: np.ndarray      # [3] a point on the plane (inlier centroid)
    t_pw: np.ndarray        # [4, 4] world->plane (plane z = normal)
    inliers: np.ndarray     # [N] bool mask over the input points
    n_inliers: int


def detect_plane(points: np.ndarray, iters: int = 50,
                 threshold: float = 0.02, min_inliers: int = 30,
                 seed: int = 0) -> Optional[Plane]:
    """RANSAC 3-point plane fit over tracked map points
    (ViewerAR::DetectPlane semantics: 50 iterations, distance gate,
    refit on the consensus set). threshold is in world units."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n < max(min_inliers, 3):
        return None
    rng = np.random.default_rng(seed)
    best_mask = None
    best_count = 0
    for _ in range(iters):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = pts[idx]
        nrm = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(nrm)
        if norm < 1e-12:
            continue
        nrm = nrm / norm
        d = np.abs((pts - p0) @ nrm)
        mask = d < threshold
        c = int(mask.sum())
        if c > best_count:
            best_count, best_mask = c, mask
    if best_mask is None or best_count < min_inliers:
        return None
    # least-squares refit on the consensus set
    inl = pts[best_mask]
    centroid = inl.mean(axis=0)
    u, s, vt = np.linalg.svd(inl - centroid, full_matrices=False)
    normal = vt[-1]
    # orient the normal toward the world origin side consistently
    if normal[1] > 0:  # y-down camera convention: floor normal points up (-y)
        normal = -normal
    d = np.abs((pts - centroid) @ normal)
    mask = d < threshold
    # plane frame: z = normal, x/y spanning the plane
    z = normal
    x = np.cross(np.array([0.0, 1.0, 0.0]) if abs(z[1]) < 0.9 else
                 np.array([1.0, 0.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    r_wp = np.stack([x, y, z], axis=1)  # plane->world rotation
    t_pw = np.eye(4)
    t_pw[:3, :3] = r_wp.T
    t_pw[:3, 3] = -r_wp.T @ centroid
    return Plane(normal=normal.astype(np.float32),
                 origin=centroid.astype(np.float32),
                 t_pw=t_pw.astype(np.float32),
                 inliers=mask, n_inliers=int(mask.sum()))


def _bgr(gray: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(gray.astype(np.uint8), cv2.COLOR_GRAY2BGR)``."""
    return np.repeat(gray.astype(np.uint8)[:, :, None], 3, axis=2)


_CUBE_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
               (4, 5), (5, 6), (6, 7), (7, 4),
               (0, 4), (1, 5), (2, 6), (3, 7)]


def cube_corners(size: float) -> np.ndarray:
    """[8, 3] cube corners in the plane frame, sitting on the plane
    (z in [0, size], the reference draws the cube on top of the plane)."""
    s = size / 2.0
    base = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]])
    top = base + np.array([0, 0, size])
    return np.concatenate([base, top]).astype(np.float32)


def draw_cube(image: np.ndarray, tcw: np.ndarray, cam, plane: Plane,
              size: float = 0.2, color=(0, 255, 0),
              thickness: int = 2) -> np.ndarray:
    """Project the plane-anchored cube with the current camera pose and
    draw its wireframe into `image` (grayscale or BGR). Returns BGR."""
    img = _bgr(image) if image.ndim == 2 else image.astype(np.uint8).copy()
    t_wp = np.linalg.inv(plane.t_pw)
    corners_w = cube_corners(size) @ t_wp[:3, :3].T + t_wp[:3, 3]
    pc = corners_w @ np.asarray(tcw)[:3, :3].T + np.asarray(tcw)[:3, 3]
    if (pc[:, 2] <= 0.05).any():
        return img  # cube behind the camera: skip (the reference culls too)
    uv, _ = cam.project(torch.from_numpy(pc.astype(np.float32)))
    uv = uv.numpy().astype(int)
    h, w = img.shape[:2]
    for a, b in _CUBE_EDGES:
        raster.line(img, np.clip(uv[a], [0, 0], [w - 1, h - 1]),
                    np.clip(uv[b], [0, 0], [w - 1, h - 1]), color, thickness)
    return img


class ARViewer:
    """Per-frame AR loop: once tracking is OK, detect a plane through the
    tracked points and keep overlaying the anchored cube
    (ViewerAR::Run's insert-cube behavior, headless)."""

    def __init__(self, system, cube_size: float = 0.2,
                 plane_threshold: float = 0.02, min_inliers: int = 30):
        self.system = system
        self.cube_size = cube_size
        self.plane_threshold = plane_threshold
        self.min_inliers = min_inliers
        self.plane: Optional[Plane] = None

    def update(self, gray: np.ndarray) -> np.ndarray:
        tr = self.system.tracker
        if tr.last_frame is None or tr.state.name != "OK":
            return _bgr(gray)
        if self.plane is None:
            pids = self.system.get_tracked_points()
            if len(pids) >= self.min_inliers:
                pts = self.system.map.pt_pos[pids]
                self.plane = detect_plane(
                    pts, threshold=self.plane_threshold,
                    min_inliers=self.min_inliers)
        if self.plane is None:
            return _bgr(gray)
        return draw_cube(gray, tr.last_frame.tcw, self.system.cfg.cam,
                         self.plane, size=self.cube_size)
