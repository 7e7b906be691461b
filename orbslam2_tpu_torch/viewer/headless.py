"""Headless visualization: frame overlays and map renders to images.

Counterpart of ``orbslam2_tpu/viewer/headless.py``, the functional role of
the reference's Pangolin Viewer, FrameDrawer and MapDrawer without a GUI
loop: the current frame with its tracked keypoints and a status bar, the map
(points, keyframe frusta, covisibility graph, trajectory) as a top-down or a
perspective image, and a viewer that writes them to a directory.

The JAX package draws with cv2; the card's machine has no OpenCV, so these
draw with ``viewer/raster.py`` (numpy; the same pixels as cv2 for
one-pixel lines, filled circles and rectangles) and write PNG through
``io/png.py``. Images are BGR uint8, as there.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from orbslam2_tpu_torch.io import png
from orbslam2_tpu_torch.slammap import covisibility
from orbslam2_tpu_torch.slammap.point_stats import camera_centers
from orbslam2_tpu_torch.viewer import raster

STATUS_BAR_ROWS = 20


def draw_frame(gray: np.ndarray, frame, state_name: str,
               n_kfs: int = 0, n_pts: int = 0) -> np.ndarray:
    """FrameDrawer::DrawFrame analogue: tracked map points as green boxes,
    a status bar at the bottom (FrameDrawer.cc:45-160)."""
    img = raster.to_bgr(gray)
    if frame is None:
        return img
    hk = frame.host_kp()
    tracked = (frame.pt_ids >= 0) & ~frame.is_outlier & hk.valid
    c = np.round(hk.xy[tracked]).astype(np.int64)
    raster.rectangles(img, c - 3, c + 3, (0, 255, 0))
    raster.fill_circles(img, c, 1, (0, 255, 0))
    bar = np.zeros((STATUS_BAR_ROWS, img.shape[1], 3), np.uint8)
    raster.text(bar, f"{state_name} | matches: {len(c)} | KFs: {n_kfs} | MPs: {n_pts}",
                (5, 14), (255, 255, 255))
    return np.concatenate([img, bar], axis=0)


def draw_map_topdown(m, trajectory_twc: Optional[np.ndarray] = None,
                     size: int = 640, axes=(0, 2)) -> np.ndarray:
    """MapDrawer analogue: orthographic projection of map points (grey),
    keyframe positions (blue), spanning-tree edges (green), loop edges
    (red), trajectory (dark red). `axes` selects the ground plane (x, z
    default)."""
    img = np.full((size, size, 3), 255, np.uint8)
    ax = list(axes)
    pts = m.pt_pos[m.pt_valid]
    kf_ids = m.keyframe_ids()
    centers = camera_centers(m.kf_pose)
    groups = [pts[:, ax]] if len(pts) else []
    if len(kf_ids):
        groups.append(centers[kf_ids][:, ax])
    if trajectory_twc is not None and len(trajectory_twc):
        groups.append(trajectory_twc[:, ax, 3])
    if not groups:
        return img
    allp = np.concatenate(groups)
    lo = allp.min(axis=0) - 0.5
    hi = allp.max(axis=0) + 0.5
    span = max(float((hi - lo).max()), 1e-6)

    def to_px(p):
        """[..., 2] -> [..., 2] integer pixels (x right, y up)."""
        q = ((np.asarray(p) - lo) / span * (size - 20) + 10).astype(np.int64)
        return np.stack([q[..., 0], size - q[..., 1]], axis=-1)

    raster.fill_circles(img, to_px(pts[:, ax]), 1, (60, 60, 60))
    if len(kf_ids):
        for k in kf_ids:
            par = m.kf_parent[k]
            if par >= 0 and m.kf_valid[par]:
                raster.line(img, to_px(centers[k][ax]), to_px(centers[par][ax]), (0, 180, 0))
            for e in m.kf_loop_edges[k]:
                if m.kf_valid[e]:
                    raster.line(img, to_px(centers[k][ax]), to_px(centers[e][ax]),
                                (0, 0, 255), 2)
        raster.fill_circles(img, to_px(centers[kf_ids][:, ax]), 3, (200, 80, 0))
    if trajectory_twc is not None and len(trajectory_twc):
        traj = to_px(trajectory_twc[:, ax, 3])
        for a, b in zip(traj[:-1], traj[1:]):
            raster.line(img, a, b, (0, 0, 200))
    return img


@dataclasses.dataclass
class ViewNav:
    """Interactive map-view state, the analogue of the reference viewer's
    Pangolin camera interaction (Follow Camera toggle, mouse orbit, zoom and
    pan; Viewer.cc:116-196). Changed by LiveViewer's key and mouse handlers;
    read by draw_map_3d."""
    elev_deg: float = 35.0
    azim_deg: float = -30.0
    zoom: float = 1.0            # view distance multiplier (wheel / +-)
    pan: tuple = (0.0, 0.0)      # screen-space offset, fraction of radius
    follow: bool = False         # centre and scale on the current camera
    topdown: bool = False        # 2D top-down instead of the 3D scene
    # the reference viewer's menu checkboxes (Viewer.cc:69-72)
    show_points: bool = True
    show_keyframes: bool = True
    show_graph: bool = True

    def reset(self):
        self.elev_deg, self.azim_deg = 35.0, -30.0
        self.zoom, self.pan = 1.0, (0.0, 0.0)


def draw_map_3d(m, trajectory_twc: Optional[np.ndarray] = None,
                cur_tcw: Optional[np.ndarray] = None, size: int = 640,
                elev_deg: float = 35.0, azim_deg: float = -30.0,
                covis_w: Optional[np.ndarray] = None,
                nav: Optional[ViewNav] = None) -> np.ndarray:
    """Perspective map view, the reference MapDrawer's GL scene
    (MapDrawer.cc:93-256) without a GL context: keyframe frusta (blue wire
    pyramids), spanning-tree and strong covisibility edges (green), loop
    edges (red), map points (grey), trajectory (dark red) and the current
    camera as a larger green frustum. A virtual pinhole orbits the map
    centroid at the given elevation and azimuth."""
    img = np.full((size, size, 3), 255, np.uint8)
    pts = m.pt_pos[m.pt_valid]
    kf_ids = m.keyframe_ids()
    centers = camera_centers(m.kf_pose)
    groups = [pts] if len(pts) else []
    if len(kf_ids):
        groups.append(centers[kf_ids])
    if trajectory_twc is not None and len(trajectory_twc):
        groups.append(trajectory_twc[:, :3, 3])
    if not groups:
        return img
    allp = np.concatenate(groups)
    ctr = allp.mean(axis=0)
    radius = max(float(np.linalg.norm(allp - ctr, axis=1).max()), 1e-3)

    zoom = 1.0
    if nav is not None:
        elev_deg, azim_deg, zoom = nav.elev_deg, nav.azim_deg, nav.zoom
        if nav.follow and cur_tcw is not None:
            # Follow Camera (Viewer.cc:160-166): the view tracks the
            # current camera at a local scale
            ctr = np.linalg.inv(cur_tcw)[:3, 3]
            radius = max(0.25 * radius, 1e-3)

    # the virtual view: orbit the (possibly followed) centre
    el, az = np.deg2rad(elev_deg), np.deg2rad(azim_deg)
    eye = ctr + 2.6 * radius * zoom * np.array(
        [np.cos(el) * np.sin(az), -np.sin(el), -np.cos(el) * np.cos(az)])
    fwd = ctr - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
    right /= max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    if nav is not None and nav.pan != (0.0, 0.0):
        # pan: slide the eye in the view plane
        eye = eye + (nav.pan[0] * right + nav.pan[1] * down) * radius
    r_vc = np.stack([right, down, fwd])         # world -> view rotation
    t_vc = -r_vc @ eye
    f = 0.9 * size

    def project(p):
        """[N, 3] world -> ([N, 2] px, [N] in-front mask)."""
        pc = p @ r_vc.T + t_vc
        z = np.maximum(pc[:, 2], 1e-6)
        uv = np.stack([f * pc[:, 0] / z + size / 2, f * pc[:, 1] / z + size / 2], axis=1)
        return uv, pc[:, 2] > 1e-3

    def line(a_uv, b_uv, ok, color, th=1):
        if ok:
            raster.line(img, (int(a_uv[0]), int(a_uv[1])), (int(b_uv[0]), int(b_uv[1])),
                        color, th)

    show_points = nav is None or nav.show_points
    show_kfs = nav is None or nav.show_keyframes
    show_graph = nav is None or nav.show_graph
    if len(pts) and show_points:
        uv, vis = project(pts)
        p = uv[vis].astype(int)
        inb = (p[:, 0] >= 0) & (p[:, 0] < size) & (p[:, 1] >= 0) & (p[:, 1] < size)
        img[p[inb, 1], p[inb, 0]] = (60, 60, 60)

    # frustum template in camera-local coordinates (MapDrawer.cc:100-129)
    def frustum_lines(twc, w):
        h, zf = 0.75 * w, 0.6 * w
        loc = np.array([[0, 0, 0], [w, h, zf], [w, -h, zf], [-w, -h, zf], [-w, h, zf]])
        uv, vis = project(loc @ twc[:3, :3].T + twc[:3, 3])
        segs = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
        return [(uv[a], uv[b], bool(vis[a] & vis[b])) for a, b in segs]

    w_frustum = 0.04 * radius
    if len(kf_ids) and (show_graph or show_kfs):
        c_uv, c_vis = project(centers)
        if show_graph:
            wmat = covis_w if covis_w is not None else covisibility.weight_matrix(m)
            for k in kf_ids:
                par = m.kf_parent[k]
                if par >= 0 and m.kf_valid[par]:
                    line(c_uv[k], c_uv[par], c_vis[k] & c_vis[par], (0, 180, 0))
                for nb in np.where(wmat[k] >= covisibility.ESSENTIAL_THRESHOLD)[0]:
                    if nb > k and m.kf_valid[nb]:
                        line(c_uv[k], c_uv[nb], c_vis[k] & c_vis[nb], (0, 180, 0))
                for e in m.kf_loop_edges[k]:
                    if m.kf_valid[e]:
                        line(c_uv[k], c_uv[e], c_vis[k] & c_vis[e], (0, 0, 255), 2)
        if show_kfs:
            for twc in np.linalg.inv(m.kf_pose[kf_ids]):
                for a, b, ok in frustum_lines(twc, w_frustum):
                    line(a, b, ok, (200, 80, 0))
    if trajectory_twc is not None and len(trajectory_twc) > 1:
        t_uv, t_vis = project(trajectory_twc[:, :3, 3])
        for i in range(len(t_uv) - 1):
            line(t_uv[i], t_uv[i + 1], t_vis[i] & t_vis[i + 1], (0, 0, 200))
    if cur_tcw is not None:
        for a, b, ok in frustum_lines(np.linalg.inv(cur_tcw), 1.6 * w_frustum):
            line(a, b, ok, (0, 200, 0), 2)
    return img


class HeadlessViewer:
    """Viewer::Run analogue for offline use: a per-frame overlay and a
    periodic map render, written as PNG into a directory."""

    def __init__(self, system, out_dir: Optional[str] = None, map_every: int = 30):
        self.system = system
        self.out_dir = out_dir
        self.map_every = map_every
        self.n = 0
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)

    def update(self, gray: np.ndarray) -> np.ndarray:
        tr = self.system.tracker
        img = draw_frame(gray, tr.last_frame, tr.state.name,
                         self.system.map.n_keyframes(), self.system.map.n_points())
        if self.out_dir is not None:
            png.imwrite(os.path.join(self.out_dir, f"frame_{self.n:06d}.png"), img)
            if self.n % self.map_every == 0:
                png.imwrite(os.path.join(self.out_dir, f"map_{self.n:06d}.png"),
                            draw_map_topdown(self.system.map, tr.full_trajectory_twc()))
        self.n += 1
        return img
