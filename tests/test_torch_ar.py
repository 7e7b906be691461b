"""The port's AR overlay and the AR driver on the CPU: ``detect_plane``'s
plane and inliers and the cube's drawing held exactly to the JAX package's
on the same inputs (both are numpy), and the main of
``examples/ar_demo.py`` at small size (the ROS-style nodes and the live
driver are in test_torch_ros_ar.py).
"""
import os

import cv2
import numpy as np
import pytest

from orbslam2_tpu.viewer import ar as jar
from orbslam2_tpu_torch.examples import ar_demo
from orbslam2_tpu_torch.viewer import ar

from test_torch_ros_ar import CAM


def _floor(seed, n=200, outliers=60):
    """test_ros_ar.py's plane z = 2 + 0.1x - 0.2y with noise and outliers."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    pts = np.stack([x, y, 2 + 0.1 * x - 0.2 * y + rng.normal(0, 0.003, n)], axis=1)
    pts[:outliers] += rng.uniform(0.3, 1.0, (outliers, 3))
    return pts


@pytest.mark.parametrize("seed,min_inliers", [(0, 50), (1, 50), (2, 30), (3, 190)])
def test_detect_plane_matches_jax(seed, min_inliers):
    pts = _floor(seed)
    got = ar.detect_plane(pts, threshold=0.02, min_inliers=min_inliers, seed=seed)
    want = jar.detect_plane(pts, threshold=0.02, min_inliers=min_inliers, seed=seed)
    if want is None:
        assert got is None
        return
    for f in ("normal", "origin", "t_pw", "inliers"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.n_inliers == want.n_inliers >= 120
    expected = np.array([0.1, -0.2, -1.0]) / np.linalg.norm([0.1, -0.2, -1.0])
    assert abs(float(got.normal @ expected)) > 0.999


def test_draw_cube_matches_jax():
    plane = ar.detect_plane(_floor(0), threshold=0.02, min_inliers=50, seed=1)
    jplane = jar.detect_plane(_floor(0), threshold=0.02, min_inliers=50, seed=1)
    gray = np.random.default_rng(0).uniform(0, 255, (240, 320)).astype(np.float32)
    tcw = np.eye(4, dtype=np.float32)
    tcw[:3, 3] = [0.1, -0.2, 0.5]
    from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
    a = jar.draw_cube(gray, tcw, JCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320,
                                         height=240, bf=26.0), jplane, size=0.3)
    b = ar.draw_cube(gray, tcw, CAM, plane, size=0.3)
    base = np.repeat(gray.astype(np.uint8)[:, :, None], 3, axis=2)
    drawn = (a != base).any(axis=2) | (b != base).any(axis=2)
    assert drawn.sum() > 100
    # two-pixel strokes: viewer/raster.py covers most of cv2's pixels
    assert (a == b).all(axis=2)[drawn].mean() > 0.8


def test_ar_demo_main(tmp_path):
    system, viewer = ar_demo.main(["--frames", "5", "--out", str(tmp_path), "--device", "cpu"])
    assert viewer.plane is not None and viewer.plane.n_inliers >= 30
    files = sorted(os.listdir(tmp_path))
    assert files == [f"ar_{i:04d}.png" for i in range(5)]
    last = cv2.imread(str(tmp_path / files[-1]))
    assert last.shape == (240, 320, 3)
    assert (last == (0, 255, 0)).all(axis=2).sum() > 50     # the cube's green strokes
