"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

Counterpart of ``orbslam2_tpu/io/datasets.py`` (the reference example mains'
loaders: Examples/RGB-D/rgbd_tum.cc LoadImages, Examples/Monocular/
mono_kitti.cc, Examples/Stereo/stereo_euroc.cc), with the same dataset
conventions: TUM associations files, KITTI times.txt + image_0/image_1,
EuRoC timestamp lists + online stereo rectification.

The JAX package reads and converts images with OpenCV; the port needs none:

- PNG files go through the port's own reader (``io/png.py``), which gives
  what ``cv2.imread`` gives;
- ``_to_gray`` is ``cv2.cvtColor``'s uint8 BGR/RGB -> gray, bit for bit:
  ``(3735 B + 19235 G + 9798 R + 2^14) >> 15`` (OpenCV's weights 0.299,
  0.587 rounded to 15 bits, blue taking the remainder);
- ``EurocRectifier`` builds ``cv2.initUndistortRectifyMap``'s maps on the
  host in float64 and remaps on the system's device as ``cv2.remap`` with
  ``INTER_LINEAR`` and ``BORDER_CONSTANT`` does in OpenCV 5.0: the source
  position's integer and fractional parts in float32, two linear blends
  along x and one along y, each a fused multiply-add in float32, rounded
  half to even; a neighbour outside the image counts as 0. (A blend
  rounded twice differs from OpenCV's on about one pixel in a million.)
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch import resolve_device
from orbslam2_tpu_torch.io import png
from orbslam2_tpu_torch.io.settings import read_opencv_yaml


@dataclasses.dataclass
class RGBDItem:
    timestamp: float
    gray: np.ndarray
    depth: np.ndarray


@dataclasses.dataclass
class StereoItem:
    timestamp: float
    left: np.ndarray
    right: np.ndarray


@dataclasses.dataclass
class MonoItem:
    timestamp: float
    gray: np.ndarray


# cv2.cvtColor's uint8 -> gray weights, 15-bit fixed point
_GRAY_R, _GRAY_G, _GRAY_B = 9798, 19235, 3735


def _to_gray(img: np.ndarray, rgb_order: bool = True) -> np.ndarray:
    """Gray [H, W] as is, or a uint8 colour image (3 or 4 channels, RGB(A)
    or, with ``rgb_order=False``, BGR(A)) through ``cv2.cvtColor``'s
    conversion -> float32 [H, W]."""
    if img.ndim == 2:
        return img.astype(np.float32)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"cannot convert a {img.dtype} image of shape {img.shape} to gray")
    c = img.astype(np.int32)
    r, b = (c[..., 0], c[..., 2]) if rgb_order else (c[..., 2], c[..., 0])
    return ((b * _GRAY_B + c[..., 1] * _GRAY_G + r * _GRAY_R + (1 << 14)) >> 15
            ).astype(np.float32)


# ----------------------------------------------------------------------
# TUM RGB-D (rgbd_tum.cc:24-60; associations from associate.py output)
# ----------------------------------------------------------------------
def load_tum_associations(path: str) -> List[Tuple[float, str, str]]:
    """-> [(timestamp, rgb_rel_path, depth_rel_path)]."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1], parts[3]))
    return out


def tum_rgbd_frames(dataset_dir: str, associations_path: str,
                    depth_map_factor: float = 5000.0) -> Iterator[RGBDItem]:
    """Depth in metres (raw / factor), -1 where the raw value is 0; the
    colour image read as OpenCV reads it (BGR) and converted as such."""
    for ts, rgb_rel, depth_rel in load_tum_associations(associations_path):
        rgb = png.imread(os.path.join(dataset_dir, rgb_rel))
        depth = png.imread(os.path.join(dataset_dir, depth_rel))
        if rgb is None or depth is None:
            continue
        d = depth.astype(np.float32) / depth_map_factor
        d[depth == 0] = -1.0
        yield RGBDItem(ts, _to_gray(rgb, rgb_order=False), d)


# ----------------------------------------------------------------------
# KITTI odometry (mono_kitti.cc:126-153, stereo_kitti.cc)
# ----------------------------------------------------------------------
def kitti_timestamps(sequence_dir: str) -> np.ndarray:
    return np.loadtxt(os.path.join(sequence_dir, "times.txt"))


def kitti_mono_frames(sequence_dir: str) -> Iterator[MonoItem]:
    times = kitti_timestamps(sequence_dir)
    img_dir = os.path.join(sequence_dir, "image_0")
    for i, ts in enumerate(times):
        img = png.imread(os.path.join(img_dir, f"{i:06d}.png"), gray=True)
        if img is None:
            break
        yield MonoItem(float(ts), img.astype(np.float32))


def kitti_stereo_frames(sequence_dir: str) -> Iterator[StereoItem]:
    times = kitti_timestamps(sequence_dir)
    for i, ts in enumerate(times):
        l = png.imread(os.path.join(sequence_dir, "image_0", f"{i:06d}.png"), gray=True)
        r = png.imread(os.path.join(sequence_dir, "image_1", f"{i:06d}.png"), gray=True)
        if l is None or r is None:
            break
        yield StereoItem(float(ts), l.astype(np.float32), r.astype(np.float32))


# ----------------------------------------------------------------------
# EuRoC MAV (mono_euroc.cc, stereo_euroc.cc:97-137 online rectification)
# ----------------------------------------------------------------------
def load_euroc_timestamps(path: str) -> List[str]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line.split(",")[0].split(".")[0])
    return out


def init_undistort_rectify_map(k: np.ndarray, d: np.ndarray, r: np.ndarray,
                               p: np.ndarray, size: Tuple[int, int]
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], (width, height),
    CV_32F)``: for every output pixel, the source pixel -> (map_x, map_y)
    float32 [height, width]. The output pixel goes back through (P R)^-1 to
    a ray of the unrectified camera, through the radial-tangential
    distortion (D: k1 k2 p1 p2 [k3]) and K, in float64."""
    d = np.asarray(d, np.float64).reshape(-1)
    if d.size not in (4, 5):
        raise ValueError(f"{d.size} distortion coefficients; 4 or 5 (k1 k2 p1 p2 [k3]) "
                         "are supported")
    k1, k2, p1, p2, k3 = np.pad(d, (0, 5 - d.size))
    k = np.asarray(k, np.float64)
    ir = np.linalg.inv(np.asarray(p, np.float64)[:3, :3] @ np.asarray(r, np.float64))
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xw = u * ir[0, 0] + v * ir[0, 1] + ir[0, 2]
    yw = u * ir[1, 0] + v * ir[1, 1] + ir[1, 2]
    inv_w = 1.0 / (u * ir[2, 0] + v * ir[2, 1] + ir[2, 2])
    x, y = xw * inv_w, yw * inv_w
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    return ((k[0, 0] * xd + k[0, 2]).astype(np.float32),
            (k[1, 1] * yd + k[1, 2]).astype(np.float32))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the product of
    two float32 values is exact in float64, and so is the sum wherever c is
    not far larger than the product (here always: the bilinear blend's
    fractions times grey-level differences, plus a grey level)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


class Remap:
    """``cv2.remap(src, map_x, map_y, INTER_LINEAR)`` (constant border 0) on
    a device, for one pair of float32 maps; the source's neighbour indices,
    their validity and the blend fractions are computed once per source
    shape and kept on the device."""

    def __init__(self, map_x: np.ndarray, map_y: np.ndarray, device):
        self.device = torch.device(device)
        self.map_x = torch.from_numpy(np.ascontiguousarray(map_x, np.float32)).to(self.device)
        self.map_y = torch.from_numpy(np.ascontiguousarray(map_y, np.float32)).to(self.device)
        self._tables: Dict[Tuple[int, int], tuple] = {}

    def _table(self, h: int, w: int):
        if (h, w) not in self._tables:
            fx, fy = torch.floor(self.map_x), torch.floor(self.map_y)
            ax, ay = self.map_x - fx, self.map_y - fy           # exact in float32
            x0, y0 = fx.to(torch.int64), fy.to(torch.int64)
            xs = torch.stack([x0, x0 + 1, x0, x0 + 1])          # p00 p01 p10 p11
            ys = torch.stack([y0, y0, y0 + 1, y0 + 1])
            inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
            flat = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)).reshape(4, -1)
            self._tables[(h, w)] = (flat, inside.reshape(4, -1), ax, ay)
        return self._tables[(h, w)]

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        """[h, w] tensor on the device -> [H, W] of the maps' shape; uint8
        in, uint8 out (rounded half to even), else float32."""
        flat, inside, ax, ay = self._table(*src.shape)
        p = torch.where(inside, src.reshape(-1).to(torch.float32)[flat], 0.0)
        p00, p01, p10, p11 = (q.reshape(ax.shape) for q in p)
        top = _fma(ax, p01 - p00, p00)
        bottom = _fma(ax, p11 - p10, p10)
        out = _fma(ay, bottom - top, top)
        if src.dtype == torch.uint8:
            return torch.round(out).clamp(0, 255).to(torch.uint8)
        return out


class EurocRectifier:
    """Online stereo rectification from the reference's EuRoC settings keys
    (LEFT./RIGHT. K, D, R, P, height, width; Examples/Stereo/EuRoC.yaml:
    35-81), as stereo_euroc.cc does it with cv2.initUndistortRectifyMap and
    cv2.remap. The maps (``map_l``, ``map_r``: (map_x, map_y) numpy float32)
    are built once on the host; the remap runs on ``device``."""

    def __init__(self, settings_path: str, device="cuda"):
        fs = read_opencv_yaml(settings_path)
        self.device = resolve_device(device)
        missing = [f"{s}.{f}" for s in ("LEFT", "RIGHT") for f in "KDRP"
                   if not isinstance(fs.get(f"{s}.{f}"), np.ndarray)]
        missing += [k for k in ("LEFT.width", "LEFT.height")
                    if not isinstance(fs.get(k), (int, float))]
        if missing:
            raise ValueError(f"{settings_path}: no rectification keys {missing}")
        size = (int(fs["LEFT.width"]), int(fs["LEFT.height"]))
        self.map_l = init_undistort_rectify_map(
            fs["LEFT.K"], fs["LEFT.D"], fs["LEFT.R"], fs["LEFT.P"], size)
        self.map_r = init_undistort_rectify_map(
            fs["RIGHT.K"], fs["RIGHT.D"], fs["RIGHT.R"], fs["RIGHT.P"], size)
        self._remap = (Remap(*self.map_l, self.device), Remap(*self.map_r, self.device))

    def __call__(self, left: np.ndarray, right: np.ndarray):
        """Raw pair (numpy, uint8 or float32) -> rectified pair (numpy, of the
        same type)."""
        return tuple(rm(torch.from_numpy(np.ascontiguousarray(img)).to(self.device)).cpu().numpy()
                     for rm, img in zip(self._remap, (left, right)))


def euroc_stereo_frames(data_dir: str, timestamps_path: str,
                        rectifier: Optional[EurocRectifier] = None
                        ) -> Iterator[StereoItem]:
    for ts in load_euroc_timestamps(timestamps_path):
        l = png.imread(os.path.join(data_dir, "cam0", "data", ts + ".png"), gray=True)
        r = png.imread(os.path.join(data_dir, "cam1", "data", ts + ".png"), gray=True)
        if l is None or r is None:
            continue
        if rectifier is not None:
            l, r = rectifier(l, r)
        yield StereoItem(float(ts) * 1e-9, l.astype(np.float32), r.astype(np.float32))


def euroc_mono_frames(data_dir: str, timestamps_path: str) -> Iterator[MonoItem]:
    for ts in load_euroc_timestamps(timestamps_path):
        img = png.imread(os.path.join(data_dir, "cam0", "data", ts + ".png"), gray=True)
        if img is None:
            continue
        yield MonoItem(float(ts) * 1e-9, img.astype(np.float32))


# ----------------------------------------------------------------------
# synthetic-dataset export (test fixture generator): writes a rendered
# sequence in TUM RGB-D layout so that the dataset drivers can be exercised
# without external data
# ----------------------------------------------------------------------
def export_synthetic_tum(seq, out_dir: str, depth_map_factor: float = 5000.0) -> str:
    """-> path of the generated associations file. Writes rgb/ (8-bit gray),
    depth/ (16-bit, metres x factor), associations.txt and groundtruth.txt
    in the TUM benchmark's format ('ts tx ty tz qx qy qz qw', Twc)."""
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    assoc_path = os.path.join(out_dir, "associations.txt")
    with open(assoc_path, "w") as f:
        for i in range(seq.n_frames):
            gray, depth = seq.render(i)
            ts = i / seq.fps
            rgb_rel = f"rgb/{ts:.6f}.png"
            depth_rel = f"depth/{ts:.6f}.png"
            png.imwrite(os.path.join(out_dir, rgb_rel),
                        np.clip(gray, 0, 255).astype(np.uint8))
            d16 = np.where(depth > 0, depth * depth_map_factor, 0)
            png.imwrite(os.path.join(out_dir, depth_rel),
                        np.clip(d16, 0, 65535).astype(np.uint16))
            f.write(f"{ts:.6f} {rgb_rel} {ts:.6f} {depth_rel}\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        for i in range(seq.n_frames):
            twc = np.linalg.inv(seq.poses[i])
            t = twc[:3, 3]
            qx, qy, qz, qw = _rot_to_quat(twc[:3, :3])
            f.write(f"{i / seq.fps:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")
    return assoc_path


def _rot_to_quat(r: np.ndarray):
    """3x3 rotation -> (qx, qy, qz, qw)."""
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (r[2, 1] - r[1, 2]) / s
        qy = (r[0, 2] - r[2, 0]) / s
        qz = (r[1, 0] - r[0, 1]) / s
    else:
        i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        qw = (r[k, j] - r[j, k]) / s
        qx, qy, qz = q
    return qx, qy, qz, qw
