"""Settings loading: the reference's OpenCV YAML camera/ORB files.

Counterpart of ``orbslam2_tpu/io/settings.py``, which reads the files with
``cv2.FileStorage``. The port reads them with its own small reader of the
subset of OpenCV's YAML dialect the reference's settings files use
(Examples/RGB-D/TUM1.yaml, Examples/Stereo/EuRoC.yaml, ...):

- the ``%YAML:1.0`` header and ``---``;
- ``#`` comments;
- top-level ``key: value`` lines, keys with dots (``Camera.fx``);
- integers, reals and strings (quoted or not);
- ``!!opencv-matrix`` nodes with ``rows``, ``cols``, ``dt`` and ``data``,
  whose flow sequence may span lines (EuRoC's ``LEFT.K`` ... ``RIGHT.P``).

Anything else (nested maps, block sequences) raises ``ValueError``.
``load_settings`` maps the keys onto ``SLAMConfig`` exactly as the JAX
package does.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple, Union

import numpy as np

from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig

Value = Union[int, float, str, np.ndarray]

# OpenCV's matrix element types (cv::FileStorage's ``dt`` codes)
_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16, "i": np.int32,
       "f": np.float32, "d": np.float64}
_INT = re.compile(r"[+-]?\d+\Z")
_KEY = re.compile(r"([^\s:#][^:#]*?)\s*:(?:\s+|\Z)(.*)\Z")


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _scalar(text: str) -> Union[int, float, str]:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if _INT.match(text):
        return int(text)
    try:
        return float(text)
    except ValueError:
        return text


def _matrix(fields: Dict[str, str], key: str) -> np.ndarray:
    try:
        rows, cols, dt = int(fields["rows"]), int(fields["cols"]), fields["dt"].strip()
        data = fields["data"].strip()
    except KeyError as e:
        raise ValueError(f"matrix {key} lacks {e.args[0]}") from None
    if not (data.startswith("[") and data.endswith("]")):
        raise ValueError(f"matrix {key}: data is not a flow sequence")
    if dt not in _DT:
        raise ValueError(f"matrix {key}: element type {dt!r} is not supported")
    values = [float(v) for v in data[1:-1].replace("\n", " ").split(",") if v.strip()]
    if len(values) != rows * cols:
        raise ValueError(f"matrix {key}: {len(values)} values for {rows}x{cols}")
    return np.asarray(values, np.float64).astype(_DT[dt]).reshape(rows, cols)


def read_opencv_yaml(path: str) -> Dict[str, Value]:
    """The top-level nodes of an OpenCV YAML file (see the module docstring):
    key -> int, float, str or np.ndarray (a matrix, of its ``dt``)."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        raise FileNotFoundError(f"cannot open settings file {path}") from e
    out: Dict[str, Value] = {}
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).rstrip()
        i += 1
        if not line.strip() or line.startswith("%") or line.strip() == "---":
            continue
        if line[0].isspace():
            raise ValueError(f"{path}:{i}: nested nodes are not supported: {line.strip()!r}")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"{path}:{i}: not a 'key: value' line: {line!r}")
        key, value = m.group(1), m.group(2).strip()
        if not value.startswith("!!opencv-matrix"):
            if value.startswith(("[", "{", "!!")) or not value:
                raise ValueError(f"{path}:{i}: node {key} is not a scalar or a matrix")
            out[key] = _scalar(value)
            continue
        # the matrix's fields, indented on the lines below; data may span lines
        fields: Dict[str, str] = {}
        while i < len(lines):
            sub = _strip_comment(lines[i]).rstrip()
            if sub.strip() and not sub[0].isspace():
                break
            i += 1
            m = _KEY.match(sub.strip()) if sub.strip() else None
            if m is None:
                continue
            name, text = m.group(1), m.group(2)
            if name == "data":
                while "]" not in text and i < len(lines):
                    text += " " + _strip_comment(lines[i]).strip()
                    i += 1
            fields[name] = text
        out[key] = _matrix(fields, key)
    return out


def _read(fs: Dict[str, Value], key: str, default=None):
    """A node as ``cv2.FileNode`` gives it to the JAX package: a number as a
    float, a string as a string, anything else (or nothing) as ``default``."""
    v = fs.get(key)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return v
    return default


def load_settings(path: str, image_size: Tuple[int, int] | None = None,
                  **overrides) -> SLAMConfig:
    """Parse a reference-format settings YAML into a SLAMConfig.

    image_size: (width, height), used where the file has no
    Camera.width/height keys (the reference infers it from the first
    image). ``overrides`` override any SLAMConfig field."""
    fs = read_opencv_yaml(path)
    fx = _read(fs, "Camera.fx")
    fy = _read(fs, "Camera.fy")
    cx = _read(fs, "Camera.cx")
    cy = _read(fs, "Camera.cy")
    width = int(_read(fs, "Camera.width", image_size[0] if image_size else 640))
    height = int(_read(fs, "Camera.height", image_size[1] if image_size else 480))
    cam = PinholeCamera(
        fx=fx, fy=fy, cx=cx, cy=cy,
        k1=_read(fs, "Camera.k1", 0.0),
        k2=_read(fs, "Camera.k2", 0.0),
        p1=_read(fs, "Camera.p1", 0.0),
        p2=_read(fs, "Camera.p2", 0.0),
        k3=_read(fs, "Camera.k3", 0.0),
        width=width, height=height,
        bf=_read(fs, "Camera.bf", 0.0),
    )
    orb = ORBConfig(
        n_features=int(_read(fs, "ORBextractor.nFeatures", 2000)),
        scale_factor=_read(fs, "ORBextractor.scaleFactor", 1.2),
        n_levels=int(_read(fs, "ORBextractor.nLevels", 8)),
        ini_th_fast=_read(fs, "ORBextractor.iniThFAST", 20.0),
        min_th_fast=_read(fs, "ORBextractor.minThFAST", 7.0),
    )
    fps = _read(fs, "Camera.fps", 30.0) or 30.0
    th_depth_units = _read(fs, "ThDepth", 40.0)
    # mThDepth = bf * ThDepth / fx (Tracking.cc:105-110)
    th_depth = cam.bf * th_depth_units / fx if cam.bf else 3.0
    cfg = SLAMConfig(
        cam=cam, orb=orb, th_depth=th_depth,
        max_frames_between_kf=int(fps),
        # map capacities: the framework's own keys (the reference's map
        # grows without bound; fixed-capacity arrays need a budget). 0 or
        # absent: SLAMConfig's defaults, which the drivers may raise
        max_keyframes=int(_read(fs, "Map.MaxKeyFrames", 0)) or 256,
        max_points=int(_read(fs, "Map.MaxPoints", 0)) or 16384,
    )
    cfg.depth_map_factor = _read(fs, "DepthMapFactor", 1.0) or 1.0  # read by rgbd_tum
    cfg.rgb_order = bool(int(_read(fs, "Camera.RGB", 1) or 1))
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
