"""ctypes bindings for the native map-graph engine (``native/mapgraph.cpp``).

The port's own loader for the repository's C++ map-graph routines (C ABI
version 2, ``mg_abi_version``): covisibility weights, the point ->
(keyframe, slot) observation index, per-keyframe shares of a point set,
observation counts, and the per-point descriptor / normal / scale-band
update. Each is the runtime analogue of the reference's C++ KeyFrame and
MapPoint bookkeeping, over the map's flat arrays.

The library is compiled from ``native/mapgraph.cpp`` with ``g++`` at first
use into ``orbslam2_tpu_torch/_build/libmapgraph.so`` (built into a
temporary file and renamed into place, so that concurrent first uses never
load a half-written library) and loaded with ``ctypes``. A failed build
raises with the compiler's output: nothing falls back to numpy. The numpy
versions stay beside their callers (``covisibility.weight_matrix_plain``,
``covisibility.frame_share_plain``, ``MapState._obs_index_plain``,
``MapState._point_obs_count_plain``, ``point_stats.update_points``) as the
plain versions the tests hold these bindings against.

Every routine is stateless over caller-owned buffers and releases the
interpreter lock while it runs (ctypes does), so the mapping worker's calls
overlap the tracker's Python.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from orbslam2_tpu_torch.slammap.point_stats import camera_centers
from orbslam2_tpu_torch.utils.native_build import build_shared_library

ABI_VERSION = 2

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "mapgraph.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libmapgraph.so")

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile ``native/mapgraph.cpp`` into ``_build/libmapgraph.so``; -> its
    path. Rebuilds when the source is newer than the library. Raises with
    the compiler's output when the build fails."""
    return build_shared_library(SOURCE, LIB_PATH, force)


def load() -> ctypes.CDLL:
    """The loaded library, built at first use; -> the same handle after."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mg_abi_version.restype = ctypes.c_int32
            lib.mg_abi_version.argtypes = []
            if lib.mg_abi_version() != ABI_VERSION:
                raise RuntimeError(f"{LIB_PATH}: ABI {lib.mg_abi_version()}, "
                                   f"expected {ABI_VERSION}")
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            f32p = ctypes.POINTER(ctypes.c_float)
            i64p = ctypes.POINTER(ctypes.c_int64)
            c_int = ctypes.c_int
            lib.mg_covis_weights.argtypes = [i32p, u8p, u8p, c_int, c_int, c_int, i32p]
            lib.mg_point_obs_count.argtypes = [i32p, u8p, c_int, c_int, c_int, i32p]
            lib.mg_invert_obs_slots.argtypes = [i32p, u8p, c_int, c_int, c_int,
                                                i32p, i32p, i32p]
            lib.mg_share_from_index.argtypes = [i32p, i32p, i64p, c_int, c_int, i32p]
            lib.mg_update_point_stats.argtypes = [
                i64p, c_int, i32p, u8p, u32p, i32p, f32p, f32p, i32p,
                c_int, c_int, c_int, ctypes.c_float, c_int, u32p, f32p, f32p, f32p]
            for name in ("mg_covis_weights", "mg_point_obs_count",
                         "mg_invert_obs_slots", "mg_share_from_index",
                         "mg_update_point_stats"):
                getattr(lib, name).restype = None
            _lib = lib
    return _lib


def loaded_path() -> Optional[str]:
    """Path of the library this process loaded, or None before first use."""
    return None if _lib is None else _lib._name


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _c(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


def _kf_arrays(kf_pt: np.ndarray, kf_valid: np.ndarray):
    if kf_pt.ndim != 2 or kf_valid.shape != (kf_pt.shape[0],):
        raise ValueError("kf_pt must be [K, N] and kf_valid [K]")
    return _c(kf_pt, np.int32), _c(kf_valid, np.uint8)


def covis_weights(kf_pt: np.ndarray, kf_valid: np.ndarray,
                  pt_valid: np.ndarray) -> np.ndarray:
    """[K, K] int32 shared valid points between valid keyframes, zero
    diagonal. A point seen twice by one keyframe would count twice; the map
    keeps one observation of a point per keyframe (``replace_points``)."""
    kf_pt, kv = _kf_arrays(kf_pt, kf_valid)
    k, n = kf_pt.shape
    pv = _c(pt_valid, np.uint8)
    out = np.empty((k, k), np.int32)
    load().mg_covis_weights(_ptr(kf_pt, ctypes.c_int32), _ptr(kv, ctypes.c_uint8),
                            _ptr(pv, ctypes.c_uint8), k, n, len(pv),
                            _ptr(out, ctypes.c_int32))
    return out


def point_obs_count(kf_pt: np.ndarray, kf_valid: np.ndarray,
                    n_points: int) -> np.ndarray:
    """[P] int32 observations per point over the valid keyframes."""
    kf_pt, kv = _kf_arrays(kf_pt, kf_valid)
    k, n = kf_pt.shape
    out = np.empty(n_points, np.int32)
    load().mg_point_obs_count(_ptr(kf_pt, ctypes.c_int32), _ptr(kv, ctypes.c_uint8),
                              k, n, n_points, _ptr(out, ctypes.c_int32))
    return out


def invert_obs_slots(kf_pt: np.ndarray, kf_valid: np.ndarray, n_points: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR point -> (keyframe, slot) index over the valid keyframes:
    (offsets [P+1] int32, obs_kf [total] int32, obs_slot [total] int32),
    each point's observations in (keyframe, slot) order."""
    kf_pt, kv = _kf_arrays(kf_pt, kf_valid)
    k, n = kf_pt.shape
    offsets = np.empty(n_points + 1, np.int32)
    buf_kf = np.empty(k * n, np.int32)
    buf_slot = np.empty(k * n, np.int32)
    load().mg_invert_obs_slots(
        _ptr(kf_pt, ctypes.c_int32), _ptr(kv, ctypes.c_uint8), k, n, n_points,
        _ptr(offsets, ctypes.c_int32), _ptr(buf_kf, ctypes.c_int32),
        _ptr(buf_slot, ctypes.c_int32))
    total = int(offsets[-1])
    return offsets, buf_kf[:total].copy(), buf_slot[:total].copy()


def share_from_index(offsets: np.ndarray, obs_kf: np.ndarray,
                     pt_ids: np.ndarray, n_kf: int) -> np.ndarray:
    """[K] int32: per keyframe, the observations of the listed points
    (a point listed twice counts twice, as the reference's
    UpdateLocalKeyFrames counts a frame's map points), from the CSR index of
    ``invert_obs_slots``."""
    offsets = _c(offsets, np.int32)
    pt_ids = _c(pt_ids, np.int64)
    if len(pt_ids) and (pt_ids.min() < 0 or pt_ids.max() >= len(offsets) - 1):
        raise ValueError("point id outside the index")
    out = np.empty(n_kf, np.int32)
    load().mg_share_from_index(
        _ptr(offsets, ctypes.c_int32), _ptr(_c(obs_kf, np.int32), ctypes.c_int32),
        _ptr(pt_ids, ctypes.c_int64), len(pt_ids), n_kf, _ptr(out, ctypes.c_int32))
    return out


def update_point_stats(m, pts: np.ndarray, scale_factor: float,
                       n_levels: int) -> None:
    """MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth for the
    given valid point ids, in place on ``m`` (pt_desc, pt_normal,
    pt_min_dist, pt_max_dist, and pt_ref_kf where the reference observation
    is gone). Float32 arithmetic; ``point_stats.update_points`` is the plain
    version."""
    pts = _c(pts, np.int64)
    pts = pts[m.pt_valid[pts]] if len(pts) else pts
    if len(pts) == 0:
        return
    k, n = m.kf_pt.shape
    p = m.cap.max_points
    kf_pt, kv = _kf_arrays(m.kf_pt, m.kf_valid)
    desc = _c(m.kf_kp_desc, np.uint32)
    octv = _c(m.kf_kp_octave, np.int32)
    centers = _c(camera_centers(m.kf_pose), np.float32)
    pos = _c(m.pt_pos, np.float32)
    arrays = {}
    for name, dtype in (("pt_ref_kf", np.int32), ("pt_desc", np.uint32),
                        ("pt_normal", np.float32), ("pt_min_dist", np.float32),
                        ("pt_max_dist", np.float32)):
        a = getattr(m, name)
        if a.dtype != dtype or not a.flags.c_contiguous:
            raise TypeError(f"map field {name} must be C-contiguous {np.dtype(dtype)}")
        arrays[name] = a       # written in place
    load().mg_update_point_stats(
        _ptr(pts, ctypes.c_int64), len(pts), _ptr(kf_pt, ctypes.c_int32),
        _ptr(kv, ctypes.c_uint8), _ptr(desc, ctypes.c_uint32),
        _ptr(octv, ctypes.c_int32), _ptr(centers, ctypes.c_float),
        _ptr(pos, ctypes.c_float), _ptr(arrays["pt_ref_kf"], ctypes.c_int32),
        k, n, p, ctypes.c_float(scale_factor), n_levels,
        _ptr(arrays["pt_desc"], ctypes.c_uint32), _ptr(arrays["pt_normal"], ctypes.c_float),
        _ptr(arrays["pt_min_dist"], ctypes.c_float),
        _ptr(arrays["pt_max_dist"], ctypes.c_float))
