"""Batched Sim(3) in numpy: the host-side twin of geometry/sim3.py.

Own copy of ``orbslam2_tpu/geometry/sim3_np.py``. Loop correction stages its
problems on the host between device solves; these are the same operations
as geometry/sim3.py on ``[..., 4, 4]`` matrices ``[[s R, t], [0, 1]]``. One
difference: results keep the inputs' precision (at least float32) where the
JAX package's are always float32, so that loop correction can stage its
essential graph in float64.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-8


def _dtype(*arrays) -> np.dtype:
    return np.result_type(np.float32, *(np.asarray(a).dtype for a in arrays))


def _det3(m: np.ndarray) -> np.ndarray:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def scale(s_mat: np.ndarray) -> np.ndarray:
    return np.cbrt(np.maximum(_det3(s_mat[..., :3, :3]), _EPS))


def split(s_mat: np.ndarray):
    s = scale(s_mat)
    return s, s_mat[..., :3, :3] / s[..., None, None], s_mat[..., :3, 3]


def from_srt(s: np.ndarray, r: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = np.zeros((*r.shape[:-2], 4, 4), _dtype(s, r, t))
    out[..., :3, :3] = np.asarray(s)[..., None, None] * r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def from_se3(t_mat: np.ndarray) -> np.ndarray:
    """SE3 is Sim3 with s=1: the matrix itself (a copy)."""
    return np.asarray(t_mat, _dtype(t_mat)).copy()


def to_se3(s_mat: np.ndarray) -> np.ndarray:
    """[R, t/s]: an optimized Sim3 as a keyframe pose."""
    s, r, t = split(s_mat)
    out = np.zeros((*s_mat.shape[:-2], 4, 4), _dtype(s_mat))
    out[..., :3, :3] = r
    out[..., :3, 3] = t / (s[..., None] + _EPS)
    out[..., 3, 3] = 1.0
    return out


def inverse(s_mat: np.ndarray) -> np.ndarray:
    s, r, t = split(s_mat)
    rt = np.swapaxes(r, -1, -2)
    inv_s = 1.0 / (s + _EPS)
    return from_srt(inv_s, rt,
                    -inv_s[..., None] * np.einsum("...ij,...j->...i", rt, t))


def compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a @ b


def apply(s_mat: np.ndarray, points: np.ndarray) -> np.ndarray:
    """p' = s R p + t; broadcasts [..., 4, 4] against [..., 3]."""
    return (np.einsum("...ij,...j->...i", s_mat[..., :3, :3], points)
            + s_mat[..., :3, 3])


def se3_inverse(t_mat: np.ndarray) -> np.ndarray:
    """Batched rigid inverse."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    rt = np.swapaxes(r, -1, -2)
    out = np.zeros(np.shape(t_mat), _dtype(t_mat))
    out[..., :3, :3] = rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", rt, t)
    out[..., 3, 3] = 1.0
    return out
