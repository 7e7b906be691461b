"""State carried across from the JAX package, as numpy arrays.

Each function takes what ``orbslam2_tpu`` holds (fetched to numpy by the
caller; this module never imports it) and returns the port's counterpart on
the given device. The tests use them so both packages compute on identical
inputs. Packed descriptors are uint32 words there and int32 bit-views here.
A map written by the JAX ``MapState.save`` loads with the port's
``MapState.load``: the npz format is the same; ``map_state_from_numpy``
copies a live one, with its bookkeeping, and ``keyframe_db_from_numpy`` its
keyframe database.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from orbslam2_tpu_torch.backend.pose_opt import PoseObs
from orbslam2_tpu_torch.ops.orb import Keypoints
from orbslam2_tpu_torch.place.vocabulary import Vocabulary
from orbslam2_tpu_torch.slammap.keyframe_db import KeyFrameDatabase
from orbslam2_tpu_torch.slammap.mapstate import MapCapacity, MapState


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def desc_from_numpy(desc: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 words [..., 8] -> int32 bit-view tensor."""
    desc = np.ascontiguousarray(desc, dtype=np.uint32)
    return torch.from_numpy(desc.view(np.int32)).to(device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor -> uint32 words."""
    return np.ascontiguousarray(desc.cpu().numpy()).view(np.uint32)


def pattern_from_numpy(pattern: np.ndarray, device="cpu") -> torch.Tensor:
    """BRIEF pattern [256, 2, 2] ((a, b) x (dx, dy))."""
    if np.shape(pattern) != (256, 2, 2):
        raise ValueError(f"pattern must be [256, 2, 2], got {np.shape(pattern)}")
    return _tensor(pattern, np.float32, device)


def keypoints_from_numpy(xy, response, angle, octave, size, desc, valid,
                         device="cpu") -> Keypoints:
    """The seven ``Keypoints`` fields as numpy arrays -> the port's."""
    def f32(a):
        return _tensor(a, np.float32, device)
    return Keypoints(
        xy=f32(xy), response=f32(response), angle=f32(angle),
        octave=_tensor(octave, np.int32, device),
        size=f32(size), desc=desc_from_numpy(desc, device),
        valid=_tensor(valid, bool, device))


def keypoints_to_numpy(kp: Keypoints) -> dict:
    """The port's ``Keypoints`` -> numpy arrays by field name, descriptors
    as uint32 words."""
    out = {name: getattr(kp, name).cpu().numpy()
           for name in ("xy", "response", "angle", "octave", "size", "valid")}
    out["desc"] = desc_to_numpy(kp.desc)
    return out


def pose_obs_from_numpy(pts_w, uv, inv_sigma2, is_stereo, valid,
                        device="cpu") -> PoseObs:
    def f32(a):
        return _tensor(a, np.float32, device)
    return PoseObs(pts_w=f32(pts_w), uv=f32(uv), inv_sigma2=f32(inv_sigma2),
                   is_stereo=_tensor(is_stereo, bool, device),
                   valid=_tensor(valid, bool, device))


def vocabulary_from_numpy(k: int, levels: int, centers, word_weights,
                          n_words: int) -> Vocabulary:
    """The fields of a JAX ``Vocabulary`` -> the port's (copies)."""
    return Vocabulary(k=int(k), levels=int(levels),
                      centers=[np.array(c) for c in centers],
                      word_weights=np.array(word_weights, np.float32),
                      n_words=int(n_words))


def map_state_from_numpy(fields: dict) -> MapState:
    """The attributes of a JAX ``MapState`` (``vars(map)``) -> a port
    MapState holding deep copies of them: arrays, counters, free lists,
    loop edges and dirty sets alike."""
    cap = fields["cap"]
    m = MapState(MapCapacity(cap.max_keyframes, cap.max_points, cap.n_features))
    for name in vars(m):
        if name in fields and name != "cap":
            setattr(m, name, copy.deepcopy(fields[name]))
    return m


def keyframe_db_from_numpy(voc: Vocabulary, wids: np.ndarray, wts: np.ndarray,
                           valid: np.ndarray) -> KeyFrameDatabase:
    """The arrays of a JAX ``KeyFrameDatabase`` -> the port's (copies)."""
    db = KeyFrameDatabase(voc, wids.shape[0], wids.shape[1])
    db.wids[:] = wids
    db.wts[:] = wts
    db.valid[:] = valid
    return db
