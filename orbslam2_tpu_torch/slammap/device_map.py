"""Device-resident mirrors of the map: the point arrays the tracker reads per
frame, and the keyframe feature arrays the local mapper reads.

Counterpart of ``orbslam2_tpu/slammap/device_map.py``. ``DeviceMapMirror``
keeps the full point SoA resident in device memory and uploads only rows
dirtied by mapping events (adds, culls, updates), so per-frame traffic is
the local-point id list. ``DeviceKFStore`` uploads each keyframe's feature
rows once, at insertion, and the poses on every sync. Bulk rewrites fall
back to one full upload.

Updates are written out of place: a sync replaces the tensors it changes and
never writes into one it handed out. A consumer that took the tensors under
the map lock (the tracker's unlocked frame step, the mapper's unlocked fuse
and triangulation) keeps a consistent snapshot while the other thread syncs,
as the JAX package's immutable arrays give it.

MapState records dirtiness at every write site; sync() consumes it and is
called with the map lock held.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

FIELDS = ("pt_pos", "pt_desc", "pt_valid", "pt_normal",
          "pt_min_dist", "pt_max_dist")

KF_FIELDS = ("kf_kp_xy", "kf_kp_desc", "kf_kp_octave", "kf_kp_angle",
             "kf_kp_valid", "kf_kp_ur", "kf_kp_depth")


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor that shares no memory with the host array
    (on the CPU too); uint32 descriptor words travel as their int32
    bit-views."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _upload(m, fields, device) -> dict:
    return {f: _to_device(getattr(m, f), device) for f in fields}


def _scatter_rows(arrays: dict, m, ids: np.ndarray, device) -> dict:
    """New tensors with the rows `ids` replaced by the host's."""
    idx = torch.from_numpy(ids).to(device)
    return {f: a.index_put((idx,), _to_device(getattr(m, f)[ids], device))
            for f, a in arrays.items()}


class DeviceMapMirror:
    def __init__(self, device):
        self.device = torch.device(device)
        self.gen = -1
        self.arrays: Optional[dict] = None
        self.n_full_uploads = 0
        self.n_row_uploads = 0

    def sync(self, m) -> None:
        """Bring the mirror up to date with the host MapState."""
        if m.pt_dirty_gen == self.gen and self.arrays is not None:
            return
        dirty_all, dirty_ids = m.consume_pt_dirty()
        if self.arrays is None or dirty_all:
            self.arrays = _upload(m, FIELDS, self.device)
            self.n_full_uploads += 1
        elif len(dirty_ids):
            self.arrays = _scatter_rows(self.arrays, m, dirty_ids, self.device)
            self.n_row_uploads += 1
        self.gen = m.pt_dirty_gen

    def __getattr__(self, name):
        arrays = self.__dict__.get("arrays")
        if arrays is not None and name in FIELDS:
            return arrays[name]
        raise AttributeError(name)


class DeviceKFStore:
    """Device-resident keyframe feature arrays + poses.

    The mapping stages (triangulation against ~10 neighbours, fusion into
    ~20 targets) read whole keyframes' keypoint arrays; keeping them
    resident means each keyframe row is uploaded once, at insertion (a
    keyframe's features never change), and the stages gather rows on the
    device. Poses change with every BA and are small: they are uploaded
    whole on every sync."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.gen = -1
        self.arrays: Optional[dict] = None
        self.pose: Optional[torch.Tensor] = None   # [K, 4, 4]
        self.n_row_uploads = 0

    def sync(self, m) -> None:
        if self.arrays is None or m.kf_dirty_gen != self.gen:
            dirty_all, dirty_ids = m.consume_kf_dirty()
            if self.arrays is None or dirty_all:
                self.arrays = _upload(m, KF_FIELDS, self.device)
            elif len(dirty_ids):
                self.arrays = _scatter_rows(self.arrays, m, dirty_ids, self.device)
                self.n_row_uploads += 1
        self.gen = m.kf_dirty_gen
        self.pose = _to_device(m.kf_pose, self.device)
