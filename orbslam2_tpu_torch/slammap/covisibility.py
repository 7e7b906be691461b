"""Covisibility graph, spanning tree, and local-map selection.

Own copy of ``orbslam2_tpu/slammap/covisibility.py``. The whole graph is one
[K, K] weight matrix, counted by the native map-graph engine
(``slammap/native.py``) from the observation arrays; every query is a masked
argsort. The numpy bodies stay as the plain versions (``weight_matrix_plain``
= incidence @ incidence.T, ``frame_share_plain``) that the tests hold the
engine against.

Thresholds mirrored from the reference:
- covisibility edge if >= 15 shared points, else keep only the single best
  neighbor
- essential-graph edges at weight >= 100
- local map bounded at 80 keyframes
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from orbslam2_tpu_torch.slammap import native

COVIS_THRESHOLD = 15
ESSENTIAL_THRESHOLD = 100
LOCAL_MAP_MAX_KF = 80


def weight_matrix(m) -> np.ndarray:
    """[K, K] int32 covisibility weights (shared map points), zero diagonal,
    by the native engine: one pass over the observations, where the plain
    version builds a [K, P] incidence and multiplies it."""
    return native.covis_weights(m.kf_pt, m.kf_valid, m.pt_valid)


def weight_matrix_plain(m) -> np.ndarray:
    """Plain numpy version of ``weight_matrix``: incidence @ incidence.T,
    over the columns of the points that valid keyframes observe (a column
    of zeros adds nothing), so that it stays affordable at full capacity.

    The product is taken in float32, where numpy calls BLAS; numpy's
    integer product has no BLAS path and is many times slower. It is exact:
    a weight counts points shared with one keyframe, at most its feature
    count, far below 2**24."""
    kk, slots = np.nonzero((m.kf_pt >= 0) & m.kf_valid[:, None])
    pids = m.kf_pt[kk, slots]
    keep = m.pt_valid[pids]
    cols, col = np.unique(pids[keep], return_inverse=True)
    inc = np.zeros((m.cap.max_keyframes, len(cols)), np.float32)
    inc[kk[keep], col] = 1.0
    w = (inc @ inc.T).astype(np.int32)
    np.fill_diagonal(w, 0)
    return w


def covisible_neighbors(w: np.ndarray, kf: int, min_weight: int = COVIS_THRESHOLD) -> np.ndarray:
    """Neighbor kf ids ordered by descending weight; if none reach the
    threshold, the single best is kept."""
    row = w[kf]
    above = np.where(row >= min_weight)[0]
    if len(above) == 0:
        best = int(row.argmax())
        return np.array([best], np.int64) if row[best] > 0 else np.array([], np.int64)
    return above[np.argsort(-row[above], kind="stable")]


def best_covisible(w: np.ndarray, kf: int, n: int) -> np.ndarray:
    """Top-n neighbors by weight (GetBestCovisibilityKeyFrames).
    argpartition + small sort: this runs ~80x per frame in the local-map
    neighbor ring; a full argsort over K keyframes dominates at map scale."""
    row = w[kf]
    if n < len(row):
        cand = np.argpartition(-row, n)[:n + 1]
    else:
        cand = np.arange(len(row))
    cand = cand[row[cand] > 0]
    return cand[np.argsort(-row[cand], kind="stable")][:n]


def assign_spanning_parent(m, w: np.ndarray, kf: int) -> None:
    """First-connection parent assignment: most covisible earlier keyframe
    (KeyFrame::UpdateConnections)."""
    if m.kf_parent[kf] >= 0:
        return
    row = w[kf].copy()
    earlier = m.kf_valid & (m.kf_order >= 0) & (m.kf_order < m.kf_order[kf])
    row[~earlier] = 0
    if row.max() > 0:
        m.kf_parent[kf] = int(row.argmax())


def local_keyframes(m, frame_pt_ids: np.ndarray, w: np.ndarray) -> Tuple[np.ndarray, int]:
    """Tracking::UpdateLocalKeyFrames: keyframes observing the frame's points (weighted by #shared), plus one
    ring of best covisible neighbors + parents/children, capped at 80.

    -> (local kf ids, reference kf id = max sharing)."""
    pts = frame_pt_ids[frame_pt_ids >= 0]
    if len(pts) == 0:
        return np.array([], np.int64), -1
    # only the frame's own points' observations, through the cached index
    offsets, obs_kf, _ = m.obs_index()
    share = native.share_from_index(offsets, obs_kf, pts,
                                    m.cap.max_keyframes).astype(np.int64)
    seeds = np.where(share > 0)[0]
    if len(seeds) == 0:
        return np.array([], np.int64), -1
    ref_kf = int(seeds[np.argmax(share[seeds])])

    local = list(seeds[np.argsort(-share[seeds], kind="stable")])
    in_local = set(local)
    for kf in list(local):
        if len(local) >= LOCAL_MAP_MAX_KF:
            break
        for nb in best_covisible(w, kf, 10):
            if nb not in in_local and m.kf_valid[nb]:
                local.append(int(nb))
                in_local.add(int(nb))
                break  # reference adds only the first new best neighbor
        # spanning-tree children: first not-yet-included child
        for ch in np.where(m.kf_parent == kf)[0]:
            if ch not in in_local and m.kf_valid[ch]:
                local.append(int(ch))
                in_local.add(int(ch))
                break
        # parent (the reference `break`s out of the
        # whole expansion after the first parent added — a known quirk we
        # deliberately do not reproduce)
        par = m.kf_parent[kf]
        if par >= 0 and par not in in_local and m.kf_valid[par]:
            local.append(int(par))
            in_local.add(int(par))
    return np.array(local[:LOCAL_MAP_MAX_KF], np.int64), ref_kf


def frame_share_plain(m, pts: np.ndarray) -> np.ndarray:
    """Plain numpy version of the share ``local_keyframes`` takes from the
    native index: [K] int64, per valid keyframe the observations of the
    points ``pts`` (an O(K*N) scan; a point listed twice counts twice)."""
    in_frame = np.zeros(m.cap.max_points, np.int64)
    np.add.at(in_frame, np.asarray(pts, np.int64), 1)
    kf_pt = m.kf_pt
    share = np.where(kf_pt >= 0, in_frame[np.maximum(kf_pt, 0)], 0).sum(axis=1)
    share[~m.kf_valid] = 0
    return share


def local_points(m, local_kfs: np.ndarray) -> np.ndarray:
    """Unique valid point ids observed by the local keyframes."""
    if len(local_kfs) == 0:
        return np.array([], np.int64)
    ids = np.unique(m.kf_pt[local_kfs])
    ids = ids[ids >= 0]
    return ids[m.pt_valid[ids]]


def essential_edges(m, w: np.ndarray) -> List[Tuple[int, int]]:
    """Edges of the essential graph: spanning tree + loop edges +
    high-covisibility (>= 100) pairs."""
    edges = set()
    for kf in np.where(m.kf_valid)[0]:
        par = m.kf_parent[kf]
        if par >= 0 and m.kf_valid[par]:
            edges.add((min(kf, par), max(kf, par)))
        for le in m.kf_loop_edges[kf]:
            if m.kf_valid[le]:
                edges.add((min(kf, le), max(kf, le)))
    hi = np.argwhere(np.triu(w, 1) >= ESSENTIAL_THRESHOLD)
    for a, b in hi:
        if m.kf_valid[a] and m.kf_valid[b]:
            edges.add((int(a), int(b)))
    return sorted(edges)
