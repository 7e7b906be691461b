"""Global map state: fixed-capacity structure-of-arrays with validity masks.

Own copy of ``orbslam2_tpu/slammap/mapstate.py`` (numpy; its observation
index, observation counts and per-point statistics go through the native
map-graph engine, ``slammap/native.py``, whose numpy plain versions stay
beside them). It replaces the reference's pointer-graph map
(Map/KeyFrame/MapPoint) and its mutex protocol with a flat array store:

- keyframe slot k <-> reference KeyFrame object; per-KF keypoint arrays are
  the immutable Frame copies
- point slot p <-> reference MapPoint; the kf_pt association array IS the
  observation map in inverse form:
  kf_pt[k, i] = point observed by keypoint i of keyframe k (or -1)
- culling = clearing validity bits; slots are recycled via a free list

Host-side bookkeeping is numpy (cheap, O(K*N) scans); the tracker's device
steps read the point arrays through the device mirror
(slammap/device_map). Descriptors are stored as uint32 words, and the npz
written by ``save`` has the same format as the JAX package's.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.ops.orb import DESC_WORDS
from orbslam2_tpu_torch.slammap import native

_DIRTY_GEN = itertools.count(1)


@dataclasses.dataclass
class MapCapacity:
    max_keyframes: int = 256
    max_points: int = 16384
    n_features: int = 1024


class MapState:
    """Mutable host-side SLAM map over fixed-capacity arrays."""

    def __init__(self, cap: MapCapacity):
        self.cap = cap
        k, p, n = cap.max_keyframes, cap.max_points, cap.n_features

        # --- keyframes -------------------------------------------------
        self.kf_valid = np.zeros(k, bool)
        self.kf_pose = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))  # Tcw
        self.kf_timestamp = np.zeros(k, np.float64)
        self.kf_frame_id = np.full(k, -1, np.int64)   # source frame index
        self.kf_kp_xy = np.zeros((k, n, 2), np.float32)    # undistorted, level-0
        self.kf_kp_octave = np.zeros((k, n), np.int32)
        self.kf_kp_angle = np.zeros((k, n), np.float32)
        self.kf_kp_response = np.zeros((k, n), np.float32)
        self.kf_kp_desc = np.zeros((k, n, DESC_WORDS), np.uint32)
        self.kf_kp_valid = np.zeros((k, n), bool)
        self.kf_kp_ur = np.full((k, n), -1.0, np.float32)  # virtual right u; <0 = mono
        self.kf_kp_depth = np.full((k, n), -1.0, np.float32)
        self.kf_pt = np.full((k, n), -1, np.int32)         # keypoint -> point id
        # spanning tree: parent kf id, -1 for root
        self.kf_parent = np.full(k, -1, np.int32)
        # loop edges
        self.kf_loop_edges: List[set] = [set() for _ in range(k)]
        # monotonically increasing insertion order (KeyFrame mnId analogue)
        self.kf_order = np.full(k, -1, np.int64)
        self._kf_counter = 0

        # --- map points ------------------------------------------------
        self.pt_valid = np.zeros(p, bool)
        self.pt_pos = np.zeros((p, 3), np.float32)
        self.pt_desc = np.zeros((p, DESC_WORDS), np.uint32)
        self.pt_normal = np.zeros((p, 3), np.float32)
        self.pt_min_dist = np.zeros(p, np.float32)
        self.pt_max_dist = np.zeros(p, np.float32)
        self.pt_ref_kf = np.full(p, -1, np.int32)
        self.pt_first_kf = np.full(p, -1, np.int32)
        self.pt_visible = np.zeros(p, np.int32)   # MapPoint::mnVisible
        self.pt_found = np.zeros(p, np.int32)     # MapPoint::mnFound
        self.pt_first_frame = np.full(p, -1, np.int64)
        # monotonically increasing creation stamp (slot-reuse guard for
        # async consumers of point snapshots, e.g. the background GBA)
        self.pt_stamp = np.full(p, -1, np.int64)
        self._pt_counter = 0
        # replacement table (MapPoint::mpReplaced): the point a replaced slot
        # was merged into, and that point's stamp at the time, which names
        # the target's life where its slot was handed out again since; -1
        # for a live slot and for one erased without a replacement
        self.pt_replaced = np.full(p, -1, np.int32)
        self.pt_replaced_stamp = np.full(p, -1, np.int64)
        # the slot's previous life, copied when the slot is handed out again
        # (its stamp, replacement and replacement's stamp), so that a holder
        # of the old id still finds the point it was merged into; -1 for a
        # slot never handed out before
        self.pt_prev_stamp = np.full(p, -1, np.int64)
        self.pt_prev_replaced = np.full(p, -1, np.int32)
        self.pt_prev_replaced_stamp = np.full(p, -1, np.int64)

        self._kf_free: List[int] = list(range(k - 1, -1, -1))
        self._pt_free: List[int] = list(range(p - 1, -1, -1))
        # culled-keyframe trajectory chain: (slot, order) -> (parent slot,
        # parent order, Tcp) — the mTcp relative-pose mechanism the
        # reference uses to recover frame trajectories through culled
        # keyframes
        self.dead_kf = {}
        # "big change" counter (Map::InformNewBigChange)
        self.change_index = 0
        # dirty bookkeeping for device-resident mirrors (slammap/device_map):
        # every point-array write marks rows dirty; bulk rewrites mark all.
        # The generation is globally monotone so a mirror never mistakes a
        # cleared/reloaded map for an up-to-date one.
        self.pt_dirty_gen = next(_DIRTY_GEN)
        self._pt_dirty: set = set()
        self._pt_dirty_all = True
        # observation-structure generation: bumps whenever kf_pt changes
        # (guards the per-frame point_obs_count cache)
        self.obs_gen = next(_DIRTY_GEN)
        self._obs_count_cache = None
        self._obs_index_cache = None
        # bulk pose-correction generation: bumped by loop corrections and
        # GBA applies (any event that rewrites keyframe poses map-wide);
        # in-flight unlocked solves staged before the bump must discard
        # their write-back
        self.correction_gen = 0
        # keyframe-row dirtiness for a device keyframe store: keypoint
        # arrays are immutable per keyframe, so only inserts dirty rows
        self.kf_dirty_gen = next(_DIRTY_GEN)
        self._kf_dirty: set = set()
        self._kf_dirty_all = True
        self._device_mirror = None
        self._device_kf_store = None

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def free_point_slots(self) -> int:
        return len(self._pt_free)

    def free_keyframe_slots(self) -> int:
        return len(self._kf_free)

    def keyframe_ids(self) -> np.ndarray:
        """Valid keyframe slots in insertion order."""
        ids = np.where(self.kf_valid)[0]
        return ids[np.argsort(self.kf_order[ids])]

    def add_keyframe(
        self,
        pose: np.ndarray,
        timestamp: float,
        frame_id: int,
        kp_xy: np.ndarray,
        kp_octave: np.ndarray,
        kp_angle: np.ndarray,
        kp_response: np.ndarray,
        kp_desc: np.ndarray,
        kp_valid: np.ndarray,
        kp_ur: np.ndarray,
        kp_depth: np.ndarray,
    ) -> int:
        if not self._kf_free:
            raise RuntimeError("keyframe capacity exhausted")
        k = self._kf_free.pop()
        self.kf_valid[k] = True
        self.kf_pose[k] = pose
        self.kf_timestamp[k] = timestamp
        self.kf_frame_id[k] = frame_id
        self.kf_kp_xy[k] = kp_xy
        self.kf_kp_octave[k] = kp_octave
        self.kf_kp_angle[k] = kp_angle
        self.kf_kp_response[k] = kp_response
        self.kf_kp_desc[k] = kp_desc
        self.kf_kp_valid[k] = kp_valid
        self.kf_kp_ur[k] = kp_ur
        self.kf_kp_depth[k] = kp_depth
        self.kf_pt[k] = -1
        self.kf_parent[k] = -1
        self.kf_loop_edges[k] = set()
        self.kf_order[k] = self._kf_counter
        self._kf_counter += 1
        if not self._kf_dirty_all:
            self._kf_dirty.add(k)
        self.kf_dirty_gen = next(_DIRTY_GEN)
        return k

    def consume_kf_dirty(self):
        """-> (all_dirty, sorted dirty kf array); clears the dirty state."""
        all_dirty = self._kf_dirty_all
        ids = np.fromiter(self._kf_dirty, np.int64, len(self._kf_dirty))
        ids.sort()
        self._kf_dirty_all = False
        self._kf_dirty.clear()
        return all_dirty, ids

    def add_point(
        self,
        pos: np.ndarray,
        desc: np.ndarray,
        ref_kf: int,
        frame_id: int,
        normal: Optional[np.ndarray] = None,
        min_dist: float = 0.0,
        max_dist: float = 0.0,
    ) -> int:
        if not self._pt_free:
            raise RuntimeError("map point capacity exhausted")
        p = self._pt_free.pop()
        self._keep_previous_life(p)
        self.pt_valid[p] = True
        self.pt_pos[p] = pos
        self.pt_desc[p] = desc
        self.pt_ref_kf[p] = ref_kf
        self.pt_first_kf[p] = ref_kf
        self.pt_normal[p] = normal if normal is not None else np.zeros(3, np.float32)
        self.pt_min_dist[p] = min_dist
        self.pt_max_dist[p] = max_dist
        self.pt_visible[p] = 1
        self.pt_found[p] = 1
        self.pt_first_frame[p] = frame_id
        self.pt_stamp[p] = self._pt_counter
        self._pt_counter += 1
        self.mark_pts_dirty((p,))
        return p

    def add_points_batch(
        self,
        pos: np.ndarray,          # [M, 3]
        desc: np.ndarray,         # [M, DESC_WORDS]
        ref_kf: int,
        frame_id: int,
    ) -> np.ndarray:
        """Vectorized add_point for M new points (keyframe creation and
        triangulation insert dozens-to-hundreds at once).
        Allocates min(M, free) slots -> returns their ids [M'] (callers
        must add observations + run update_point_descriptor_and_normal)."""
        m = min(len(pos), len(self._pt_free))
        if m == 0:
            return np.zeros(0, np.int64)
        pids = np.array([self._pt_free.pop() for _ in range(m)], np.int64)
        self._keep_previous_life(pids)
        self.pt_valid[pids] = True
        self.pt_pos[pids] = pos[:m]
        self.pt_desc[pids] = desc[:m]
        self.pt_ref_kf[pids] = ref_kf
        self.pt_first_kf[pids] = ref_kf
        self.pt_normal[pids] = 0.0
        self.pt_min_dist[pids] = 0.0
        self.pt_max_dist[pids] = 0.0
        self.pt_visible[pids] = 1
        self.pt_found[pids] = 1
        self.pt_first_frame[pids] = frame_id
        self.pt_stamp[pids] = np.arange(self._pt_counter,
                                        self._pt_counter + m)
        self._pt_counter += m
        self.mark_pts_dirty(pids)
        return pids

    def _keep_previous_life(self, pids) -> None:
        """Copy the slots' current life into the previous-life record and
        clear the replacement table's entry: the slots are handed out."""
        self.pt_prev_stamp[pids] = self.pt_stamp[pids]
        self.pt_prev_replaced[pids] = self.pt_replaced[pids]
        self.pt_prev_replaced_stamp[pids] = self.pt_replaced_stamp[pids]
        self.pt_replaced[pids] = -1
        self.pt_replaced_stamp[pids] = -1

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    def add_observation(self, kf: int, slot: int, pt: int) -> None:
        self.kf_pt[kf, slot] = pt
        self.obs_gen = next(_DIRTY_GEN)

    def touch_obs(self) -> None:
        """Invalidate observation-derived caches after a direct kf_pt
        write (batch scatter paths)."""
        self.obs_gen = next(_DIRTY_GEN)

    def erase_observation(self, kf: int, slot_or_pt: int, by_point: bool = False) -> None:
        if by_point:
            slots = np.where(self.kf_pt[kf] == slot_or_pt)[0]
            self.kf_pt[kf, slots] = -1
        else:
            self.kf_pt[kf, slot_or_pt] = -1
        self.obs_gen = next(_DIRTY_GEN)

    def mark_pts_dirty(self, ids) -> None:
        """Record point rows whose device-mirror copy is stale
        (slammap/device_map.DeviceMapMirror)."""
        if not self._pt_dirty_all:
            self._pt_dirty.update(int(i) for i in ids)
            if len(self._pt_dirty) > 8192:  # row scatter no longer cheaper
                self._pt_dirty_all = True
                self._pt_dirty.clear()
        self.pt_dirty_gen = next(_DIRTY_GEN)

    def mark_all_pts_dirty(self) -> None:
        self._pt_dirty_all = True
        self._pt_dirty.clear()
        self.pt_dirty_gen = next(_DIRTY_GEN)

    def consume_pt_dirty(self):
        """-> (all_dirty, sorted dirty id array); clears the dirty state."""
        all_dirty = self._pt_dirty_all
        ids = np.fromiter(self._pt_dirty, np.int64, len(self._pt_dirty))
        ids.sort()
        self._pt_dirty_all = False
        self._pt_dirty.clear()
        return all_dirty, ids

    def point_observations(self, pt: int) -> List[Tuple[int, int]]:
        """-> [(kf, slot)] over valid keyframes (CSR lookup, no scan)."""
        _, ks, slots = self.gather_point_obs(np.array([pt], np.int64))
        return [(int(k), int(s)) for k, s in zip(ks, slots)]

    def point_obs_count(self) -> np.ndarray:
        """[P] number of keyframe observations per point. Cached per
        observation-structure generation (recomputed only after mapping
        events; the tracker asks every frame)."""
        if self._obs_count_cache is not None and \
                self._obs_count_cache[0] == self.obs_gen:
            return self._obs_count_cache[1]
        out = self._point_obs_count_impl()
        self._obs_count_cache = (self.obs_gen, out)
        return out

    def obs_index(self):
        """Cached CSR point->(keyframe, slot) observation index, rebuilt
        when the observation structure changes: (offsets [P+1], obs_kf
        [total], obs_slot [total]). This is the array form of the
        reference's MapPoint::mObservations."""
        if self._obs_index_cache is not None and \
                self._obs_index_cache[0] == self.obs_gen:
            return self._obs_index_cache[1]
        idx = native.invert_obs_slots(self.kf_pt, self.kf_valid,
                                      self.cap.max_points)
        self._obs_index_cache = (self.obs_gen, idx)
        return idx

    def _obs_index_plain(self):
        """Plain numpy version of the native index ``obs_index`` caches."""
        ks, slots = np.nonzero((self.kf_pt >= 0) & self.kf_valid[:, None])
        pids = self.kf_pt[ks, slots]
        order = np.argsort(pids, kind="stable")
        counts = np.bincount(pids, minlength=self.cap.max_points)
        offsets = np.zeros(self.cap.max_points + 1, np.int32)
        np.cumsum(counts, out=offsets[1:])
        return (offsets, ks[order].astype(np.int32),
                slots[order].astype(np.int32))

    def gather_point_obs(self, pids: np.ndarray):
        """All observations of the given points from the CSR index:
        -> (seg_id [M] int — row into pids, obs_kf [M], obs_slot [M]).
        Only touches the points' own segments (no [K, N] scan)."""
        offsets, obs_kf, obs_slot = self.obs_index()
        pids = np.asarray(pids, np.int64)
        starts = offsets[pids].astype(np.int64)
        lens = (offsets[pids + 1] - offsets[pids]).astype(np.int64)
        total = int(lens.sum())
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z.astype(np.int32), z.astype(np.int32)
        seg_id = np.repeat(np.arange(len(pids)), lens)
        base = np.concatenate(([0], np.cumsum(lens)[:-1]))
        flat = np.arange(total) + np.repeat(starts - base, lens)
        return seg_id, obs_kf[flat], obs_slot[flat]

    def _point_obs_count_impl(self) -> np.ndarray:
        return native.point_obs_count(self.kf_pt, self.kf_valid,
                                      self.cap.max_points).astype(np.int64)

    def _point_obs_count_plain(self) -> np.ndarray:
        """Plain numpy version of ``_point_obs_count_impl``."""
        p = self.cap.max_points
        counts = np.zeros(p + 1, np.int64)
        obs = self.kf_pt[self.kf_valid]
        flat = obs[obs >= 0]
        np.add.at(counts, flat, 1)
        return counts[:p]

    def erase_point(self, pt: int) -> None:
        """MapPoint::SetBadFlag."""
        self.erase_points(np.array([pt], np.int64))

    def erase_points(self, pts: np.ndarray) -> None:
        """Batched SetBadFlag: one CSR lookup clears every observation of
        every listed point."""
        pts = np.asarray(pts, np.int64)
        if len(pts) == 0:
            return
        _, ks, slots = self.gather_point_obs(pts)
        self.kf_pt[ks, slots] = -1
        self.pt_valid[pts] = False
        self._pt_free.extend(int(p) for p in pts)
        self.obs_gen = next(_DIRTY_GEN)
        self.mark_pts_dirty(pts)

    def replace_point(self, old: int, new: int) -> None:
        """MapPoint::Replace: redirect all observations of `old` to `new`, keeping at most one
        observation per keyframe, then kill `old`."""
        self.replace_points([(old, new)])

    def replace_points(self, pairs) -> None:
        """Batched MapPoint::Replace over (old, new) pairs. Chains are
        resolved first (a->b, b->c => a's observations land on c); each
        keyframe keeps at most one observation of the final point. One CSR
        lookup for all victims replaces per-pair [K, N] scans."""
        if not pairs:
            return
        # resolve redirect chains with path compression
        redirect = {}
        for old, new in pairs:
            redirect[int(old)] = int(new)

        def _final(p: int) -> int:
            seen = []
            while p in redirect:
                seen.append(p)
                p = redirect[p]
                if p in seen:  # cycle (a<->b): keep the last target
                    break
            for s in seen:
                redirect[s] = p
            return p

        victims = np.array(sorted(redirect.keys()), np.int64)
        targets = np.array([_final(int(v)) for v in victims], np.int64)
        live = targets != victims
        victims, targets = victims[live], targets[live]
        if len(victims) == 0:
            return
        seg, ks, slots = self.gather_point_obs(victims)
        new_pid = targets[seg]
        # apply redirects, then dedup per keyframe: a kf that already saw
        # the target keeps its ORIGINAL observation and drops the redirected
        # one; duplicates among redirects keep one
        self.kf_pt[ks, slots] = new_pid.astype(np.int32)
        for k in np.unique(ks):
            row = self.kf_pt[k]
            red = np.zeros(len(row), bool)
            red[slots[ks == k]] = True
            vi = np.nonzero(row >= 0)[0]
            # sort by (pid, redirected-last, slot); keep the first of each pid
            order = np.lexsort((vi, red[vi], row[vi]))
            vi = vi[order]
            pid_sorted = row[vi]
            dup = np.zeros(len(vi), bool)
            dup[1:] = pid_sorted[1:] == pid_sorted[:-1]
            row[vi[dup]] = -1
        # found/visible accumulate along the chains
        np.add.at(self.pt_found, targets, self.pt_found[victims])
        np.add.at(self.pt_visible, targets, self.pt_visible[victims])
        self.pt_replaced[victims] = targets
        self.pt_replaced_stamp[victims] = self.pt_stamp[targets]
        self.pt_valid[victims] = False
        self._pt_free.extend(int(v) for v in victims)
        self.obs_gen = next(_DIRTY_GEN)
        self.mark_pts_dirty(victims)

    def resolve_replaced(self, ids: np.ndarray,
                         stamp_snap: int) -> Tuple[np.ndarray, int, int]:
        """Point ids taken when the map's point counter stood at `stamp_snap`,
        as they stand now (Tracking::CheckReplacedInLastFrame). A point is a
        life of its slot, (slot, stamp), and the life an id means is its
        slot's last one begun before the snapshot: the current one, or the
        previous one where the slot was handed out again since (the record
        is one life deep). A valid life stays; a merged one is followed
        through the replacement table to the valid point it ended in, each
        hop landing on the target slot's current or previous life by the
        stamp the merge recorded. An id erased without a replacement, a
        slot handed out twice since the snapshot (or a hop's target handed
        out twice since the merge), a cycle, or a chain through any of these
        becomes -1. Chains are bounded by the capacity. -> (int32 ids, the
        shape of `ids`; how many were resolved through a previous life,
        which the table alone would have lost; how many were lost because a
        slot was handed out more than once, an upper bound, since the life
        lost may have been erased rather than merged)."""
        ids = np.asarray(ids)
        flat = ids.ravel()
        out = np.full(flat.shape, -1, np.int32)
        safe = np.clip(flat, 0, self.cap.max_points - 1)
        held = flat >= 0
        current = held & (self.pt_stamp[safe] < stamp_snap)
        live = current & self.pt_valid[safe]
        out[live] = flat[live]
        prev_stamp = self.pt_prev_stamp[safe]
        handed_out = held & ~current
        previous = handed_out & (prev_stamp >= 0) & (prev_stamp < stamp_snap)
        n_lost = int((handed_out & (prev_stamp >= stamp_snap)).sum())
        at = np.flatnonzero((current & ~live) | previous)
        via_prev, cur = previous[at], safe[at]
        nxt = np.where(via_prev, self.pt_prev_replaced[cur], self.pt_replaced[cur])
        want = np.where(via_prev, self.pt_prev_replaced_stamp[cur],
                        self.pt_replaced_stamp[cur])
        n_reused = 0
        for _ in range(self.cap.max_points):
            keep = nxt >= 0
            at, nxt, want, via_prev = at[keep], nxt[keep], want[keep], via_prev[keep]
            if not len(at):
                break
            now = self.pt_stamp[nxt] == want
            before = ~now & (self.pt_prev_stamp[nxt] == want)
            n_lost += int((~now & ~before).sum())
            done = now & self.pt_valid[nxt]
            out[at[done]] = nxt[done]
            n_reused += int(via_prev[done].sum())
            go = (now | before) & ~done
            at, cur, before = at[go], nxt[go], before[go]
            via_prev = via_prev[go] | before
            nxt = np.where(before, self.pt_prev_replaced[cur], self.pt_replaced[cur])
            want = np.where(before, self.pt_prev_replaced_stamp[cur],
                            self.pt_replaced_stamp[cur])
        return out.reshape(ids.shape), n_reused, n_lost

    def erase_keyframe(self, kf: int) -> None:
        """KeyFrame::SetBadFlag: drop observations; re-parent children to this KF's parent; record
        the relative pose to the parent for trajectory recovery."""
        par = int(self.kf_parent[kf])
        if par >= 0 and self.kf_valid[par]:
            tcp = self.kf_pose[kf] @ np.linalg.inv(self.kf_pose[par])
            self.dead_kf[(kf, int(self.kf_order[kf]))] = (
                par, int(self.kf_order[par]), tcp.astype(np.float32))
        self.kf_pt[kf] = -1
        children = np.where(self.kf_parent == kf)[0]
        self.kf_parent[children] = self.kf_parent[kf]
        self.kf_valid[kf] = False
        self.kf_order[kf] = -1
        self._kf_free.append(kf)
        self.obs_gen = next(_DIRTY_GEN)

    def resolve_kf_pose(self, kf: int, order: int):
        """Tcw of a (possibly culled) keyframe identified by (slot, order):
        live slots return their current pose; culled ones chain Tcp factors
        up the spanning tree to the first live ancestor. None if the chain
        is broken."""
        t_acc = np.eye(4, dtype=np.float32)
        for _ in range(self.cap.max_keyframes + 1):
            if self.kf_valid[kf] and self.kf_order[kf] == order:
                return t_acc @ self.kf_pose[kf]
            entry = self.dead_kf.get((kf, order))
            if entry is None:
                return None
            par, par_order, tcp = entry
            t_acc = t_acc @ tcp
            kf, order = par, par_order
        return None

    # ------------------------------------------------------------------
    # device-resident mirrors (shared by the tracker and the local mapper;
    # callers hold the map lock)
    # ------------------------------------------------------------------
    def device_mirror(self, device):
        """Synced point mirror on `device` (slammap/device_map)."""
        from orbslam2_tpu_torch.slammap.device_map import DeviceMapMirror
        mir = self._device_mirror
        if mir is None or mir.device != torch.device(device):
            mir = self._device_mirror = DeviceMapMirror(device)
        mir.sync(self)
        return mir

    def device_kf_store(self, device):
        """Synced keyframe store on `device` (slammap/device_map)."""
        from orbslam2_tpu_torch.slammap.device_map import DeviceKFStore
        store = self._device_kf_store
        if store is None or store.device != torch.device(device):
            store = self._device_kf_store = DeviceKFStore(device)
        store.sync(self)
        return store

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------
    def incidence(self) -> np.ndarray:
        """[K, P] bool: keyframe k observes point p."""
        k, p = self.cap.max_keyframes, self.cap.max_points
        inc = np.zeros((k, p), bool)
        kk, slots = np.where(self.kf_pt >= 0)
        inc[kk, self.kf_pt[kk, slots]] = True
        inc[~self.kf_valid] = False
        inc[:, ~self.pt_valid] = False
        return inc

    def update_point_descriptor_and_normal(self, pts: np.ndarray, scale_factor: float,
                                           n_levels: int) -> None:
        """Batch re-compute representative descriptor (min median Hamming,
        MapPoint::ComputeDistinctiveDescriptors) and viewing normal / scale
        band (UpdateNormalAndDepth) by the native engine;
        ``point_stats.update_points`` is its plain version."""
        pts = np.asarray(pts, np.int64)
        self.mark_pts_dirty(pts)
        native.update_point_stats(self, pts, scale_factor, n_levels)

    def increase_visible(self, pts: np.ndarray) -> None:
        self.pt_visible[pts] += 1

    def increase_found(self, pts: np.ndarray) -> None:
        self.pt_found[pts] += 1

    def found_ratio(self) -> np.ndarray:
        return self.pt_found / np.maximum(self.pt_visible, 1)

    def clear(self) -> None:
        """Map::clear."""
        self.__init__(self.cap)

    # ------------------------------------------------------------------
    # persistence — with an array map it is one npz, in the same format as
    # the JAX package's MapState.save.
    # ------------------------------------------------------------------
    _SAVE_FIELDS = [
        "kf_valid", "kf_pose", "kf_timestamp", "kf_frame_id", "kf_kp_xy",
        "kf_kp_octave", "kf_kp_angle", "kf_kp_response", "kf_kp_desc",
        "kf_kp_valid", "kf_kp_ur", "kf_kp_depth", "kf_pt", "kf_parent",
        "kf_order", "pt_valid", "pt_pos", "pt_desc", "pt_normal",
        "pt_min_dist", "pt_max_dist", "pt_ref_kf", "pt_first_kf",
        "pt_visible", "pt_found", "pt_first_frame", "pt_stamp",
    ]

    def save(self, path: str) -> None:
        data = {f: getattr(self, f) for f in self._SAVE_FIELDS}
        data["cap"] = np.array([self.cap.max_keyframes, self.cap.max_points,
                                self.cap.n_features])
        data["kf_counter"] = np.array([self._kf_counter])
        data["loop_edges"] = np.array(
            [[k, e] for k in range(self.cap.max_keyframes)
             for e in self.kf_loop_edges[k]], np.int64).reshape(-1, 2)
        np.savez_compressed(path, **data)

    @classmethod
    def load(cls, path: str) -> "MapState":
        z = np.load(path)
        cap = MapCapacity(*[int(v) for v in z["cap"]])
        m = cls(cap)
        for f in cls._SAVE_FIELDS:
            if f in z:  # tolerate maps saved before a field existed
                getattr(m, f)[...] = z[f]
        m._kf_counter = int(z["kf_counter"][0])
        m._pt_counter = int(m.pt_stamp.max()) + 1
        for k, e in z["loop_edges"]:
            m.kf_loop_edges[int(k)].add(int(e))
        m._kf_free = [k for k in range(cap.max_keyframes - 1, -1, -1)
                      if not m.kf_valid[k]]
        m._pt_free = [p for p in range(cap.max_points - 1, -1, -1)
                      if not m.pt_valid[p]]
        return m
