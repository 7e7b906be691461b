"""Local mapping: keyframe processing, point culling, triangulation, fusion,
local BA and keyframe culling.

Counterpart of ``orbslam2_tpu/frontend/local_mapping.py`` (the reference's
LocalMapping thread). Each stage is the batched-array form of the
reference's:

- ProcessNewKeyFrame: new points enter probation
- MapPointCulling: found-ratio / observation-count gates
- CreateNewMapPoints: epipolar matching + triangulation against the best
  covisible neighbours (frontend/triangulation)
- SearchInNeighbors: two-ring neighbour fusion through one windowed-match
  call (frontend/kernels.fuse_targets) + observation-count arbitration
- LocalBundleAdjustment: backend/ba Schur LM on the covisibility window
- KeyFrameCulling: >= 90 %-redundant keyframes removed

Host bookkeeping is numpy on the shared MapState; the searches and the BA
solve are tensors on the mapper's device, fed from the device point mirror
and keyframe store.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List

import numpy as np
import torch

from orbslam2_tpu_torch import resolve_device
from orbslam2_tpu_torch.backend import ba, solve_program
from orbslam2_tpu_torch.frontend import kernels
from orbslam2_tpu_torch.frontend.triangulation import triangulate_neighbors
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops.orb import Keypoints
from orbslam2_tpu_torch.slammap import covisibility
from orbslam2_tpu_torch.slammap.mapstate import MapState
from orbslam2_tpu_torch.utils.profiling import StageTimer

_log = logging.getLogger("orbslam2_tpu_torch")


def size_bucket(n: int, floor: int, growth: int = 4,
                cap: int | None = None) -> int:
    """Smallest padded capacity >= n from a geometric series; `cap` bounds
    the bucket (e.g. at the map capacity). The BA problem is padded as the
    JAX package pads it, so both packages stage the same arrays."""
    b = floor
    while b < n:
        b *= growth
    if cap is not None:
        b = min(b, max(cap, floor))
    return b


@dataclasses.dataclass
class LocalMapperConfig:
    scale_factor: float = 1.2
    n_levels: int = 8
    # hard caps for the local-BA window; None (default) = unbounded: the full
    # first covisibility ring and every observation enter the problem. An
    # int truncates with a logged warning.
    ba_max_cams: int | None = None
    ba_max_points: int | None = None
    ba_max_obs: int | None = None
    # candidate cap of one fuse call
    fuse_max_points: int = 4096
    cull_found_ratio: float = 0.25   # MapPointCulling
    cull_min_obs_age2: int = 3       # stereo/RGB-D: >= 3 obs within 2 KFs
    kf_cull_redundancy: float = 0.9  # KeyFrameCulling
    fuse_radius: float = 3.0         # Fuse search radius base
    triangulation_neighbors: int = 10  # 20 for mono
    monocular: bool = False


def kf_keypoints(m: MapState, kf: int, device) -> Keypoints:
    """A stored keyframe's features as a Keypoints struct on `device`. Every
    field is a fresh tensor built from the map's rows (`size` is ones, as in
    the JAX package): nothing aliases the extractor's shared tensors."""
    return Keypoints(
        xy=torch.tensor(m.kf_kp_xy[kf], device=device),
        response=torch.tensor(m.kf_kp_response[kf], device=device),
        angle=torch.tensor(m.kf_kp_angle[kf], device=device),
        octave=torch.tensor(m.kf_kp_octave[kf], device=device),
        size=torch.ones(m.cap.n_features, dtype=torch.float32, device=device),
        desc=torch.tensor(m.kf_kp_desc[kf].view(np.int32), device=device),
        valid=torch.tensor(m.kf_kp_valid[kf], device=device),
    )


class LocalMapper:
    TRI_OUT_CAP = 1024   # survivors fetched across all neighbours
    FUSE_T_CAP = 24      # target batch of one fuse call

    def __init__(self, m: MapState, cam: PinholeCamera,
                 cfg: LocalMapperConfig | None = None, device="cuda"):
        self.map = m
        self.cam = cam
        self.cfg = cfg or LocalMapperConfig()
        self.device = resolve_device(device)
        # recent points under probation: pt_id -> kf order at creation
        self._recent: Dict[int, int] = {}
        self.interrupt_ba = False  # InterruptBA analogue
        # CheckNewKeyFrames probe, wired by the mapping worker: True when
        # more keyframes wait in its queue
        self.pending_fn = None
        self.stats = StageTimer(enabled=False)  # enabled with profile_stages
        # counters of what the stages did (read by drives and tests);
        # ba_skipped counts the keyframes whose local BA was skipped, and
        # ba_interrupted and ba_backlog its two causes (both may hold)
        self.counts = dict(points_created=0, obs_fused=0, points_merged=0,
                           kf_culled=0, ba_applied=0, ba_dropped=0,
                           ba_skipped=0, ba_interrupted=0, ba_backlog=0,
                           conflicts=0)
        # map lock, shared with the tracker (SLAMSystem wires the tracker's
        # RLock in). As the reference's LocalMapping thread, each stage takes
        # it only around host-state reads and writes, not across its device
        # work: stage under the lock, search or solve unlocked, apply under
        # the lock with re-validation. Under the synchronous path the
        # tracker's re-entrant lock makes these no-ops.
        self.map_lock = threading.RLock()
        self.kfdb = None  # the keyframe database, set by SLAMSystem with a vocabulary
        # the local BA as a program (CUDA graphs of its parts on a card, the
        # eager solve on the CPU), captured once per padded problem size
        self.ba_program = solve_program.BundleAdjustProgram(self.device)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, backlog: bool = False) -> None:
        """`backlog`: more keyframes are already queued behind this one (the
        tracker is outrunning mapping). Triangulation and fusion then run
        atomically under the map lock, which throttles the tracker and lets
        mapping catch up, as the reference's AcceptKeyFrames gate does; at a
        sustainable cadence the optimistic path never blocks the tracker."""
        m = self.map
        with self.stats.stage("mp_culling"), self.map_lock:
            order = int(m.kf_order[kf])
            # register newly created points for probation
            for pid in np.unique(m.kf_pt[kf]):
                if pid >= 0 and pid not in self._recent \
                        and m.pt_first_kf[pid] == kf:
                    self._recent[pid] = order
            self._map_point_culling(order)
            w = covisibility.weight_matrix(m)
        # Triangulation and fusion apply association decisions (new point
        # pairs, merges) whose geometric validity was checked against the
        # staged snapshot; applied to a map the tracker moved on meanwhile
        # they merge distinct physical points (the JAX package measured
        # tracking collapse from it). They run OPTIMISTICALLY: snapshot and
        # generation capture under the lock, search unlocked, apply under
        # the lock only if the map's generation counters prove nothing
        # changed; on a conflict the stage reruns atomically. The local-BA
        # solve runs unlocked unconditionally, as in the reference.
        def _atomic(stage_fn):
            # the conflicting mutation may have changed covisibility (or
            # culled this keyframe / reset the map): re-derive the weights
            # inside the lock before re-staging
            with self.map_lock:
                if not m.kf_valid[kf]:
                    return
                stage_fn(kf, covisibility.weight_matrix(m), atomic=True)

        def _pending() -> bool:
            """More keyframes already queued (CheckNewKeyFrames): the
            reference then skips fusion, local BA and culling to drain the
            queue; the next keyframe's pass covers the skipped work."""
            if self.pending_fn is not None and self.pending_fn():
                return True
            return backlog

        with self.stats.stage("triangulate"):
            if backlog:
                _atomic(self._create_new_map_points)
            elif self._create_new_map_points(kf, w) == "conflict":
                self.counts["conflicts"] += 1
                _atomic(self._create_new_map_points)
        if not _pending():
            with self.stats.stage("fuse"):
                if self._search_in_neighbors(kf, w) == "conflict":
                    self.counts["conflicts"] += 1
                    _atomic(self._search_in_neighbors)
                with self.map_lock:
                    pts = np.unique(m.kf_pt[kf])
                    pts = pts[pts >= 0]
                    m.update_point_descriptor_and_normal(
                        pts, self.cfg.scale_factor, self.cfg.n_levels)
        # InterruptBA: a tracker that wanted to insert while the earlier
        # stages ran, or a queued keyframe, skips the local BA and culling;
        # the window is optimized again with the next keyframe. The flag is
        # honoured at the stage boundary.
        aborted = self.interrupt_ba
        self.interrupt_ba = False
        queued = _pending()
        if aborted or queued:
            self.counts["ba_skipped"] += 1
            self.counts["ba_interrupted"] += aborted
            self.counts["ba_backlog"] += queued
        else:
            if m.n_keyframes() > 2:
                with self.stats.stage("local_ba"):
                    with self.map_lock:
                        w = covisibility.weight_matrix(m)
                    self._local_ba(kf, w)
            with self.stats.stage("kf_culling"), self.map_lock:
                self._keyframe_culling(kf, covisibility.weight_matrix(m))
        with self.map_lock:
            m.change_index += 1

    # ------------------------------------------------------------------
    # MapPointCulling
    # ------------------------------------------------------------------
    def _map_point_culling(self, current_order: int) -> None:
        m = self.map
        obs_count = m.point_obs_count()
        found_ratio = m.found_ratio()
        drop: List[int] = []
        done: List[int] = []
        for pid, born in self._recent.items():
            if not m.pt_valid[pid]:
                done.append(pid)
                continue
            age = current_order - born
            if found_ratio[pid] < self.cfg.cull_found_ratio:
                drop.append(pid)
            elif age >= 2 and obs_count[pid] < self.cfg.cull_min_obs_age2:
                drop.append(pid)
            elif age >= 3:
                done.append(pid)  # survived probation
        m.erase_points(np.array(drop, np.int64))
        done.extend(drop)
        for pid in done:
            self._recent.pop(pid, None)

    # ------------------------------------------------------------------
    # CreateNewMapPoints
    # ------------------------------------------------------------------
    def scene_median_depth(self, kf: int) -> float:
        """KeyFrame::ComputeSceneMedianDepth."""
        m = self.map
        pids = m.kf_pt[kf][m.kf_pt[kf] >= 0]
        pids = pids[m.pt_valid[pids]]
        if len(pids) == 0:
            return -1.0
        tcw = m.kf_pose[kf]
        z = (m.pt_pos[pids] @ tcw[:3, :3].T + tcw[:3, 3])[:, 2]
        return float(np.median(z))

    @property
    def _nb_cap(self) -> int:
        """Neighbours of one triangulation call: stereo/RGB-D triangulates
        against 10 covisible neighbours, mono against 20."""
        return 24 if self.cfg.monocular else 12

    def _map_gens(self):
        """Generation triple covering every mutation that can invalidate a
        staged association decision: observation edits (obs_gen), point
        add/erase/move (pt_dirty_gen), keyframe add/erase (kf_dirty_gen)."""
        m = self.map
        return (m.obs_gen, m.pt_dirty_gen, m.kf_dirty_gen)

    def _create_new_map_points(self, kf: int, w: np.ndarray,
                               atomic: bool = False):
        m = self.map
        cfg = self.cfg
        dev = self.device
        # --- stage under the lock -------------------------------------
        with self.stats.stage("tri_stage"), self.map_lock:
            gens = self._map_gens()
            n_neigh = cfg.triangulation_neighbors * (2 if cfg.monocular else 1)
            neighbors = covisibility.best_covisible(w, kf, n_neigh)
            if len(neighbors) == 0:
                return None
            med_depth1 = self.scene_median_depth(kf)
            c1 = -(m.kf_pose[kf][:3, :3].T @ m.kf_pose[kf][:3, 3])
            # baseline gates on the host
            keep = []
            for nb in map(int, neighbors):
                c2 = -(m.kf_pose[nb][:3, :3].T @ m.kf_pose[nb][:3, 3])
                baseline = float(np.linalg.norm(c2 - c1))
                if cfg.monocular:
                    if med_depth1 > 0 and baseline / med_depth1 < 0.01:
                        continue
                elif baseline < 0.01:
                    continue
                keep.append(nb)
            keep = keep[: self._nb_cap]
            if not keep:
                return None
            store = m.device_kf_store(dev)
            free1 = (m.kf_pt[kf] < 0) & m.kf_kp_valid[kf]
            free2 = (m.kf_pt[np.array(keep)] < 0) & m.kf_kp_valid[np.array(keep)]
            # snapshot: a concurrent sync replaces, never rewrites, them
            a = store.arrays
            pose = store.pose
        # --- search + triangulation + fetch, unlocked ------------------
        with self.stats.stage("tri_dev"):
            res = triangulate_neighbors(
                kf, torch.from_numpy(free1).to(dev), keep,
                torch.from_numpy(free2).to(dev), pose,
                a["kf_kp_xy"], a["kf_kp_desc"], a["kf_kp_octave"],
                a["kf_kp_angle"], a["kf_kp_valid"], a["kf_kp_ur"],
                a["kf_kp_depth"], self.cam, cfg.scale_factor, cfg.n_levels,
                self.TRI_OUT_CAP)
            ints = torch.stack([res.nb_slot, res.idx1, res.kp2_idx]).cpu().numpy()
            points = res.points.cpu().numpy()
        # --- apply under the lock; generation-validated ----------------
        with self.stats.stage("tri_apply"), self.map_lock:
            if not atomic and self._map_gens() != gens:
                return "conflict"  # nothing applied; caller reruns atomically
            nb_slot, idx1, kp2_idx = ints
            rows = np.where(idx1 >= 0)[0]
            nb = np.array(keep, np.int64)[nb_slot[rows]]
            i1 = idx1[rows]
            j2 = kp2_idx[rows]
            # drop pairs whose slots are taken, then first-wins dedup within
            # the batch (the sequential loop's "taken by an earlier pair this
            # round"); survivors arrive in (neighbour, slot) order
            ok = (m.kf_pt[kf, i1] < 0) & (m.kf_pt[nb, j2] < 0)
            rows, nb, i1, j2 = rows[ok], nb[ok], i1[ok], j2[ok]
            _, first = np.unique(i1, return_index=True)
            sel = np.zeros(len(i1), bool)
            sel[first] = True
            pair_key = nb * m.cap.n_features + j2
            pair_key[~sel] = -1  # already dropped
            _, first2 = np.unique(pair_key, return_index=True)
            sel2 = np.zeros(len(i1), bool)
            sel2[first2] = True
            sel &= sel2
            rows, nb, i1, j2 = rows[sel], nb[sel], i1[sel], j2[sel]
            new_pts = m.add_points_batch(points[rows], m.kf_kp_desc[kf, i1], kf,
                                         int(m.kf_frame_id[kf]))
            nb, i1, j2 = (x[: len(new_pts)] for x in (nb, i1, j2))
            if len(new_pts):
                m.kf_pt[kf, i1] = new_pts
                m.kf_pt[nb, j2] = new_pts
                m.touch_obs()
                m.update_point_descriptor_and_normal(
                    new_pts, cfg.scale_factor, cfg.n_levels)
                order = int(m.kf_order[kf])
                for pid in new_pts:
                    self._recent[int(pid)] = order
            self.counts["points_created"] += len(new_pts)
        return None

    # ------------------------------------------------------------------
    # SearchInNeighbors / Fuse
    # ------------------------------------------------------------------
    def _search_in_neighbors(self, kf: int, w: np.ndarray,
                             atomic: bool = False):
        m = self.map
        with self.map_lock:
            gens = None if atomic else self._map_gens()
            targets = list(covisibility.best_covisible(w, kf, 10))
            second_ring: List[int] = []
            for t in targets:
                second_ring.extend(covisibility.best_covisible(w, int(t), 5))
            target_kfs = [int(t) for t in
                          dict.fromkeys([*targets, *second_ring])
                          if t != kf][:20]
            if not target_kfs:
                return None
            own_pts = np.unique(m.kf_pt[kf])
            own_pts = own_pts[own_pts >= 0]
            own_pts = own_pts[m.pt_valid[own_pts]]
            neigh_pts = np.unique(m.kf_pt[np.array(target_kfs)])
            neigh_pts = neigh_pts[neigh_pts >= 0]
            neigh_pts = neigh_pts[m.pt_valid[neigh_pts]]
            # forward (this KF's points into every neighbour) and backward
            # (neighbours' points into this KF) share one fuse call: the
            # per-target candidate mask keeps the reference's semantics
            cand = np.unique(np.concatenate([own_pts, neigh_pts]))
            if len(cand) > self.cfg.fuse_max_points:
                # bounded by the one-chunk optimistic-apply contract
                # (_fuse_matrix); the tail is fused with later keyframes
                _log.warning("SearchInNeighbors candidates truncated: "
                             "%d -> %d", len(cand), self.cfg.fuse_max_points)
                cand = cand[: self.cfg.fuse_max_points]
            if len(cand) == 0:
                return None
            sel_rows = np.zeros((len(target_kfs) + 1, len(cand)), bool)
            sel_rows[:-1] = np.isin(cand, own_pts)[None, :]
            sel_rows[-1] = np.isin(cand, neigh_pts)
        return self._fuse_matrix(cand, [*target_kfs, kf], sel_rows, gens=gens)

    def _fuse_points_into_targets(self, pt_ids: np.ndarray,
                                  targets: List[int]) -> None:
        """One shared candidate set fused into every target (the form loop
        closing's neighbourhood fuse uses). Large candidate sets go in
        fuse_max_points-sized chunks: every point takes part."""
        if len(pt_ids) == 0 or not targets:
            return
        step = self.cfg.fuse_max_points
        for s in range(0, len(pt_ids), step):
            chunk = pt_ids[s:s + step]
            self._fuse_matrix(chunk, targets, np.ones((len(targets), len(chunk)), bool))

    def _fuse_matrix(self, cand: np.ndarray, targets: List[int],
                     sel_rows: np.ndarray, gens=None):
        """ORBmatcher::Fuse of per-target candidate subsets (`sel_rows`
        [T, len(cand)]) into the targets: one fuse call per FUSE_T_CAP
        targets over the resident point mirror + keyframe store, then
        per-target host arbitration (add observation vs duplicate merge
        keeping the better-observed point). With `gens` set, the apply is
        generation-validated and returns "conflict" without applying if the
        map changed since staging."""
        m = self.map
        cap = self.cfg.fuse_max_points
        n = len(cand)
        dev = self.device
        # generation-validated applies are all-or-nothing per call: with
        # more than one chunk, a later conflict would strand the earlier
        # chunk's applied associations
        if gens is not None and len(targets) > self.FUSE_T_CAP:
            raise ValueError("an optimistic fuse takes one target chunk")
        with self.map_lock:
            mir = m.device_mirror(dev)
            store = m.device_kf_store(dev)
            a = store.arrays
            pose = store.pose
            mirror = (mir.pt_pos, mir.pt_desc, mir.pt_valid, mir.pt_normal,
                      mir.pt_min_dist, mir.pt_max_dist)
        ids = np.zeros(cap, np.int64)
        ids[:n] = cand
        ids_d = torch.from_numpy(ids).to(dev)
        for t0 in range(0, len(targets), self.FUSE_T_CAP):
            chunk = targets[t0:t0 + self.FUSE_T_CAP]
            sel = np.zeros((len(chunk), cap), bool)
            sel[:, :n] = sel_rows[t0:t0 + self.FUSE_T_CAP]
            assoc_all = kernels.fuse_targets(
                chunk, pose,
                a["kf_kp_xy"], a["kf_kp_desc"], a["kf_kp_octave"],
                a["kf_kp_angle"], a["kf_kp_valid"],
                ids_d, torch.from_numpy(sel).to(dev), *mirror,
                self.cfg.fuse_radius, self.cam,
                self.cfg.scale_factor, self.cfg.n_levels, 50).cpu().numpy()
            with self.map_lock:
                if gens is not None and self._map_gens() != gens:
                    return "conflict"
                for i, t in enumerate(chunk):
                    self._apply_fuse_assoc(cand, t, assoc_all[i])
                if gens is not None:
                    gens = self._map_gens()  # our applies advanced them
        return None

    def _apply_fuse_assoc(self, pt_ids: np.ndarray, kf: int,
                          assoc: np.ndarray) -> None:
        """Host arbitration for one target's fuse matches (ORBmatcher::Fuse
        tail): candidates the keyframe already observes are skipped; a match
        onto an occupied slot merges, keeping the better-observed point."""
        m = self.map
        row = m.kf_pt[kf]
        seen = set(int(p) for p in row[row >= 0])
        obs_count = m.point_obs_count()
        replaces = []
        for slot in np.where(assoc >= 0)[0]:
            pid = int(pt_ids[assoc[slot]])
            if not m.pt_valid[pid] or pid in seen:
                continue
            existing = int(m.kf_pt[kf, slot])
            if existing >= 0 and m.pt_valid[existing]:
                # duplicate: keep the better-observed point
                if obs_count[existing] >= obs_count[pid]:
                    replaces.append((pid, existing))
                else:
                    replaces.append((existing, pid))
            else:
                m.add_observation(kf, slot, pid)
                seen.add(pid)
                self.counts["obs_fused"] += 1
        # one batched Replace for all duplicates
        m.replace_points(replaces)
        self.counts["points_merged"] += len(replaces)

    # ------------------------------------------------------------------
    # Local bundle adjustment
    # ------------------------------------------------------------------
    def _local_ba(self, kf: int, w: np.ndarray) -> None:
        with self.map_lock:
            staged = self._local_ba_stage(kf, w)
            correction_gen = self.map.correction_gen
        if staged is None:
            return
        problem, pt_fixed, apply_ctx = staged
        # solve unlocked: the reference likewise runs the optimization
        # outside the map mutex and takes it only for the write-back
        res = self.ba_program(problem, self.cam, point_fixed=pt_fixed)
        new_poses = res.poses.cpu().numpy()
        new_points = res.points.cpu().numpy()
        inlier = res.inlier.cpu().numpy()
        with self.map_lock:
            # a loop correction / global BA moved the map while the solve was
            # in flight: writing back would revert the local window to
            # pre-correction geometry
            if self.map.correction_gen != correction_gen:
                self.counts["ba_dropped"] += 1
                return
            self._local_ba_apply(apply_ctx, new_poses, new_points, inlier)
            self.counts["ba_applied"] += 1

    def _local_ba_stage(self, kf: int, w: np.ndarray):
        m = self.map
        cfg = self.cfg
        # the full first covisibility ring optimizes; an explicit
        # ba_max_cams truncates with a warning
        local = [kf, *[int(t) for t in covisibility.covisible_neighbors(w, kf)]]
        if cfg.ba_max_cams is not None and len(local) > cfg.ba_max_cams - 1:
            _log.warning("local BA window truncated: %d -> %d cameras",
                         len(local), cfg.ba_max_cams - 1)
            local = local[: cfg.ba_max_cams - 1]
        local_set = set(local)

        # points seen by local KFs (all of them)
        pts = np.unique(m.kf_pt[np.array(local)])
        pts = pts[pts >= 0]
        pts = pts[m.pt_valid[pts]]
        if cfg.ba_max_points is not None and len(pts) > cfg.ba_max_points:
            _log.warning("local BA points truncated: %d -> %d",
                         len(pts), cfg.ba_max_points)
            pts = pts[: cfg.ba_max_points]
        if len(pts) < 20 or len(local) < 2:
            return None

        # fixed cameras: other KFs observing these points (second ring), one
        # CSR gather over the window's points
        _, obs_kf_ids, _ = m.gather_point_obs(pts)
        sees = np.zeros(m.cap.max_keyframes, bool)
        sees[obs_kf_ids] = True
        sees &= m.kf_valid
        fixed = [int(k) for k in np.where(sees)[0] if k not in local_set]
        n_free = len(local)
        cams = [*local, *fixed]
        if cfg.ba_max_cams is not None and len(cams) > cfg.ba_max_cams:
            cams = cams[: cfg.ba_max_cams]
        cam_slot = {int(c): i for i, c in enumerate(cams)}
        cam_cap = size_bucket(len(cams), 16, 2, m.cap.max_keyframes)
        pt_cap = size_bucket(len(pts), 1024, 4, m.cap.max_points)

        # gauge: without out-of-window fixed observers, fix the two oldest
        # local KFs (one pins the SE3 gauge, the second monocular scale)
        cam_fixed = np.zeros(cam_cap, bool)
        cam_fixed[n_free:] = True
        if len(fixed) == 0:
            order = np.argsort([m.kf_order[c] for c in local])
            cam_fixed[order[0]] = True
            if len(local) > 2:
                cam_fixed[order[1]] = True

        # The problem is staged in float64 (the JAX package solves in
        # float32). The reduced camera system is a small difference of large
        # sums; in float32 its rounding, which on a GPU also follows the order
        # of the atomic sums, steers the 15 LM steps: on the 640x480 drive's
        # last window float32 solves ended 1-10 mm from the window's minimum
        # and from each other, float64 solves on the card and on the CPU
        # within 1e-11 m of each other (an H100 and its host's CPU;
        # chip_smoke.py phase 6 solves that window both ways).
        poses = np.tile(np.eye(4), (cam_cap, 1, 1))
        cams_arr = np.array(cams, np.int32)
        poses[: len(cams)] = m.kf_pose[cams_arr]
        points = np.zeros((pt_cap, 3))
        points[: len(pts)] = m.pt_pos[pts]

        # observations from all included cameras through a point-id ->
        # BA-slot lookup table
        pt_lut = np.full(m.cap.max_points, -1, np.int32)
        pt_lut[pts] = np.arange(len(pts), dtype=np.int32)
        sub = m.kf_pt[cams_arr]                      # [C, N]
        pslot = np.where(sub >= 0, pt_lut[np.maximum(sub, 0)], -1)
        ci_idx, slot_idx = np.nonzero(pslot >= 0)
        n_obs = len(ci_idx)
        if cfg.ba_max_obs is not None and n_obs > cfg.ba_max_obs:
            _log.warning("local BA observations truncated: %d -> %d",
                         n_obs, cfg.ba_max_obs)
            n_obs = cfg.ba_max_obs
        if n_obs < 30:
            return None
        obs_cap = size_bucket(n_obs, 4096, 4,
                              cfg.ba_max_obs if cfg.ba_max_obs else None)
        ci_idx, slot_idx = ci_idx[:n_obs], slot_idx[:n_obs]
        sel_kf = cams_arr[ci_idx]
        ur = m.kf_kp_ur[sel_kf, slot_idx]
        inv_sig_base = 1.0 / cfg.scale_factor ** 2
        o_cam = np.zeros(obs_cap, np.int64)
        o_pt = np.zeros(obs_cap, np.int64)
        o_uv = np.zeros((obs_cap, 3))
        o_sig = np.ones(obs_cap)
        o_st = np.zeros(obs_cap, bool)
        o_val = np.zeros(obs_cap, bool)
        o_cam[:n_obs] = ci_idx
        o_pt[:n_obs] = pslot[ci_idx, slot_idx]
        o_uv[:n_obs, :2] = m.kf_kp_xy[sel_kf, slot_idx]
        o_uv[:n_obs, 2] = np.maximum(ur, -1.0)
        o_sig[:n_obs] = inv_sig_base ** m.kf_kp_octave[sel_kf, slot_idx]
        o_st[:n_obs] = ur >= 0
        o_val[:n_obs] = True

        dev = self.device
        problem = ba.BAProblem(*(torch.from_numpy(x).to(dev) for x in (
            poses, points, cam_fixed, o_cam, o_pt, o_uv, o_sig, o_st, o_val)))
        pt_fixed = np.zeros(pt_cap, bool)
        pt_fixed[len(pts):] = True
        apply_ctx = (cam_slot, cam_fixed, pts, sel_kf, slot_idx, n_obs)
        return problem, torch.from_numpy(pt_fixed).to(dev), apply_ctx

    def _local_ba_apply(self, apply_ctx, new_poses: np.ndarray,
                        new_points: np.ndarray, inlier: np.ndarray) -> None:
        """Write back BA results under the map lock, re-validating against
        mutations that landed while the solve ran unlocked."""
        m = self.map
        cam_slot, cam_fixed, pts, sel_kf, slot_idx, n_obs = apply_ctx
        for c, i in cam_slot.items():
            if not cam_fixed[i] and m.kf_valid[c]:
                m.kf_pose[c] = new_poses[i]
        still = m.pt_valid[pts]
        m.pt_pos[pts[still]] = new_points[: len(pts)][still]
        m.mark_pts_dirty(pts[still])
        # erase outlier observations; the staging kept each observation's
        # (kf, slot), so this is one scatter
        bad = ~inlier[:n_obs]
        if bad.any():
            m.kf_pt[sel_kf[bad], slot_idx[bad]] = -1
            m.touch_obs()

    # ------------------------------------------------------------------
    # KeyFrameCulling
    # ------------------------------------------------------------------
    def _keyframe_culling(self, kf: int, w: np.ndarray) -> None:
        m = self.map
        obs_count = m.point_obs_count()
        # gauge anchors: never cull the two oldest surviving keyframes (the
        # reference protects only the first; with the two-anchor local-BA
        # gauge, culling the second re-seats the scale anchor)
        live_orders = np.sort(m.kf_order[m.kf_valid & (m.kf_order >= 0)])
        protected = set(live_orders[:2].tolist())
        for cand in covisibility.covisible_neighbors(w, kf):
            cand = int(cand)
            if int(m.kf_order[cand]) in protected:
                continue
            slots = np.where(m.kf_pt[cand] >= 0)[0]
            if len(slots) == 0:
                continue
            pids = m.kf_pt[cand, slots]
            live = m.pt_valid[pids]
            slots, pids = slots[live], pids[live]
            if len(slots) == 0:
                continue
            cand_oct = m.kf_kp_octave[cand, slots]
            # count, per point, other-KF observations at octave <= oct_c+1
            # through the CSR index (which holds only valid KFs)
            seg, oks, osl = m.gather_point_obs(pids.astype(np.int64))
            other = oks != cand
            finer_obs = other & (m.kf_kp_octave[oks, osl] <= cand_oct[seg] + 1)
            finer = np.bincount(seg[finer_obs], minlength=len(pids))
            redundant = int(((obs_count[pids] >= 3) & (finer >= 3)).sum())
            if redundant > self.cfg.kf_cull_redundancy * len(slots):
                m.erase_keyframe(cand)
                if self.kfdb is not None:
                    self.kfdb.erase(cand)
                self.counts["kf_culled"] += 1
