"""Loop closing: detection, Sim3 computation, correction, pose graph, GBA.

Counterpart of ``orbslam2_tpu/frontend/loop_closing.py`` (the reference's
LoopClosing thread). It runs once per processed keyframe (on the mapping
worker's thread, or inline at insertion without a worker). The stages:

- DetectLoop: at least 10 keyframes since the last loop, a minimum score
  from the covisible neighbours' BoW scores, keyframe-database candidates,
  covisibility-consistency chaining over consecutive detections;
- ComputeSim3: per candidate, descriptor matching of map points, Sim3
  RANSAC (scale frozen for stereo and RGB-D), the SearchBySim3 expansion,
  OptimizeSim3 (>= 20 inliers), then the loop neighbourhood projected into
  the keyframe (>= 40 matches);
- CorrectLoop: the Sim3 propagated to the covisible window, window points
  remapped through their first observer, loop-point fusion, the essential
  graph, and a global BA on a snapshot of the map, on a thread of its own
  when `async_gba` is set.

Host bookkeeping is numpy on the shared MapState; matching, RANSAC, the
Sim3 optimization, the essential graph and the global BA run on the loop
closer's device. The essential graph and the global BA are staged in
float64: on a GPU, float32 sums over thousands of edges or observations in
atomic order land their solves millimetres apart (the local mapper stages
its BA in float64 for the same reason). The RANSAC sets are drawn from a
torch generator seeded as the JAX package seeds jax.random.

Unlike the JAX package, a global BA that fails on its thread is not lost:
its exception is kept and raised by ``wait_gba`` and by the next
``process_keyframe``, on the caller's thread.
"""
from __future__ import annotations

import atexit
import dataclasses
import threading
import time
import weakref
from typing import List, Optional, Set

import numpy as np
import torch

from orbslam2_tpu_torch import resolve_device
from orbslam2_tpu_torch.backend import ba, pose_graph, sim3_opt, solve_program
from orbslam2_tpu_torch.frontend import kernels
from orbslam2_tpu_torch.frontend.local_mapping import (
    LocalMapper, LocalMapperConfig, kf_keypoints, size_bucket)
from orbslam2_tpu_torch.geometry import sim3_np
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops import hamming
from orbslam2_tpu_torch.slammap import covisibility
from orbslam2_tpu_torch.slammap.keyframe_db import KeyFrameDatabase
from orbslam2_tpu_torch.slammap.mapstate import MapState
from orbslam2_tpu_torch.solvers import horn
from orbslam2_tpu_torch.utils import graph_capture
from orbslam2_tpu_torch.utils.profiling import StageTimer

RANSAC_ITERS = 300
# padded sizes of the solves' problems, so that their programs are replayed
# and not captured again per loop. A padded row costs its share of a solve:
# on an H100 a GBA of 25 200 observations kept the card busy 71.5 ms
# unpadded, 89.2 in 32 768 slots and 190.9 in 65 536, and an essential
# graph of 66 edges 99.4 ms in 256 slots, 128.4 in 1 024 and 236.1 in 4 096,
# against 90-120 ms a capture (chip_smoke.py phase 22). So both grow by 2
# (the JAX package pads GBA observations by 4 from the same floor).
GBA_OBS_FLOOR, GBA_OBS_GROWTH = 16384, 2
EG_EDGE_FLOOR, EG_EDGE_GROWTH = 256, 2


@dataclasses.dataclass
class LoopCloserConfig:
    scale_factor: float = 1.2
    n_levels: int = 8
    fix_scale: bool = True            # false for monocular
    consistency_threshold: int = 3    # mnCovisibilityConsistencyTh
    min_kfs_between_loops: int = 10
    recent_exclude: int = 5           # recency exclusion (see KeyFrameDatabase)
    min_sim3_matches: int = 20
    min_sim3_inliers: int = 20
    min_total_matches: int = 40
    run_global_ba: bool = True
    # run the loop's global BA on its own thread on a map snapshot, with
    # spanning-tree propagation of the correction to keyframes and points
    # created while it ran; a newer loop supersedes a GBA in flight
    async_gba: bool = False


def _camera_points(m: MapState, kf: int, pids: np.ndarray) -> np.ndarray:
    t = m.kf_pose[kf]
    return m.pt_pos[pids] @ t[:3, :3].T + t[:3, 3]


def _pad(a: np.ndarray, cap: int, value=0.0) -> np.ndarray:
    """First `cap` rows of `a`, padded to `cap` rows, as float32."""
    a = a[:cap]
    width = [(0, cap - len(a))] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, width, constant_values=value).astype(np.float32)


class LoopCloser:
    def __init__(self, m: MapState, cam: PinholeCamera, kfdb: KeyFrameDatabase,
                 cfg: Optional[LoopCloserConfig] = None, device="cuda"):
        self.map = m
        self.cam = cam
        self.kfdb = kfdb
        self.cfg = cfg or LoopCloserConfig()
        self.device = resolve_device(device)
        self.last_loop_kf_order = -10 ** 9
        # consistency chaining state: list of (group set, chain length)
        self._consistent_groups: List[tuple[Set[int], int]] = []
        self.n_loops_closed = 0
        # map lock, shared with the tracker and the local mapper (SLAMSystem
        # wires the tracker's RLock in)
        self.map_lock: threading.RLock = threading.RLock()
        # global BA supersession (the reference's mnFullBAIdx)
        self.full_ba_idx = 0
        self.n_gba_applied = 0
        self.n_gba_superseded = 0
        # GBA runs started and not yet joined; a superseded run may still be
        # solving beside the newest one
        self._gba_threads: List[threading.Thread] = []
        self.error: Optional[Exception] = None    # a failed GBA thread's
        self.stats = StageTimer(enabled=False)   # enabled with profile_stages
        # the essential graph and the global BA as programs (CUDA graphs on a
        # card, the eager solves on the CPU); two GBAs in flight take turns
        # on the GBA program
        self.eg_program = solve_program.EssentialGraphProgram(self.device)
        self.gba_program = solve_program.BundleAdjustProgram(self.device, pcg=True)
        # each solve's (real, padded) essential-graph edges or global-BA
        # observations, which choose its program's key
        self.solve_sizes = {"essential_graph": [], "gba": []}
        # join a GBA in flight before interpreter teardown: a daemon thread in
        # the middle of a device call when the runtime goes away can abort the
        # process (registered weakly; joining a finished thread is a no-op)
        ref = weakref.ref(self)
        atexit.register(lambda: ref() is not None and ref()._join_gba())

    def reset(self) -> None:
        """Forget the loop history (Tracking::Reset)."""
        self.last_loop_kf_order = -10 ** 9
        self._consistent_groups = []

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, word_ids: np.ndarray) -> bool:
        """-> True if a loop was closed at this keyframe."""
        self._raise_if_failed()
        m = self.map
        w = covisibility.weight_matrix(m)
        with self.stats.stage("detect"):
            candidates = self._detect_loop(kf, word_ids, w)
        self.kfdb.add(kf, word_ids)
        if not candidates:
            return False
        with self.stats.stage("compute_sim3"):
            ok, loop_kf, s_cw = self._compute_sim3(kf, candidates, w)
        if not ok:
            return False
        with self.stats.stage("correct_loop"):
            self._correct_loop(kf, loop_kf, s_cw, w)
        self.last_loop_kf_order = int(m.kf_order[kf])
        self.n_loops_closed += 1
        return True

    # ------------------------------------------------------------------
    # DetectLoop
    # ------------------------------------------------------------------
    def _detect_loop(self, kf: int, word_ids: np.ndarray, w: np.ndarray) -> List[int]:
        m = self.map
        if int(m.kf_order[kf]) - self.last_loop_kf_order < self.cfg.min_kfs_between_loops:
            self._consistent_groups = []
            return []
        if m.n_keyframes() < self.cfg.min_kfs_between_loops:
            return []
        # the lowest score among the covisible neighbours
        v = self.kfdb.voc.bow_vector(word_ids)
        min_score = 1.0
        for nb in covisibility.covisible_neighbors(w, kf):
            if self.kfdb.valid[nb]:
                min_score = min(min_score, self.kfdb.score_kf(v, nb))
        recent = np.abs(m.kf_order - int(m.kf_order[kf])) <= self.cfg.recent_exclude
        cands = self.kfdb.detect_loop_candidates(kf, min_score, w, m,
                                                 exclude_mask=recent, query_bow=v)
        if not cands:
            self._consistent_groups = []
            return []
        # consistency chaining
        enough: List[int] = []
        new_groups: List[tuple[Set[int], int]] = []
        for cand in cands:
            group = set([cand, *map(int, covisibility.covisible_neighbors(w, cand))])
            best_chain = 0
            for prev_group, chain in self._consistent_groups:
                if group & prev_group:
                    best_chain = max(best_chain, chain + 1)
            new_groups.append((group, best_chain))
            if best_chain >= self.cfg.consistency_threshold:
                enough.append(cand)
        self._consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    # ComputeSim3
    # ------------------------------------------------------------------
    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _desc(self, words: np.ndarray) -> torch.Tensor:
        """uint32 descriptor words -> int32 bit-view tensor on the device."""
        return self._dev(np.ascontiguousarray(words).view(np.int32))

    def _stage_pairs(self, kf: int, cand: int, idx1: np.ndarray, idx2: np.ndarray):
        """Camera-frame coordinates and octave sigma^2 of matched keypoint
        pairs, all of them, padded to a size bucket as the JAX package pads
        them (so both packages draw their RANSAC sets from the same arrays).
        -> (p1c, p2c, valid, s1, s2, n) as numpy."""
        m = self.map
        cap = size_bucket(len(idx1), 256, 4, m.cap.n_features)
        n = min(len(idx1), cap)
        valid = np.zeros(cap, bool)
        valid[:n] = True
        sf = self.cfg.scale_factor
        s1 = sf ** (2.0 * m.kf_kp_octave[kf, idx1[:n]])
        s2 = sf ** (2.0 * m.kf_kp_octave[cand, idx2[:n]])
        return (_pad(_camera_points(m, kf, m.kf_pt[kf, idx1]), cap),
                _pad(_camera_points(m, cand, m.kf_pt[cand, idx2]), cap),
                valid, _pad(s1, cap, 1.0), _pad(s2, cap, 1.0), n)

    def _compute_sim3(self, kf: int, candidates: List[int], w: np.ndarray):
        m = self.map
        cfg = self.cfg
        if int((m.kf_pt[kf] >= 0).sum()) < cfg.min_sim3_matches:
            return False, -1, None
        for cand in candidates:
            if not m.kf_valid[cand]:
                continue
            # match map points by descriptor between the two keyframes
            cand_kp = kf_keypoints(m, cand, self.device)
            cand_kp = cand_kp.replace(valid=self._dev((m.kf_pt[cand] >= 0)
                                                      & m.kf_kp_valid[cand]))
            best_kp, _ = kernels.search_by_descriptor(
                self._desc(m.kf_kp_desc[kf]),
                self._dev((m.kf_pt[kf] >= 0) & m.kf_kp_valid[kf]),
                self._dev(m.kf_kp_angle[kf]), cand_kp, self.cam,
                max_hamming=hamming.TH_LOW, ratio=0.75)
            best_kp = best_kp.cpu().numpy()
            idx1 = np.where(best_kp >= 0)[0]
            if len(idx1) < cfg.min_sim3_matches:
                continue
            idx2 = best_kp[idx1]
            pid1, pid2 = m.kf_pt[kf, idx1], m.kf_pt[cand, idx2]
            keep = (pid1 >= 0) & (pid2 >= 0) & m.pt_valid[np.maximum(pid1, 0)] \
                & m.pt_valid[np.maximum(pid2, 0)]
            idx1, idx2 = idx1[keep], idx2[keep]
            if len(idx1) < cfg.min_sim3_matches:
                continue

            p1c, p2c, valid, s1, s2, n = self._stage_pairs(kf, cand, idx1, idx2)
            sets = horn.draw_sample_sets(valid, RANSAC_ITERS, 3, kf * 131 + cand,
                                         self.device)
            res = horn.sim3_ransac(
                self._dev(p1c), self._dev(p2c), self._dev(valid), self._dev(s1),
                self._dev(s2), self.cam, sets, fix_scale=cfg.fix_scale,
                min_inliers=cfg.min_sim3_matches)
            if not bool(res.success):
                continue
            s12_ransac = res.s12.cpu().numpy()

            # SearchBySim3 expansion: both keyframes' other map points are
            # projected through the RANSAC Sim3 (th=7.5) to add matches
            # before OptimizeSim3, whose >= 20-inlier gate comes after it
            inl_pairs = res.inliers.cpu().numpy()[:n]
            k_idx1, k_idx2 = idx1[:n][inl_pairs], idx2[:n][inl_pairs]
            e_idx1, e_idx2 = self._search_by_sim3(kf, cand, s12_ransac, k_idx1, k_idx2)
            a_idx1 = np.concatenate([k_idx1, e_idx1])
            a_idx2 = np.concatenate([k_idx2, e_idx2])
            p1c, p2c, valid, s1, s2, n2 = self._stage_pairs(kf, cand, a_idx1, a_idx2)
            cap2 = len(valid)
            uv1 = _pad(m.kf_kp_xy[kf, a_idx1[:n2]], cap2)
            uv2 = _pad(m.kf_kp_xy[cand, a_idx2[:n2]], cap2)
            s12, _, n_in = sim3_opt.optimize_sim3(
                self._dev(s12_ransac), self._dev(p1c), self._dev(p2c),
                self._dev(uv1), self._dev(uv2), self._dev(1.0 / s1),
                self._dev(1.0 / s2), self._dev(valid), self.cam,
                fix_scale=cfg.fix_scale)
            if int(n_in) < cfg.min_sim3_inliers:
                continue

            # corrected pose of the current keyframe: S_cw = S_12 T_cand_w
            s_cw = s12.cpu().numpy() @ sim3_np.from_se3(m.kf_pose[cand])
            # verify by projecting the loop neighbourhood
            total = self._count_neighborhood_matches(kf, cand, s_cw, w)
            if total >= cfg.min_total_matches:
                return True, cand, s_cw
        return False, -1, None

    def _search_by_sim3(self, kf: int, cand: int, s12: np.ndarray,
                        matched1: np.ndarray, matched2: np.ndarray):
        """Mutual Sim3-guided projection matching between the current and
        candidate keyframes (ORBmatcher::SearchBySim3, th=7.5): each side's
        unmatched map points are projected into the other's image through
        the Sim3; a pair survives only if both directions agree. `s12` maps
        candidate-camera coords into current-keyframe coords.
        -> (idx1, idx2) arrays of new keypoint-slot pairs."""
        m = self.map

        def one_dir(src, dst, s_dst_src, matched_src):
            pids = m.kf_pt[src]
            safe = np.maximum(pids, 0)
            q_valid = (pids >= 0) & m.kf_kp_valid[src] & m.pt_valid[safe]
            q_valid[matched_src] = False
            best = kernels.search_by_sim3_dir(
                self._dev(s_dst_src, torch.float32),
                self._dev(m.kf_pose[src], torch.float32),
                self._dev(m.pt_pos[safe]), self._desc(m.pt_desc[safe]),
                self._dev(q_valid), self._dev(m.pt_min_dist[safe]),
                self._dev(m.pt_max_dist[safe]), kf_keypoints(m, dst, self.device),
                7.5, self.cam, self.cfg.scale_factor, self.cfg.n_levels)
            return best.cpu().numpy()

        best_a = one_dir(kf, cand, sim3_np.inverse(s12), matched1)  # kf slot -> cand kp
        best_b = one_dir(cand, kf, s12, matched2)                   # cand slot -> kf kp
        i1 = np.where(best_a >= 0)[0]
        s2 = best_a[i1]
        agree = best_b[s2] == i1
        return i1[agree].astype(np.int64), s2[agree].astype(np.int64)

    def _count_neighborhood_matches(self, kf: int, cand: int, s_cw: np.ndarray,
                                    w: np.ndarray) -> int:
        """Project every point of the candidate's covisible neighbourhood
        into the current keyframe under the corrected pose; count matches."""
        m = self.map
        hood = [cand, *map(int, covisibility.covisible_neighbors(w, cand))]
        pts = np.unique(m.kf_pt[np.array(hood)])
        pts = pts[pts >= 0]
        pts = pts[m.pt_valid[pts]]
        if len(pts) == 0:
            return 0
        tcw_corr = sim3_np.to_se3(s_cw.astype(np.float32))
        _, res = kernels.search_local_points(
            self._dev(tcw_corr), self._dev(m.pt_pos[pts]), self._desc(m.pt_desc[pts]),
            torch.ones(len(pts), dtype=torch.bool, device=self.device),
            self._dev(m.pt_normal[pts]), self._dev(m.pt_min_dist[pts]),
            self._dev(m.pt_max_dist[pts]),
            kf_keypoints(m, kf, self.device),
            torch.zeros(m.cap.n_features, dtype=torch.bool, device=self.device),
            2.0, self.cam, self.cfg.scale_factor, self.cfg.n_levels)
        return int((res.assoc >= 0).sum())

    # ------------------------------------------------------------------
    # CorrectLoop
    # ------------------------------------------------------------------
    def _correct_loop(self, kf: int, loop_kf: int, s_cw: np.ndarray, w: np.ndarray):
        """All staging is batched numpy, in float64."""
        m = self.map
        cfg = self.cfg
        window = [kf, *map(int, covisibility.covisible_neighbors(w, kf))]
        win_arr = np.array(window, np.int64)
        kmax = m.cap.max_keyframes

        # pre-correction poses (the reference's NonCorrectedSim3, scale 1)
        pre_pose = m.kf_pose.astype(np.float64)
        # the Sim3 of every window keyframe: S_iw = (T_i T_c^-1) S_cw
        t_ic = pre_pose[win_arr] @ sim3_np.se3_inverse(pre_pose[kf])
        corrected_w = t_ic @ np.asarray(s_cw, np.float64)          # [Kw, 4, 4]

        # remap window points p' = S_corr^-1 (S_old p), each through its
        # first observing window keyframe (the reference's mnCorrectedByKF)
        sub = m.kf_pt[win_arr]
        wi, sl = np.nonzero(sub >= 0)
        pids = sub[wi, sl]
        keep = m.pt_valid[pids]
        wi, pids = wi[keep], pids[keep]
        order = np.lexsort((wi, pids))
        pids_s, wi_s = pids[order], wi[order]
        first = np.ones(len(pids_s), bool)
        first[1:] = pids_s[1:] != pids_s[:-1]
        upids, uwi = pids_s[first], wi_s[first]
        remap = sim3_np.inverse(corrected_w) @ pre_pose[win_arr]
        if len(upids):
            m.pt_pos[upids] = sim3_np.apply(remap[uwi], m.pt_pos[upids])
            m.mark_pts_dirty(upids)
        m.kf_pose[win_arr] = sim3_np.to_se3(corrected_w)

        # fuse the loop neighbourhood's points into the window
        hood = [loop_kf, *map(int, covisibility.covisible_neighbors(w, loop_kf))]
        hood_pts = np.unique(m.kf_pt[np.array(hood)])
        hood_pts = hood_pts[hood_pts >= 0]
        hood_pts = hood_pts[m.pt_valid[hood_pts]]
        fuser = LocalMapper(m, self.cam, LocalMapperConfig(
            scale_factor=cfg.scale_factor, n_levels=cfg.n_levels), self.device)
        # loop correction runs under the caller's map lock; the fuser's own
        # stage locks are re-entrant with it
        fuser.map_lock = self.map_lock
        fuser._fuse_points_into_targets(hood_pts, window)

        # essential graph
        w2 = covisibility.weight_matrix(m)
        edges = covisibility.essential_edges(m, w2)
        edges.append((min(kf, loop_kf), max(kf, loop_kf)))
        edges = sorted(set(edges))
        old_loop_pairs = {(min(a, b), max(a, b))
                          for a in range(kmax) for b in m.kf_loop_edges[a]}
        m.kf_loop_edges[kf].add(loop_kf)
        m.kf_loop_edges[loop_kf].add(kf)

        # the current Sim3 of every keyframe: corrected with scale in the
        # window, the unchanged pose elsewhere
        cur_sim3 = pre_pose.copy()
        cur_sim3[win_arr] = corrected_w
        e_i = np.array([e[0] for e in edges], np.int64)
        e_j = np.array([e[1] for e in edges], np.int64)
        # edges that existed before the loop (spanning tree, earlier
        # covisibility, earlier loop edges) measure the pre-correction
        # relative pose; the connections the loop fusion created and the
        # loop edge itself measure the corrected one
        parent_pair = (m.kf_parent[e_i] == e_j) | (m.kf_parent[e_j] == e_i)
        pre_covis = w[e_i, e_j] >= covisibility.COVIS_THRESHOLD
        prev_loop = np.array([(int(a), int(b)) in old_loop_pairs
                              for a, b in zip(e_i, e_j)], bool)
        is_new = ~(parent_pair | pre_covis | prev_loop)
        is_new[(e_i == min(kf, loop_kf)) & (e_j == max(kf, loop_kf))] = True
        s_a = np.where(is_new[:, None, None], cur_sim3[e_i], pre_pose[e_i])
        s_b = np.where(is_new[:, None, None], cur_sim3[e_j], pre_pose[e_j])
        meas = s_b @ sim3_np.inverse(s_a)

        kf_fixed = np.zeros(kmax, bool)
        kf_fixed[loop_kf] = True
        # padded edges join the loop keyframe to itself and add exact zeros
        n_edges = len(e_i)
        e_i, e_j, meas, e_valid = pose_graph.pad_edges(
            e_i, e_j, meas, loop_kf, size_bucket(n_edges, EG_EDGE_FLOOR, EG_EDGE_GROWTH))
        self.solve_sizes["essential_graph"].append((n_edges, len(e_i)))
        with self.stats.stage("essential_graph"):
            new_sim3, _ = self.eg_program(
                self._dev(cur_sim3), self._dev(m.kf_valid), self._dev(kf_fixed),
                self._dev(e_i), self._dev(e_j), self._dev(meas), self._dev(e_valid),
                fix_scale=cfg.fix_scale)
            new_sim3 = new_sim3.cpu().numpy()

        # remap every point through its reference keyframe's correction,
        # then the poses
        remap_k = sim3_np.inverse(new_sim3) @ cur_sim3
        pids = np.where(m.pt_valid)[0]
        refs = m.pt_ref_kf[pids]
        good = (refs >= 0) & m.kf_valid[np.maximum(refs, 0)]
        pids, refs = pids[good], refs[good]
        m.pt_pos[pids] = sim3_np.apply(remap_k[refs], m.pt_pos[pids])
        m.mark_all_pts_dirty()
        valid = m.kf_valid
        m.kf_pose[valid] = sim3_np.to_se3(new_sim3[valid])
        m.correction_gen += 1  # voids unlocked solves in flight
        m.change_index += 1

        if cfg.run_global_ba:
            self.request_global_ba(fixed_kf=loop_kf)

    # ------------------------------------------------------------------
    # Global BA with supersession (RunGlobalBundleAdjustment). The BA runs
    # on a snapshot of the map; a loop closed while it runs bumps
    # full_ba_idx and its result is discarded at apply time. An up-to-date
    # result propagates through the spanning tree to keyframes and points
    # created during the run.
    # ------------------------------------------------------------------
    def request_global_ba(self, fixed_kf: int) -> None:
        """The caller holds the map lock. An asynchronous run is started
        without joining the one in flight: that run may be waiting for this
        very lock to apply, and the bumped `full_ba_idx` already makes it
        discard its result."""
        self.full_ba_idx += 1  # supersedes any GBA in flight
        snap = self._snapshot_gba(fixed_kf, self.full_ba_idx)
        if snap is None:
            return
        if self.cfg.async_gba:
            t = threading.Thread(target=self._run_gba_thread, args=(snap,),
                                 daemon=True, name="gba-worker")
            self._gba_threads = [u for u in self._gba_threads if u.is_alive()] + [t]
            t.start()
        else:
            self._run_gba(snap)

    @graph_capture.entry()
    def wait_gba(self, timeout: float = 300.0) -> bool:
        """Join every GBA in flight; the caller must not hold the map lock.
        -> False on timeout; raises the exception of a GBA that failed on
        its thread."""
        self._join_gba(timeout)
        self._raise_if_failed()
        return not any(t.is_alive() for t in self._gba_threads)

    def _raise_if_failed(self) -> None:
        if self.error is not None:
            raise RuntimeError("the global BA thread failed") from self.error

    @graph_capture.entry()    # a GBA thread captures meanwhile
    def _join_gba(self, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        for t in list(self._gba_threads):
            t.join(max(0.0, deadline - time.monotonic()))

    def _snapshot_gba(self, fixed_kf: int, idx: int):
        """The global BA problem of the current map, in float64 on the
        device, its observations padded to a size bucket with rows of
        camera 0 and point 0, invalid, as the JAX package pads them (its
        buckets grow by 4, these by 2). The caller holds the map lock."""
        m = self.map
        cfg = self.cfg
        ks, slots = np.where(m.kf_pt >= 0)
        pids = m.kf_pt[ks, slots]
        keep = m.kf_valid[ks] & m.pt_valid[pids]
        ks, slots, pids = ks[keep], slots[keep], pids[keep]
        n_obs = len(ks)
        if n_obs < 100:
            return None
        obs_cap = size_bucket(n_obs, GBA_OBS_FLOOR, GBA_OBS_GROWTH)
        self.solve_sizes["gba"].append((n_obs, obs_cap))
        o_cam = np.zeros(obs_cap, np.int64)
        o_pt = np.zeros(obs_cap, np.int64)
        o_uv = np.zeros((obs_cap, 3))
        o_sig = np.ones(obs_cap)
        o_st = np.zeros(obs_cap, bool)
        o_val = np.zeros(obs_cap, bool)
        ur = m.kf_kp_ur[ks, slots]
        o_cam[:n_obs], o_pt[:n_obs] = ks, pids
        o_uv[:n_obs, :2] = m.kf_kp_xy[ks, slots]
        o_uv[:n_obs, 2] = np.maximum(ur, -1.0)
        o_sig[:n_obs] = (1.0 / cfg.scale_factor ** 2) ** m.kf_kp_octave[ks, slots].astype(
            np.float64)
        o_st[:n_obs] = ur >= 0
        o_val[:n_obs] = True
        cam_fixed = ~m.kf_valid
        cam_fixed[fixed_kf] = True
        problem = ba.BAProblem(*(self._dev(x) for x in (
            m.kf_pose.astype(np.float64), m.pt_pos.astype(np.float64), cam_fixed,
            o_cam, o_pt, o_uv, o_sig, o_st, o_val)))
        return {
            "idx": idx,
            "fixed_kf": fixed_kf,
            "problem": problem,
            "pt_fixed": self._dev(~m.pt_valid),
            "kf_in": m.kf_valid.copy(),
            "kf_order": m.kf_order.copy(),
            "pt_in": m.pt_valid.copy(),
            "pt_stamp": m.pt_stamp.copy(),
        }

    def _run_gba_thread(self, snap) -> None:
        graph_capture.background()
        try:
            self._run_gba(snap)
        except Exception as e:  # kept; raised on the caller's thread
            self.error = e

    def _run_gba(self, snap) -> None:
        with self.stats.stage("gba_solve"):
            res = self.gba_program(snap["problem"], self.cam, phase_iters=(5, 5),
                                   point_fixed=snap["pt_fixed"])
            new_poses = res.poses.cpu().numpy()
            new_points = res.points.cpu().numpy()
        with self.map_lock:
            if snap["idx"] != self.full_ba_idx:
                self.n_gba_superseded += 1  # a newer loop landed: discard
                return
            with self.stats.stage("gba_apply"):
                self._apply_gba(snap, new_poses, new_points)
            self.n_gba_applied += 1
            self.map.change_index += 1

    def _apply_gba(self, snap, new_poses: np.ndarray, new_points: np.ndarray) -> None:
        """Write the GBA result into the (possibly grown) map. Keyframes and
        points the snapshot covered take their optimized values; those
        created during the run are corrected through the spanning tree and
        their reference keyframe."""
        m = self.map
        # keyframes the snapshot covered, still alive in the same slot
        covered = snap["kf_in"] & m.kf_valid & (m.kf_order == snap["kf_order"])
        old_pose = m.kf_pose.astype(np.float64)   # poses at apply time
        corrected = {int(k): new_poses[k] for k in np.where(covered)[0]}
        # new keyframes in insertion order: T_new = (T_old T_parent_old^-1) T_parent_new
        fresh = m.kf_valid & ~covered
        for k in np.argsort(m.kf_order):
            if not fresh[k]:
                continue
            par = int(m.kf_parent[k])
            if par < 0 or par not in corrected:
                continue  # rootless: left untouched
            t_rel = old_pose[k] @ sim3_np.se3_inverse(old_pose[par])
            corrected[int(k)] = t_rel @ corrected[par]
        # points the snapshot covered take the optimized positions
        pt_cov = snap["pt_in"] & m.pt_valid & (m.pt_stamp == snap["pt_stamp"])
        m.pt_pos[pt_cov] = new_points[pt_cov]
        # points created during the run: p' = T_new^-1 (T_old p) through
        # their reference keyframe
        corr_mask = np.zeros(m.cap.max_keyframes, bool)
        corr_pose = np.zeros((m.cap.max_keyframes, 4, 4))
        for k, pose in corrected.items():
            corr_mask[k] = True
            corr_pose[k] = pose
        pt_fresh = np.where(m.pt_valid & ~pt_cov)[0]
        refs = m.pt_ref_kf[pt_fresh]
        good = (refs >= 0) & corr_mask[np.maximum(refs, 0)]
        pt_fresh, refs = pt_fresh[good], refs[good]
        if len(pt_fresh):
            remap = sim3_np.se3_inverse(corr_pose[refs]) @ old_pose[refs]
            m.pt_pos[pt_fresh] = sim3_np.apply(remap, m.pt_pos[pt_fresh])
        m.mark_all_pts_dirty()
        for k, pose in corrected.items():
            m.kf_pose[k] = pose
        m.correction_gen += 1  # voids unlocked solves in flight
