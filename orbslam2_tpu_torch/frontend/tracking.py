"""Tracking front-end: per-frame pose estimation state machine (RGB-D, stereo,
monocular).

Counterpart of ``orbslam2_tpu/frontend/tracking.py``. The structure mirrors
the reference's Tracking::Track: initialization -> motion-model /
reference-keyframe tracking -> local-map tracking -> keyframe decision; every
per-point loop is a batched device step (frontend/kernels.py) and the map is
a flat array store (slammap/mapstate.py).

What this port covers: RGB-D, stereo and monocular frames (depth from the
depth image, from left-right matching, or none), initialization from depth
or, for a monocular camera, from two views (``solvers/initializer.py``), the
classic two-step path, the fused whole-frame path, synchronous or pipelined
(a frame's results are fetched and applied while the next frame runs, in
batches of ``fetch_batch`` frames), keyframe insertion with close points
spawned from depth, local mapping and (with a vocabulary) loop closing of
every keyframe, inline or on the mapping worker's thread (a monocular
keyframe is mapped inline at insertion unless ``mono_async_mapping``),
relocalization through the keyframe database (KFDB candidates, EPnP RANSAC
and the reference's escalation) or, without a vocabulary, through the
reference keyframe, localization mode with temporal visual-odometry points,
the device-resident or host-staged local map, reset and trajectory
bookkeeping. Every ``SLAMConfig`` field is implemented.

The tracker owns the map lock (a re-entrant lock shared with the local
mapper). A classic-path frame holds it throughout; a fused frame holds it
while it stages its inputs and while it applies its results, and runs its
device step unlocked, so that mapping stages interleave. Associations staged
before a mid-flight map change are validated on apply: erased or re-used
point slots are dropped, and a frame staged before a pose correction is
dispatched again.

Three deliberate divergences from the JAX package's pipelined fetch (each
has its test in tests/test_torch_pipeline_chain.py): a batch whose apply
broke the chain makes the batch chained off it track again, even when a
frame tracked again in between cleared the stale-carry flag; the pose
returned for a frame in flight composes the velocity once for every frame
between the last applied frame and this one, not once; and a frame that
fails after chaining across a keyframe it did not see is dispatched again
(`_apply_one`).

Two more divergences repair faults of the JAX package, toward ORB-SLAM2's
behaviour (tests/test_torch_map_repairs.py, tests/test_torch_mono.py and
tests/test_torch_localization.py): the last frame's ids and the local
selection are brought up to date with the map's merged points before each
frame (`_check_replaced`, Tracking::CheckReplacedInLastFrame), and a fused
frame's on apply, where the JAX package drops them; and no temporal point
reaches the local-map stage of a frame whose associations a relocalization
supplied.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from orbslam2_tpu_torch import resolve_device
from orbslam2_tpu_torch.backend import pose_opt
from orbslam2_tpu_torch.frontend import frame as frame_mod
from orbslam2_tpu_torch.frontend import kernels
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig, ORBExtractor
from orbslam2_tpu_torch.slammap import covisibility
from orbslam2_tpu_torch.slammap.mapstate import MapCapacity, MapState
from orbslam2_tpu_torch.ops import match as match_ops
from orbslam2_tpu_torch.solvers import epnp, horn, initializer
from orbslam2_tpu_torch.utils import graph_capture
from orbslam2_tpu_torch.utils.profiling import StageTimer


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


# what Tracker._fused_apply returns for a frame to be dispatched again
_MISSED_KEYFRAME = object()


@dataclasses.dataclass
class SLAMConfig:
    """Same fields and defaults as the JAX package's SLAMConfig."""
    cam: PinholeCamera
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    th_depth: float = 3.0           # meters; reference mThDepth = baseline*ThDepth
    max_keyframes: int = 256
    max_points: int = 16384
    local_point_cap: int = 4096
    min_frames_between_kf: int = 0  # mMinFrames
    max_frames_between_kf: int = 30  # mMaxFrames = fps
    min_init_features: int = 500    # stereo/RGBD init gate
    max_new_points_per_kf: int = 100  # far-point budget per keyframe
    localization_only: bool = False
    # run local mapping + loop closing on a background worker thread;
    # False runs mapping inline per keyframe
    async_mapping: bool = True
    # testing/benchmark hook: unconditionally insert a keyframe every N
    # frames (None = reference keyframe-decision logic only)
    force_kf_every: Optional[int] = None
    # collect per-stage wall-clock stats in tracker.stats (utils/profiling)
    profile_stages: bool = False
    # keep the point arrays device-resident (slammap/device_map) and gather
    # local-map rows on device; False = re-stage gathered rows per frame
    device_local_map: bool = True
    # steady-state frames run ONE fused step (build + motion-model +
    # local-map + both pose optimizations) with ONE fetch
    # (kernels.fused_frame_step); False = two-step path per frame
    fused_frame: bool = True
    # monocular mapping placement: False maps each keyframe inline at its
    # insertion (triangulation is mono's only source of points, and a feed
    # faster than the worker would starve the map); True queues it to the
    # mapping worker like the other sensors
    mono_async_mapping: bool = False
    # overlap the frame's result fetch with the NEXT frame's dispatch
    pipelined_fetch: bool = True
    # frames per fetch round trip in pipelined mode
    fetch_batch: int = 1


@dataclasses.dataclass
class FrameTrajectoryEntry:
    """Relative-pose bookkeeping for trajectory export, mirroring the
    reference's mlRelativeFramePoses / mlpReferences."""
    tcr: np.ndarray       # frame pose relative to its reference keyframe
    ref_kf: int
    ref_order: int        # insertion order of the ref KF (survives slot reuse)
    timestamp: float
    lost: bool


def _host_step(step: kernels.TrackStepResult) -> SimpleNamespace:
    """Fetch a TrackStepResult: the small integer outputs as one tensor, the
    pose as another."""
    n = step.inlier.shape[0]
    ints = torch.cat([
        step.assoc.to(torch.int32), step.inlier.to(torch.int32),
        step.visible.to(torch.int32),
        torch.stack([step.n_inliers, step.n_matches]).to(torch.int32),
    ]).cpu().numpy()
    c = step.visible.shape[0]
    return SimpleNamespace(
        tcw=step.tcw.cpu().numpy(), assoc=ints[:n],
        inlier=ints[n:2 * n].astype(bool),
        visible=ints[2 * n:2 * n + c].astype(bool),
        n_inliers=int(ints[-2]), n_matches=int(ints[-1]))


class Tracker:
    def __init__(self, config: SLAMConfig, map_state: Optional[MapState] = None,
                 local_mapper=None, device="cuda"):
        self.cfg = config
        self.cam = config.cam
        self.device = resolve_device(device)
        self.extractor = ORBExtractor(
            config.orb, (config.cam.height, config.cam.width), self.device)
        self.map = map_state or MapState(MapCapacity(
            config.max_keyframes, config.max_points, self.extractor.n_total))
        self.local_mapper = local_mapper  # set by SLAMSystem; maps each new KF
        # place-recognition hooks (set by SLAMSystem when a vocabulary exists)
        self.vocabulary = None
        self.kfdb = None
        self.loop_closer = None
        self.state = TrackingState.NO_IMAGES_YET
        self.last_frame: Optional[frame_mod.Frame] = None
        self.velocity: Optional[np.ndarray] = None   # Tcl: last->current
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.frame_counter = 0
        self.trajectory: list[FrameTrajectoryEntry] = []
        self.matches_inliers = 0
        self._map_inliers = 0
        self._covis_w: Optional[np.ndarray] = None
        self.last_reloc_frame_id: int = -1000000
        # optional hook: called as (timestamp, tcw or None) once per applied
        # frame, in order (see _record_trajectory): the solved-pose stream of
        # the ROS pose topic
        self.applied_pose_cb = None
        # monocular: set by track_mono; the first frame of a two-view
        # initialization waits in _init_ref for its partner
        self.is_mono = False
        self._init_ref: Optional[frame_mod.Frame] = None
        # fused-frame state: local candidate selection computed from the
        # PREVIOUS frame (one-frame lag removes the mid-frame host round
        # trip) and the device-resident carry of last frame's associations
        self._local_ids: Optional[np.ndarray] = None   # [cap] int32 padded
        self._local_sel: Optional[np.ndarray] = None   # [cap] bool
        self._local_pts: Optional[np.ndarray] = None   # [n_local] int64
        self._local_stamp = 0  # the map's point counter at the selection
        self._selection_fresh = False  # set when a classic-path frame just
        # computed the selection (skip the end-of-frame recompute)
        self._last_pid_dev: Optional[torch.Tensor] = None  # device [N]
        # the fused frame programs (kernels.FrameProgram) of this tracker, by
        # sensor: on a card each holds its CUDA graphs
        self.frame_programs: dict = {}
        # the classic path's programs: the frame build by sensor
        # (frame.BuildProgram) and the motion-model and local-map steps
        # (kernels.MotionModelProgram, kernels.LocalMapProgram, under their
        # step's name), each made for the tracker's extractor, camera and ORB
        # settings (kernels.program_for)
        self.classic_programs: dict = {}
        # localization-mode VO state (the reference's mbVO): True while the
        # frame tracks under 10 map points and survives on temporal points
        self.mb_vo = False
        self._vo_mask = self._vo_pos = None   # last frame's temporal points
        self._aux_mask = self._aux_pos = None  # this frame's matches to them
        # pipelined-fetch state: `_pending` holds dispatched frames whose
        # batch fetch is not submitted yet (at most fetch_batch - 1);
        # `_inflight` is the one submitted batch (records, fetch) whose
        # results are applied with the next batch
        self._pending: list = []
        self._inflight: Optional[tuple] = None
        self._carry_wrong = False  # an apply found stale ids / fell back
        # the map lock (shared with the local mapper) and the mapping worker
        # (set by SLAMSystem when async_mapping is on)
        self.map_lock = threading.RLock()
        self.mapping_worker = None
        self.stats = StageTimer(enabled=config.profile_stages)
        # fused frames whose associations the mapper changed while the
        # frame's device step ran: merged points remapped, erased or
        # re-allocated ones dropped (read by drives)
        self.revalidated_frames = 0
        # associations remapped to the point they were merged into, in the
        # last frame before a frame and in a fused frame on apply
        self.remapped_ids = 0
        # of those ids and the local selection's, the ones whose slot was
        # handed out again before the lookup (resolved through the slot's
        # previous life), and the ones lost because their slot was handed
        # out more than once (an upper bound: the life may have been erased)
        self.reused_slot_ids = 0
        self.replacements_lost = 0
        # frames built again because a pose correction (loop closure, global
        # BA) rebased the map, or a local BA moved their reference keyframe,
        # while their fused step was in flight: each is one more extraction
        # (read by drives)
        self.rebuilt_frames = 0
        # pipelined frames tracked again because the frame or batch they
        # were chained off was discarded: each is one more extraction
        self.retracked_frames = 0

    def _dev(self, a, dtype=None) -> torch.Tensor:
        """Host array -> tensor on the tracker's device."""
        t = torch.as_tensor(a, dtype=dtype)
        return t.to(self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    # each a caller's call: captures on the mapping worker's threads may run
    # meanwhile (utils/graph_capture.py)
    @graph_capture.entry()
    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float) -> Optional[np.ndarray]:
        return self._track_images("rgbd", (gray, depth), timestamp)

    @graph_capture.entry()
    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float) -> Optional[np.ndarray]:
        return self._track_images("stereo", (left, right), timestamp)

    @graph_capture.entry()
    def track_mono(self, gray: np.ndarray, timestamp: float) -> Optional[np.ndarray]:
        self.is_mono = True
        return self._track_images("mono", (gray,), timestamp)

    # ------------------------------------------------------------------
    def _build_frame(self, kind: str, imgs, timestamp: float) -> frame_mod.Frame:
        """A classic-path frame, built through the sensor's build program."""
        with self.stats.stage("frame_build"):
            prog = kernels.program_for(self.classic_programs, kind, frame_mod.BuildProgram,
                                       kind, self.extractor, self.cam)
            fr = frame_mod.build_frame(kind, self.frame_counter, timestamp, imgs,
                                        self.extractor, self.cam, prog)
        self.frame_counter += 1
        return fr

    def _step_program(self, make):
        """The tracker's program of a classic-path step
        (kernels.MotionModelProgram or kernels.LocalMapProgram)."""
        return kernels.program_for(self.classic_programs, make.step_name, make, self.cam,
                                   self.cfg.orb.scale_factor, self.cfg.orb.n_levels)

    # ------------------------------------------------------------------
    # main state machine (Tracking::Track)
    # ------------------------------------------------------------------
    def _track_images(self, kind: str, imgs, timestamp: float
                      ) -> Optional[np.ndarray]:
        # The fused steady-state path manages its own lock scope: staging
        # and applying run under the map lock, the device step runs unlocked
        # so that mapping stages interleave with it. The classic path (init,
        # reloc, motion-model fallback) holds the lock for the whole frame,
        # like the reference's Track().
        with self.map_lock:
            fused = (self.cfg.fused_frame and self.state == TrackingState.OK
                     and self.velocity is not None
                     and not self.cfg.localization_only
                     and self._local_ids is not None)
        if fused:
            return self._track_fused(kind, imgs, timestamp)
        # classic path (init, reloc, localization mode, motion-model
        # fallback): apply the frames in flight first, in order
        self.flush_frames()
        with self.map_lock:
            fr = self._build_frame(kind, imgs, timestamp)
            return self._track_locked(fr)

    def _track_locked(self, fr: frame_mod.Frame) -> Optional[np.ndarray]:
        # any classic-path frame invalidates the fused device carry (its
        # associations live in fr.pt_ids on the host)
        self._last_pid_dev = None
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            self.state = TrackingState.NOT_INITIALIZED
            if self.is_mono:
                ok = self._monocular_initialization(fr)
            else:
                ok = self._stereo_initialization(fr)
            if ok:
                self.state = TrackingState.OK
            self._record_trajectory(fr, lost=not ok)
            fr.pt_stamp = self.map._pt_counter
            self.last_frame = fr
            return fr.tcw.copy() if ok else None

        ok = False
        if self.state == TrackingState.OK:
            self._update_last_frame()
            with self.stats.stage("initial_track"):
                if self.cfg.localization_only:
                    ok = self._track_localization_mode(fr)
                else:
                    if self.velocity is not None:
                        ok = self._track_with_motion_model(fr)
                    if not ok:
                        ok = self._track_reference_keyframe(fr)
        else:
            # the relocalization supplies this frame's associations: no
            # temporal point of the last tracked frame may reach them
            self._vo_mask = self._vo_pos = None
            self._aux_mask = self._aux_pos = None
            with self.stats.stage("relocalize"):
                ok = self._relocalize(fr)

        # in localization mode on temporal points only (mb_vo) the local map
        # is skipped
        if ok and not (self.cfg.localization_only and self.mb_vo):
            with self.stats.stage("local_map"):
                ok = self._track_local_map(fr)

        return self._finish_frame(fr, ok)

    # ------------------------------------------------------------------
    def _finish_frame(self, fr: frame_mod.Frame, ok: bool
                      ) -> Optional[np.ndarray]:
        """Shared frame epilogue: state/velocity update, keyframe decision,
        loss handling, trajectory bookkeeping."""
        fr.pt_stamp = self.map._pt_counter
        mapping = not self.cfg.localization_only
        if ok:
            self.state = TrackingState.OK
            if self.last_frame is not None:
                self.velocity = fr.tcw @ np.linalg.inv(self.last_frame.tcw)
            if mapping and self._need_new_keyframe(fr):
                with self.stats.stage("new_keyframe"):
                    self._create_new_keyframe(fr)
            if self.cfg.fused_frame and mapping:
                if self._selection_fresh:
                    self._selection_fresh = False
                else:
                    with self.stats.stage("local_select"):
                        self._refresh_local_selection(fr)
        else:
            self.state = TrackingState.LOST
            self.velocity = None
            self._last_pid_dev = None
            # auto-reset when lost right after initialization
            # (<= 5 keyframes in the map); a frozen map is kept
            if self.map.n_keyframes() <= 5 and mapping:
                self._record_trajectory(fr, lost=True)
                self.last_frame = fr
                self.reset()
                return None

        self._record_trajectory(fr, lost=not ok)
        self.last_frame = fr
        return fr.tcw.copy() if ok else None

    # ------------------------------------------------------------------
    # fused whole-frame path: ONE fused step + ONE fetch per frame
    # ------------------------------------------------------------------
    def _select_local(self, fr: frame_mod.Frame):
        """UpdateLocalKeyFrames/UpdateLocalPoints: -> (padded ids [cap],
        mask [cap], point ids [n_local])."""
        w = self._covis_w if self._covis_w is not None \
            else covisibility.weight_matrix(self.map)
        local_kfs, ref_kf = covisibility.local_keyframes(self.map, fr.pt_ids, w)
        if ref_kf >= 0:
            self.ref_kf = ref_kf
        cap = self.cfg.local_point_cap
        pt_ids = covisibility.local_points(self.map, local_kfs)[:cap]
        n = len(pt_ids)
        ids = np.zeros(cap, np.int32)
        ids[:n] = pt_ids
        sel = np.zeros(cap, bool)
        sel[:n] = True
        return ids, sel, pt_ids

    def _refresh_local_selection(self, fr: frame_mod.Frame) -> None:
        """Select the local-map candidates for the NEXT frame from this
        frame's associations (evaluated one frame early — covisibility
        changes per keyframe event, not per frame)."""
        self._local_ids, self._local_sel, self._local_pts = self._select_local(fr)
        self._local_stamp = self.map._pt_counter

    def _track_fused(self, kind: str, imgs, timestamp: float
                     ) -> Optional[np.ndarray]:
        """Fused steady-state frame. Synchronous (``pipelined_fetch=False``):
        dispatch, fetch, apply, and the solved pose is returned. Pipelined:
        the frame is dispatched chained off the newest frame in flight (its
        pose, keypoints and associations still on the device), its small
        outputs are copied to pinned host memory behind it, and the batch
        before it is applied now; the pose returned is the motion-model
        prediction, and the solved pose reaches the trajectory one batch
        later. A batch whose premises the applied batch broke (loss, a
        fallback, stale ids, a new keyframe with fetch_batch > 1) is tracked
        again, frame by frame."""
        with self.stats.stage("fused_step"):
            imgs_d = tuple(self._dev(im, torch.float32) for im in imgs)
            # backpressure: while the mapping worker's queue is full (the
            # limit that blocks keyframe insertion) frames go synchronous, so
            # that the fetch throttles an unpaced feed instead of starving
            # keyframe insertion
            pipelined = self.cfg.pipelined_fetch and (
                self.mapping_worker is None or self.mapping_worker.accept_keyframes())
            rec = self._fused_dispatch(kind, imgs_d, timestamp)
            self._pending.append(rec)
            k = max(1, self.cfg.fetch_batch) if pipelined else 1
            if len(self._pending) >= k:
                # the new batch stays detached from `_inflight` until the
                # previous batch is applied: a reset fired by that apply
                # must not discard frames this call still owns
                batch, self._pending = self._pending, []
                entry = self._submit_batch_fetch(batch)
                prev, self._inflight = self._inflight, None
                if prev is not None:
                    kf0 = self.last_kf_frame_id
                    _, broke = self._finish_batch(prev)
                    if not self._chain_ok(broke, kf0):
                        ret = None
                        for r in batch:
                            ret = self._retrack_sync(r)
                        return ret
                if not pipelined:
                    return self._finish_batch(entry)[0]
                self._inflight = entry
            return self._predicted_pose(rec["frame_id"])

    def _chain_ok(self, broke: bool, kf0: int) -> bool:
        """A batch chained off the batch just applied stands: tracking is
        healthy, no apply broke the chain, and (with fetch_batch > 1) no
        keyframe was created since ``kf0``."""
        with self.map_lock:
            return (self.state == TrackingState.OK and self.velocity is not None
                    and not broke and not self.cfg.localization_only
                    and not (self.cfg.fetch_batch > 1 and self.last_kf_frame_id != kf0))

    def _predicted_pose(self, frame_id: int) -> np.ndarray:
        """The pose of a frame in flight: the velocity composed once for each
        frame between the last applied frame and this one."""
        with self.map_lock:
            steps = max(1, frame_id - self.last_frame.frame_id)
            vel = np.linalg.matrix_power(np.asarray(self.velocity, np.float64), steps)
            return (vel @ self.last_frame.tcw).astype(np.float32)

    def _fused_dispatch(self, kind: str, imgs_d, timestamp: float,
                        frame_id: Optional[int] = None,
                        chain_off_pipe: bool = True) -> dict:
        """Stage a consistent snapshot under the map lock, then run the fused
        step unlocked. Returns the record consumed by _submit_batch_fetch and
        _apply_one. `frame_id` is given when a frame is dispatched again.
        With `chain_off_pipe` the frame chains off the newest pending or
        in-flight frame's device outputs (its pose, keypoints and
        associations); otherwise, and when nothing is in flight, off the
        applied host state."""
        with self.map_lock:
            chain = None
            if chain_off_pipe:
                chain = (self._pending[-1] if self._pending
                         else self._inflight[0][-1] if self._inflight else None)
            vel = self._dev(np.asarray(self.velocity, np.float32))
            if chain is None:
                self._update_last_frame()
                last = self.last_frame
                tcw_prev = self._dev(np.asarray(last.tcw, np.float32))
                last_kp = last.kp
                last_pid = self._last_pid_dev
                if last_pid is None:
                    last_pid = self._dev(last.pt_ids)
            else:
                # the velocity is one frame older than the chain parent's:
                # constant velocity over two frames, which the search's
                # widening absorbs
                tcw_prev = chain["out"].tcw
                last_kp = chain["out"].kp
                last_pid = chain["out"].pt_ids
            # the mirror's tensors are a snapshot: a sync replaces them
            mir = self.map.device_mirror(self.device)
            corr_gen = self.map.correction_gen
            stamp_snap = self.map._pt_counter
            kf_snap = self.last_kf_frame_id
            if frame_id is None:
                frame_id = self.frame_counter
                self.frame_counter += 1
            radius_mult = 3.0 \
                if frame_id - self.last_reloc_frame_id < 2 else 1.0
            local_ids = self._dev(self._local_ids)
            local_sel = self._dev(self._local_sel)
            local_pts = self._local_pts
            ref = self._ref_snapshot()
        out = kernels.fused_frame_step(
            (kind, imgs_d), self.extractor, self.cam,
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels,
            (vel, tcw_prev), last_kp, last_pid, local_ids, local_sel,
            radius_mult,
            mir.pt_pos, mir.pt_desc, mir.pt_valid, mir.pt_normal,
            mir.pt_min_dist, mir.pt_max_dist, programs=self.frame_programs)
        return dict(out=out, kind=kind, imgs_d=imgs_d, timestamp=timestamp,
                    frame_id=frame_id, corr_gen=corr_gen, stamp_snap=stamp_snap,
                    kf_snap=kf_snap, local_pts=local_pts, ref=ref)

    def _ref_snapshot(self):
        """The reference keyframe as a frame is dispatched against the map:
        (slot, order, pose), or None without a live one."""
        ref = self.ref_kf
        if ref < 0 or not self.map.kf_valid[ref]:
            return None
        return ref, int(self.map.kf_order[ref]), self.map.kf_pose[ref].copy()

    def _ref_moved(self, rec: dict) -> bool:
        """The map moved a dispatched frame's reference keyframe since the
        dispatch (a local BA written back while the step ran, or the
        keyframe culled): the frame was solved against points that have
        moved since."""
        snap = rec.get("ref")
        if snap is None:
            return False
        kf, order, then = snap
        now = self.map.resolve_kf_pose(kf, order)
        return now is None or not np.array_equal(now, then)

    @staticmethod
    def _fetch_parts(out: kernels.FusedFrameOut):
        """A frame's small outputs as two device tensors: integers (pt_ids,
        is_outlier, visible, the three counts) and floats (tcw, depth, ur)."""
        ints = torch.cat([
            out.pt_ids.to(torch.int32), out.is_outlier.to(torch.int32),
            out.visible.to(torch.int32),
            torch.stack([out.mm_matches, out.mm_inliers, out.n_inliers]
                        ).to(torch.int32)])
        floats = torch.cat([out.tcw.reshape(-1), out.depth, out.ur])
        return ints, floats

    @staticmethod
    def _unpack(out: kernels.FusedFrameOut, ints: np.ndarray, floats: np.ndarray):
        """One frame's fetched integers and floats -> the tuple _fused_apply
        takes."""
        n = out.pt_ids.shape[0]
        c = out.visible.shape[0]
        return (floats[:16].reshape(4, 4), ints[:n],
                ints[n:2 * n].astype(bool), ints[2 * n:2 * n + c].astype(bool),
                int(ints[-3]), int(ints[-2]), int(ints[-1]),
                floats[16:16 + n], floats[16 + n:])

    def _fetch_now(self, out: kernels.FusedFrameOut):
        """Fetch one frame's outputs, blocking."""
        ints, floats = self._fetch_parts(out)
        return self._unpack(out, ints.cpu().numpy(), floats.cpu().numpy())

    def _submit_batch_fetch(self, batch: list) -> tuple:
        """One transfer for the whole batch: the frames' small outputs are
        concatenated on the device and copied into pinned host memory without
        blocking the host, and an event marks the end of the copy. On the
        CPU the outputs are host memory already. -> (batch, fetch)."""
        parts = [self._fetch_parts(r["out"]) for r in batch]
        ints = torch.cat([p[0] for p in parts])
        floats = torch.cat([p[1] for p in parts])
        event = None
        if ints.is_cuda:
            ints_h = torch.empty(ints.shape, dtype=ints.dtype, pin_memory=True)
            floats_h = torch.empty(floats.shape, dtype=floats.dtype, pin_memory=True)
            ints_h.copy_(ints, non_blocking=True)
            floats_h.copy_(floats, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            ints, floats = ints_h, floats_h
        sizes = [(p[0].shape[0], p[1].shape[0]) for p in parts]
        return batch, (ints, floats, event, sizes)

    def _finish_batch(self, entry: tuple):
        """Wait for a batch's fetch and apply its frames in order. Once an
        apply breaks the chain (loss, the fallback path, stale ids, a mode
        switch, a new keyframe with fetch_batch > 1), the remaining frames'
        results rest on discarded state: each is tracked again.
        -> (the last frame's return value, whether the chain broke)."""
        batch, (ints, floats, event, sizes) = entry
        with self.stats.stage("fused_dev"):
            if event is not None:
                event.synchronize()
            ints, floats = ints.numpy(), floats.numpy()
        self._carry_wrong = False
        ret = None
        broken = False
        kf0 = self.last_kf_frame_id
        i0 = f0 = 0
        for rec, (ni, nf) in zip(batch, sizes):
            fetched = self._unpack(rec["out"], ints[i0:i0 + ni], floats[f0:f0 + nf])
            i0, f0 = i0 + ni, f0 + nf
            if broken:
                ret = self._retrack_sync(rec)
                continue
            ret = self._apply_one(rec, fetched)
            with self.map_lock:
                # a keyframe created mid-batch adds points the rest of a
                # multi-frame batch never saw: track the rest again
                broken = (self.state != TrackingState.OK or self.velocity is None
                          or self._carry_wrong or self.cfg.localization_only
                          or (self.cfg.fetch_batch > 1
                              and self.last_kf_frame_id != kf0))
        return ret, broken

    def _apply_one(self, rec: dict, fetched) -> Optional[np.ndarray]:
        """Apply one fetched frame. A pose correction that rebased the map
        while the step was in flight (map.correction_gen moved), or a local
        BA written back meanwhile that moved the frame's reference keyframe,
        voids the solved pose: the frame is dispatched again against the
        moved map, chained off the applied state, and the frames chained off
        it are tracked again (``_carry_wrong``); after two in a row it takes
        the classic path. The reference tracker holds the map for the whole
        of a frame (Tracking::Track under mMutexMapUpdate), so no frame of
        its is solved against points that then move under it, and a loop
        correction's rule is the port's for a local BA too: a frame solved
        before the BA and chained across it went 1.2-1.6 m off where few
        points were in view (ROADMAP.md, deliberate divergences).

        A deliberate divergence from the JAX package: a pipelined frame that
        failed where the JAX package fails it (the motion model and then the
        reference-keyframe fallback, or the local map), and was dispatched
        before a keyframe was created (it chained across the keyframe without
        its new points), is dispatched again against the map with them
        instead of being lost. The JAX package loses it, and with five
        keyframes or fewer resets the map (ROADMAP.md, deliberate
        divergences)."""
        for _attempt in range(2):
            with self.map_lock:
                if self.map.correction_gen == rec["corr_gen"] and not self._ref_moved(rec):
                    ret = self._fused_apply(rec, fetched)
                    if ret is not _MISSED_KEYFRAME:
                        return ret
                    self.retracked_frames += 1
                else:
                    self.rebuilt_frames += 1
                self._last_pid_dev = None
                self._carry_wrong = True
            rec = self._fused_dispatch(rec["kind"], rec["imgs_d"],
                                       rec["timestamp"], frame_id=rec["frame_id"],
                                       chain_off_pipe=False)
            with self.stats.stage("fused_dev"):
                fetched = self._fetch_now(rec["out"])
        with self.map_lock:
            self.rebuilt_frames += 1
            fr = self._build_frame(rec["kind"], rec["imgs_d"], rec["timestamp"])
            return self._track_locked(fr)

    def _missed_keyframe(self, rec: dict) -> bool:
        """A keyframe was created after the frame was dispatched."""
        return self.last_kf_frame_id != rec["kf_snap"]

    def _retrack_sync(self, rec: dict) -> Optional[np.ndarray]:
        """Track again a frame whose chained dispatch was invalidated: a
        fused dispatch from the applied state while tracking is healthy, the
        classic path otherwise."""
        self.retracked_frames += 1
        with self.map_lock:
            classic = (self.state != TrackingState.OK or self.velocity is None
                       or self.cfg.localization_only)
            if classic:
                fr = self._build_frame(rec["kind"], rec["imgs_d"], rec["timestamp"])
                return self._track_locked(fr)
        self._carry_wrong = False
        rec2 = self._fused_dispatch(rec["kind"], rec["imgs_d"], rec["timestamp"],
                                    frame_id=rec["frame_id"], chain_off_pipe=False)
        with self.stats.stage("fused_dev"):
            fetched = self._fetch_now(rec2["out"])
        return self._apply_one(rec2, fetched)

    @graph_capture.entry()
    def flush_frames(self) -> None:
        """Apply every pipelined frame in flight (waits for their fetch).
        Precedes every read of per-frame bookkeeping (trajectory, savers)
        and every classic-path frame."""
        entry, self._inflight = self._inflight, None
        pending, self._pending = self._pending, []
        kf0 = self.last_kf_frame_id
        broke = False
        if entry is not None:
            _, broke = self._finish_batch(entry)
        if pending:
            if entry is not None and not self._chain_ok(broke, kf0):
                for rec in pending:
                    self._retrack_sync(rec)
            else:
                self._finish_batch(self._submit_batch_fetch(pending))

    def _fused_apply(self, rec: dict, fetched):
        """Host bookkeeping for a fused frame step (map lock held).
        Associations staged before a mid-flight mapping change are validated
        again: erased or re-allocated point slots (pt_stamp >= the staging
        snapshot) are dropped, as the reference tracker's per-use isBad()
        checks drop them. -> the pose, or None when lost; _MISSED_KEYFRAME,
        with nothing finished, when the frame failed and a keyframe it did
        not see was created after its dispatch (_apply_one dispatches it
        again)."""
        (tcw_h, pid_h, outl_h, vis_h, mm_m, mm_in, n_in, depth_h,
         ur_h) = fetched
        out = rec["out"]
        frame_id = rec["frame_id"]
        stamp_snap = rec["stamp_snap"]
        self._update_last_frame()
        fr = frame_mod.Frame(
            frame_id=frame_id, timestamp=rec["timestamp"], kp=out.kp,
            ur=out.ur, depth=out.depth,
            tcw=np.asarray(tcw_h, np.float32).copy(),
            pt_ids=np.full(out.kp.n, -1, np.int32),
            is_outlier=np.zeros(out.kp.n, bool))
        fr._host_depth = (depth_h, ur_h)

        if mm_m < 20 or mm_in < 10:
            # motion-model failure: reference-KF fallback on the classic
            # path (rare; costs the extra fetches only on these frames)
            self._last_pid_dev = None
            self._carry_wrong = True
            fr.tcw = (self.velocity @ self.last_frame.tcw).astype(np.float32)
            ok = self._track_reference_keyframe(fr)
            if ok:
                with self.stats.stage("local_map"):
                    ok = self._track_local_map(fr)
            if not ok and self._missed_keyframe(rec):
                self._selection_fresh = False
                return _MISSED_KEYFRAME
            return self._finish_frame(fr, ok)

        m = self.map
        pid_h = np.asarray(pid_h, np.int32)
        pid = self._resolve(pid_h, stamp_snap)
        changed = pid != pid_h
        stale = changed & (pid < 0)
        self.revalidated_frames += bool(changed.any())
        self.remapped_ids += int((changed & ~stale).sum())
        fr.pt_ids = pid
        fr.is_outlier = np.asarray(outl_h).copy()
        fr.is_outlier[stale] = False
        self.matches_inliers = n_in
        self._map_inliers = int((fr.pt_ids >= 0).sum())
        min_inliers = 30 if frame_id - self.last_reloc_frame_id > 30 else 50
        ok = n_in >= min_inliers
        if not ok and self._missed_keyframe(rec):
            return _MISSED_KEYFRAME
        if ok:
            lp = rec["local_pts"]
            vis_ids = lp[vis_h[: len(lp)]]
            vis_ids = vis_ids[m.pt_valid[vis_ids] & (m.pt_stamp[vis_ids] < stamp_snap)]
            m.increase_visible(vis_ids)
            m.increase_found(fr.pt_ids[fr.pt_ids >= 0])
            # the device carry (and a frame chained off this one) holds the
            # stale ids too
            self._last_pid_dev = None if changed.any() else out.pt_ids
            self._carry_wrong = self._carry_wrong or bool(changed.any())
        else:
            self._last_pid_dev = None
        return self._finish_frame(fr, ok)

    # ------------------------------------------------------------------
    # initialization (Tracking::StereoInitialization)
    # ------------------------------------------------------------------
    def _stereo_initialization(self, fr: frame_mod.Frame) -> bool:
        h = fr.host_kp()
        depth, valid = h.depth, h.valid
        n_usable = int(valid.sum())
        if n_usable < self.cfg.min_init_features:
            return False
        fr.tcw = np.eye(4, dtype=np.float32)
        kf = self._insert_keyframe(fr)
        # create a map point for every keypoint with positive depth
        # (one batched insertion; frame 0 camera frame == world frame)
        idx = np.where(valid & (depth > 0))[0]
        pts_cam = self.cam.backproject_np(h.xy[idx], depth[idx])
        new_pts = self.map.add_points_batch(pts_cam, h.desc[idx], kf,
                                            fr.frame_id)
        idx = idx[: len(new_pts)]
        self.map.kf_pt[kf, idx] = new_pts
        self.map.touch_obs()
        fr.pt_ids[idx] = new_pts
        self.map.update_point_descriptor_and_normal(
            new_pts, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)
        self.ref_kf = kf
        self.last_kf_frame_id = fr.frame_id
        self._covis_w = covisibility.weight_matrix(self.map)
        if self.kfdb is not None:
            self.kfdb.add(kf, self._word_ids(fr))
        return True

    # ------------------------------------------------------------------
    # monocular initialization (Tracking::MonocularInitialization and
    # CreateInitialMapMonocular)
    # ------------------------------------------------------------------
    def _monocular_initialization(self, fr: frame_mod.Frame) -> bool:
        """Two views: the first frame with more than 100 keypoints waits as
        the reference; the next one is matched to it (radius 100, level 0,
        Hamming 50, ratio 0.9) and, with at least 100 matches, solved by the
        two-view initializer. On success: the median scene depth scaled to
        1, two keyframes, a point for every good pair, the initial bundle
        adjustment and the keyframe database."""
        n_kp = int(fr.host_kp().valid.sum())
        if self._init_ref is None:
            if n_kp > 100:
                self._init_ref = fr
            return False
        if n_kp <= 100:
            self._init_ref = None
            return False
        ref = self._init_ref
        level0 = (ref.kp.octave == 0) & ref.kp.valid
        zeros = torch.zeros(ref.n, dtype=ref.kp.octave.dtype, device=self.device)
        res = match_ops.windowed_match(
            ref.kp.xy, ref.kp.desc, level0,
            torch.full((ref.n,), 100.0, device=self.device), zeros, zeros, fr.kp,
            max_dist=50, ratio=0.9)
        best_kp = res.best_kp.cpu().numpy()
        sel = best_kp >= 0
        if int(sel.sum()) < 100:
            self._init_ref = None  # start again from this side
            return False

        uv2 = np.zeros((ref.n, 2), np.float32)
        uv2[sel] = fr.host_kp().xy[best_kp[sel]]
        # through the module attributes, so that a test can hand in the
        # JAX package's draws
        sets = horn.draw_sample_sets(sel, 200, 8, int(fr.frame_id), self.device)
        init = initializer.initialize_two_view(
            ref.kp.xy, self._dev(uv2), self._dev(sel), self.cam.k_matrix(self.device), sets)
        if not bool(init.success):
            return False
        good = init.good.cpu().numpy()
        pts = init.points.cpu().numpy()
        r21 = init.r21.cpu().numpy()
        t21 = init.t21.cpu().numpy()

        # median-depth normalization: the scene's median depth becomes 1
        med = float(np.median(pts[good, 2]))
        if med <= 0 or good.sum() < 50:
            return False
        inv_med = 1.0 / med
        pts = pts * inv_med
        tcw2 = np.eye(4, dtype=np.float32)
        tcw2[:3, :3] = r21
        tcw2[:3, 3] = t21 * inv_med

        ref.tcw = np.eye(4, dtype=np.float32)
        fr.tcw = tcw2
        kf1 = self._insert_keyframe(ref)
        kf2 = self._insert_keyframe(fr)
        idx = np.where(good & sel)[0]
        new_pts = self.map.add_points_batch(
            pts[idx], ref.host_kp().desc[idx], kf1, int(ref.frame_id))
        idx = idx[: len(new_pts)]
        self.map.kf_pt[kf1, idx] = new_pts
        self.map.kf_pt[kf2, best_kp[idx]] = new_pts
        self.map.touch_obs()
        ref.pt_ids[idx] = new_pts
        fr.pt_ids[best_kp[idx]] = new_pts
        if len(new_pts) < 50:
            self.map.clear()
            self._init_ref = None
            return False
        self.map.update_point_descriptor_and_normal(
            new_pts, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)
        self._covis_w = covisibility.weight_matrix(self.map)
        covisibility.assign_spanning_parent(self.map, self._covis_w, kf2)

        # the initial bundle adjustment over both keyframes
        if self.local_mapper is not None:
            self.local_mapper._local_ba(kf2, self._covis_w)
        if self.kfdb is not None:
            self.kfdb.add(kf1, self._word_ids(ref))
            self.kfdb.add(kf2, self._word_ids(fr))
        self.ref_kf = kf2
        self.last_kf_frame_id = fr.frame_id
        self._init_ref = None
        return True

    # ------------------------------------------------------------------
    def _update_last_frame(self) -> None:
        """Refresh last frame's pose from its reference keyframe and, in
        localization mode, make temporal visual-odometry points of its
        unmatched keypoints with depth: every close one, at least the 100
        nearest (Tracking::UpdateLastFrame). First the associations of the
        last frame and of the local selection made with it are brought up to
        date with the map (Tracking::CheckReplacedInLastFrame): a point merged
        into another since becomes that point, an erased or re-allocated one
        is dropped, and a merged or re-allocated id drops the device carry."""
        self._vo_mask = self._vo_pos = None
        self._aux_mask = self._aux_pos = None
        if not self.trajectory:
            return
        self._check_replaced()
        entry = self.trajectory[-1]
        if entry.ref_kf >= 0 and self.map.kf_valid[entry.ref_kf]:
            self.last_frame.tcw = entry.tcr @ self.map.kf_pose[entry.ref_kf]
        if not self.cfg.localization_only:
            return
        last = self.last_frame
        h = last.host_kp()
        cand = np.where(h.valid & (h.depth > 0) & (last.pt_ids < 0))[0]
        if len(cand) == 0:
            return
        order = cand[np.argsort(h.depth[cand])]
        n_close = int((h.depth[order] < self.cfg.th_depth).sum())
        take = order[:max(n_close, min(100, len(order)))]
        twc = np.linalg.inv(last.tcw)
        pw = self.cam.backproject_np(h.xy[take], h.depth[take]) @ twc[:3, :3].T + twc[:3, 3]
        self._vo_mask = np.zeros(last.n, bool)
        self._vo_mask[take] = True
        self._vo_pos = np.zeros((last.n, 3), np.float32)
        self._vo_pos[take] = pw

    def _resolve(self, ids, stamp_snap) -> np.ndarray:
        """MapState.resolve_replaced, its counts added to the tracker's."""
        out, reused, lost = self.map.resolve_replaced(ids, stamp_snap)
        self.reused_slot_ids += reused
        self.replacements_lost += lost
        return out

    def _check_replaced(self) -> None:
        """Remap the last frame's ids and the local selection through
        MapState.resolve_replaced (called from _update_last_frame)."""
        m, last = self.map, self.last_frame
        ids = self._resolve(last.pt_ids, last.pt_stamp)
        changed = ids != last.pt_ids
        if changed.any():
            remapped = changed & (ids >= 0)
            self.remapped_ids += int(remapped.sum())
            # the device step reads an erased id as no point, but a merged
            # or re-allocated one as a point: the carry goes for those
            if (remapped | (changed & m.pt_valid[np.maximum(last.pt_ids, 0)])).any():
                self._last_pid_dev = None
            last.pt_ids = ids
        last.pt_stamp = m._pt_counter
        if self._local_pts is not None and len(self._local_pts):
            n = len(self._local_pts)
            sel_ids = self._resolve(self._local_pts, self._local_stamp)
            moved = np.flatnonzero(sel_ids != self._local_pts)
            if len(moved):
                ids_pad, sel = self._local_ids.copy(), self._local_sel.copy()
                pts = self._local_pts.copy()
                sel[moved] = False
                # a merged point takes its victim's place in the candidate
                # order, unless the list holds it already
                present = set(pts[sel[:n]].tolist())
                for i in moved:
                    t = int(sel_ids[i])
                    if t >= 0 and t not in present:
                        pts[i] = ids_pad[i] = t
                        sel[i] = True
                        present.add(t)
                self._local_ids, self._local_sel, self._local_pts = ids_pad, sel, pts
        self._local_stamp = m._pt_counter

    # ------------------------------------------------------------------
    # localization mode (Tracking::Track with mbOnlyTracking): with enough
    # map matches track as usual; on temporal points only (mb_vo) run the
    # motion model and relocalization in the same frame and prefer the
    # relocalization
    # ------------------------------------------------------------------
    def _track_localization_mode(self, fr: frame_mod.Frame) -> bool:
        if not self.mb_vo:
            if self.velocity is not None:
                return self._track_with_motion_model(fr)
            return self._track_reference_keyframe(fr)
        ok_mm = False
        kept = None
        if self.velocity is not None:
            ok_mm = self._track_with_motion_model(fr)
            kept = (fr.tcw.copy(), fr.pt_ids.copy(), fr.is_outlier.copy(),
                    self.matches_inliers)
        ok_reloc = self._relocalize(fr)
        if ok_mm and not ok_reloc:
            fr.tcw, fr.pt_ids, fr.is_outlier, self.matches_inliers = kept
            if self.mb_vo:
                # surviving on temporal points, matched map points count as
                # found
                self.map.increase_found(fr.pt_ids[(fr.pt_ids >= 0) & ~fr.is_outlier])
        elif ok_reloc:
            self.mb_vo = False   # map tracking restored
            # the relocalization's associations replace the motion model's,
            # its temporal matches included (vpMPsMM is dropped)
            self._aux_mask = self._aux_pos = None
        return ok_reloc or ok_mm

    # ------------------------------------------------------------------
    # motion-model tracking
    # ------------------------------------------------------------------
    def _track_with_motion_model(self, fr: frame_mod.Frame) -> bool:
        last = self.last_frame
        tcw_pred = (self.velocity @ last.tcw).astype(np.float32)
        last_pt = last.pt_ids
        has_map_pt = (last_pt >= 0) & self.map.pt_valid[np.maximum(last_pt, 0)]
        vo = self._vo_mask
        has_pt = has_map_pt if vo is None else (has_map_pt | vo)
        if has_pt.sum() < 10:
            return False
        pos = np.zeros((last.n, 3), np.float32)
        pos[has_map_pt] = self.map.pt_pos[last_pt[has_map_pt]]
        if vo is not None:
            only_vo = vo & ~has_map_pt
            pos[only_vo] = self._vo_pos[only_vo]

        # search (with conditional widen), observation staging, and robust
        # pose LM in one step + one fetch
        step = _host_step(self._step_program(kernels.MotionModelProgram)(
            self._dev(tcw_pred), self._dev(pos), self._dev(has_pt),
            last.kp.desc, last.kp.octave, last.kp.angle, fr.kp, fr.ur))
        assoc = step.assoc
        if step.n_matches < 20:
            return False

        fr.pt_ids[:] = -1
        m = assoc >= 0
        fr.pt_ids[m] = last_pt[assoc[m]]
        aux_pos = aux_mask = None
        if vo is not None:
            # matches on temporal points carry their own world position
            # instead of a map id
            aux_mask = np.zeros(fr.n, bool)
            aux_pos = np.zeros((fr.n, 3), np.float32)
            idx = np.where(m & (fr.pt_ids < 0))[0]
            idx = idx[vo[assoc[idx]]]
            aux_mask[idx] = True
            aux_pos[idx] = pos[assoc[idx]]
        fr.tcw = tcw_pred
        ok = self._apply_pose_result(fr, step, min_inliers=10)
        # the local-map stage keeps them: in localization mode the inlier
        # count includes temporal points
        self._aux_pos, self._aux_mask = aux_pos, aux_mask
        if self.cfg.localization_only:
            # mbVO: under 10 map-point inliers the frame tracks on temporal
            # points; it survives on more than 20 inliers in all
            self.mb_vo = self._map_inliers < 10
            return self.matches_inliers > 20
        return ok

    # ------------------------------------------------------------------
    # reference-KF tracking
    # ------------------------------------------------------------------
    def _track_reference_keyframe(self, fr: frame_mod.Frame) -> bool:
        kf = self.ref_kf
        if kf < 0 or not self.map.kf_valid[kf]:
            return False
        kf_pt = self.map.kf_pt[kf]
        q_valid = (kf_pt >= 0) & self.map.kf_kp_valid[kf]
        best_kp, _ = kernels.search_by_descriptor(
            self._dev(self.map.kf_kp_desc[kf].view(np.int32)),
            self._dev(q_valid), self._dev(self.map.kf_kp_angle[kf]),
            fr.kp, self.cam)
        best_kp = best_kp.cpu().numpy()  # [Q] -> current kp slot
        n_matches = int((best_kp >= 0).sum())
        if n_matches < 15:
            return False
        fr.pt_ids[:] = -1
        sel = best_kp >= 0  # targets unique (resolve_conflicts)
        fr.pt_ids[best_kp[sel]] = kf_pt[sel]
        if self.last_frame is not None:
            fr.tcw = self.last_frame.tcw.copy()
        else:  # e.g. first frame after a map load: start from the ref KF
            fr.tcw = self.map.kf_pose[kf].copy()
        return self._optimize_frame_pose(fr, min_inliers=10)

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Tracking::Reset: clear map and tracking state; trajectory
        bookkeeping survives for export (entries referencing cleared
        keyframes resolve to their last pose). Frames in flight are
        discarded, each with one lost entry."""
        entry, self._inflight = self._inflight, None
        pending, self._pending = self._pending, []
        for rec in (entry[0] if entry else []) + pending:
            self.trajectory.append(FrameTrajectoryEntry(
                tcr=np.eye(4, dtype=np.float32), ref_kf=-1, ref_order=-1,
                timestamp=rec["timestamp"], lost=True))
        self.map.clear()
        if self.kfdb is not None:
            self.kfdb.__init__(self.kfdb.voc, self.cfg.max_keyframes)
        if self.loop_closer is not None:
            self.loop_closer.reset()
        if self.local_mapper is not None:
            self.local_mapper._recent.clear()
        self.state = TrackingState.NOT_INITIALIZED
        self.velocity = None
        self.ref_kf = -1
        self._init_ref = None
        self._covis_w = None
        self._local_ids = self._local_sel = self._local_pts = None
        self._selection_fresh = False
        self._last_pid_dev = None
        self.mb_vo = False

    # ------------------------------------------------------------------
    def _word_ids(self, fr: frame_mod.Frame) -> Optional[np.ndarray]:
        """The frame's BoW word ids (on the tracker's device) as numpy."""
        if self.vocabulary is None:
            return None
        return self.vocabulary.transform_packed(fr.kp.desc, fr.kp.valid).cpu().numpy()

    # ------------------------------------------------------------------
    # Relocalization (Tracking::Relocalization): KFDB candidates ->
    # descriptor matching -> EPnP RANSAC -> pose optimization, escalated.
    # Without a vocabulary: one candidate, the reference keyframe.
    # ------------------------------------------------------------------
    def _relocalize(self, fr: frame_mod.Frame) -> bool:
        if self.kfdb is None:
            fr.tcw = self.last_frame.tcw.copy() if self.last_frame is not None \
                else np.eye(4, dtype=np.float32)
            ok = self._track_reference_keyframe(fr)
            if ok:
                self.last_reloc_frame_id = fr.frame_id
            return ok

        wids = self._word_ids(fr)
        w = self._covis_w if self._covis_w is not None \
            else covisibility.weight_matrix(self.map)
        m = self.map
        hk = fr.host_kp()
        for cand in self.kfdb.detect_reloc_candidates(wids, w)[:5]:
            if not m.kf_valid[cand]:
                continue
            q_valid = (m.kf_pt[cand] >= 0) & m.kf_kp_valid[cand]
            best_kp, _ = kernels.search_by_descriptor(
                self._dev(m.kf_kp_desc[cand].view(np.int32)), self._dev(q_valid),
                self._dev(m.kf_kp_angle[cand]), fr.kp, self.cam,
                max_hamming=50, ratio=0.75)
            best_kp = best_kp.cpu().numpy()
            qs = np.where(best_kp >= 0)[0]
            if len(qs) < 15:
                continue
            cap = 512
            qs = qs[:cap]
            n = len(qs)
            pts = np.zeros((cap, 3), np.float32)
            uv = np.zeros((cap, 2), np.float32)
            sigma2 = np.ones(cap, np.float32)
            valid = np.zeros(cap, bool)
            pids = m.kf_pt[cand, qs]
            pts[:n] = m.pt_pos[pids]
            kp_idx = best_kp[qs]
            uv[:n] = hk.xy[kp_idx]
            sigma2[:n] = self.cfg.orb.scale_factor ** (2.0 * hk.octave[kp_idx])
            valid[:n] = m.pt_valid[pids]
            if valid.sum() < 4:
                continue
            sets = horn.draw_sample_sets(valid, 300, 4, fr.frame_id * 17 + int(cand),
                                         self.device)
            res = epnp.epnp_ransac(self._dev(pts), self._dev(uv), self._dev(valid),
                                   self._dev(sigma2), self.cam, sets)
            if not bool(res.success):
                continue
            fr.tcw = res.tcw.cpu().numpy().astype(np.float32)
            fr.pt_ids[:] = -1
            inl = res.inliers.cpu().numpy()[:n]
            fr.pt_ids[kp_idx[inl]] = pids[inl]
            # the reference's escalation: pose optimization; under 50
            # inliers a widened projection search (th=10, ORBdist=100) and
            # another optimization; between 30 and 50 a narrow pass (th=3,
            # ORBdist=64) and a last one; accepted only at >= 50
            if not self._optimize_frame_pose(fr, min_inliers=10):
                continue
            n_good = self.matches_inliers
            if n_good < 50:
                n_add = self._reloc_project_candidate(fr, cand, 3.0, 100)
                if n_good + n_add >= 50:
                    self._optimize_frame_pose(fr, min_inliers=1)
                    n_good = self.matches_inliers
                    if 30 < n_good < 50:
                        n_add = self._reloc_project_candidate(fr, cand, 0.75, 64)
                        if n_good + n_add >= 50:
                            self._optimize_frame_pose(fr, min_inliers=1)
                            n_good = self.matches_inliers
            if n_good >= 50:
                self.last_reloc_frame_id = fr.frame_id
                self.ref_kf = int(cand)
                return True
        return False

    def _reloc_project_candidate(self, fr: frame_mod.Frame, cand: int,
                                 radius_mult: float, max_hamming: int) -> int:
        """SearchByProjection(F, KF, sFound, th, ORBdist) of relocalization:
        project the candidate keyframe's map points into the frame with a
        widened window, matching only free keypoints and skipping points
        already associated. The radius is the view-angle base (2.5/4.0 px)
        times `radius_mult`, as in the JAX package: th=10 is radius_mult=3.0,
        th=3 is 0.75. -> the number of new associations."""
        m = self.map
        pids = m.kf_pt[cand]
        safe = np.clip(pids, 0, m.pt_pos.shape[0] - 1)
        valid = (pids >= 0) & m.kf_kp_valid[cand] & m.pt_valid[safe]
        valid &= ~np.isin(pids, fr.pt_ids[fr.pt_ids >= 0])
        kp_taken = fr.pt_ids >= 0
        _, res = kernels.search_local_points(
            self._dev(fr.tcw), self._dev(m.pt_pos[safe]),
            self._dev(m.pt_desc[safe].view(np.int32)), self._dev(valid),
            self._dev(m.pt_normal[safe]), self._dev(m.pt_min_dist[safe]),
            self._dev(m.pt_max_dist[safe]), fr.kp, self._dev(kp_taken),
            radius_mult, self.cam, self.cfg.orb.scale_factor, self.cfg.orb.n_levels,
            max_hamming=max_hamming)
        assoc = res.assoc.cpu().numpy()
        newly = (assoc >= 0) & ~kp_taken
        fr.pt_ids[newly] = pids[assoc[newly]]
        return int(newly.sum())

    # ------------------------------------------------------------------
    # local-map tracking
    # ------------------------------------------------------------------
    def _track_local_map(self, fr: frame_mod.Frame) -> bool:
        # this IS the selection the next frame's fused step needs — store
        # it so _finish_frame skips an identical recompute (one-frame lag
        # either way); invalidated if this frame creates a keyframe
        sel_ids, sel_all, pt_ids = self._select_local(fr)
        self._local_ids, self._local_sel, self._local_pts = \
            sel_ids, sel_all, pt_ids
        self._local_stamp = self.map._pt_counter
        self._selection_fresh = True
        n_local = len(pt_ids)
        # don't re-match points already associated by motion-model tracking
        already = np.isin(pt_ids, fr.pt_ids[fr.pt_ids >= 0])
        kp_taken = fr.pt_ids >= 0
        radius_mult = 3.0 if fr.frame_id - self.last_reloc_frame_id < 2 else 1.0

        # prior associations (motion model / reloc / localization-mode
        # temporal points) keep their staged world positions through the
        # second pose optimization
        aux_pos = aux_mask = None
        if self.cfg.localization_only:
            aux_pos, aux_mask = self._aux_pos, self._aux_mask
        prior_mask = kp_taken.copy()
        prior_pos = np.zeros((fr.n, 3), np.float32)
        prior_pos[kp_taken] = self.map.pt_pos[fr.pt_ids[kp_taken]]
        if aux_mask is not None:
            sel_aux = aux_mask & ~prior_mask
            prior_mask |= sel_aux
            prior_pos[sel_aux] = aux_pos[sel_aux]

        min_inliers = 30 if fr.frame_id - self.last_reloc_frame_id > 30 else 50
        m = self.map
        if self.cfg.device_local_map:
            # device-resident map: ship only the local id list; rows are
            # gathered on device from the synced mirror, and the search, the
            # observation staging and the second pose optimization are one
            # step
            mir = m.device_mirror(self.device)
            sel = sel_all.copy()
            sel[:n_local] = ~already
            step = _host_step(self._step_program(kernels.LocalMapProgram)(
                self._dev(fr.tcw), self._dev(sel_ids).long(), self._dev(sel),
                mir.pt_pos, mir.pt_desc, mir.pt_valid, mir.pt_normal,
                mir.pt_min_dist, mir.pt_max_dist,
                fr.kp, fr.ur, self._dev(prior_pos), self._dev(prior_mask),
                radius_mult))
            assoc, visible = step.assoc, step.visible
        else:
            # host-staged: the local points' rows are gathered on the host
            # and shipped with the frame
            cap = len(sel_ids)

            def rows(a, dtype=None):
                out = np.zeros((cap,) + a.shape[1:], dtype or a.dtype)
                out[:n_local] = a[pt_ids]
                return self._dev(out)

            valid = np.zeros(cap, bool)
            valid[:n_local] = ~already
            info, res = kernels.search_local_points(
                self._dev(fr.tcw), rows(m.pt_pos), rows(m.pt_desc.view(np.int32)),
                self._dev(valid), rows(m.pt_normal), rows(m.pt_min_dist),
                rows(m.pt_max_dist), fr.kp, self._dev(kp_taken), radius_mult,
                self.cam, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)
            assoc = res.assoc.cpu().numpy()
            visible = info.visible.cpu().numpy()
            step = None

        newly = assoc >= 0
        fr.pt_ids[newly] = pt_ids[assoc[newly]]
        # visibility counters (SearchLocalPoints)
        m.increase_visible(pt_ids[visible[:n_local]])

        if step is not None:
            ok = self._apply_pose_result(fr, step, min_inliers)
        else:
            ok = self._optimize_frame_pose(fr, min_inliers, aux_pos=aux_pos,
                                           aux_mask=aux_mask)
        if ok:
            tracked = fr.pt_ids[(fr.pt_ids >= 0) & ~fr.is_outlier]
            self.map.increase_found(tracked)
        return ok

    # ------------------------------------------------------------------
    def _apply_pose_result(self, fr: frame_mod.Frame, step,
                           min_inliers: int) -> bool:
        """Host bookkeeping after a search+optimize device step (already
        fetched: numpy): outlier clearing, inlier counters, pose
        acceptance."""
        has_pt = fr.pt_ids >= 0
        fr.is_outlier = has_pt & ~step.inlier
        fr.pt_ids[fr.is_outlier] = -1
        self.matches_inliers = step.n_inliers
        # inliers that are real map points
        self._map_inliers = int((fr.pt_ids >= 0).sum())
        if step.n_inliers < min_inliers:
            return False
        fr.tcw = np.asarray(step.tcw)
        return True

    # ------------------------------------------------------------------
    def _optimize_frame_pose(self, fr: frame_mod.Frame, min_inliers: int,
                             aux_pos: Optional[np.ndarray] = None,
                             aux_mask: Optional[np.ndarray] = None) -> bool:
        """aux_pos/aux_mask: per-slot world positions of observations that
        are not map points (localization-mode temporal points)."""
        has_pt = fr.pt_ids >= 0
        used = has_pt if aux_mask is None else (has_pt | aux_mask)
        if used.sum() < 4:
            return False
        pos = np.zeros((fr.n, 3), np.float32)
        pos[has_pt] = self.map.pt_pos[fr.pt_ids[has_pt]]
        if aux_mask is not None:
            sel = aux_mask & ~has_pt
            pos[sel] = aux_pos[sel]
        obs = kernels.build_pose_obs_from_frame(
            fr.kp, fr.ur, self._dev(pos), self._dev(used),
            self.cfg.orb.scale_factor)
        tcw, inlier, n_in = pose_opt.pose_optimization(
            self._dev(fr.tcw), obs, self.cam)
        step = SimpleNamespace(tcw=tcw.cpu().numpy(),
                               inlier=inlier.cpu().numpy(), n_inliers=int(n_in))
        return self._apply_pose_result(fr, step, min_inliers)

    # ------------------------------------------------------------------
    # keyframe decision (Tracking::NeedNewKeyFrame)
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, fr: frame_mod.Frame) -> bool:
        n_kfs = self.map.n_keyframes()
        if n_kfs >= self.cfg.max_keyframes - 2:
            return False
        # bLocalMappingIdle: the worker has drained its queue and finished;
        # without a worker mapping runs inline and is always idle
        mapping_idle = self.mapping_worker is None or self.mapping_worker.idle()
        if self.cfg.force_kf_every is not None:
            if self.mapping_worker is not None \
                    and not self.mapping_worker.accept_keyframes():
                return False
            return (fr.frame_id - self.last_kf_frame_id >= self.cfg.force_kf_every
                    and self.matches_inliers > 15)
        # reference tracked-point count in the reference keyframe
        min_obs = 3 if n_kfs > 2 else 2
        obs_count = self.map.point_obs_count()
        ref_pts = self.map.kf_pt[self.ref_kf]
        ref_tracked = int(((ref_pts >= 0) & (obs_count[np.maximum(ref_pts, 0)] >= min_obs)).sum())

        # close-point statistics (RGBD/stereo)
        depth, _ = fr.host_depth_ur()
        close = (depth > 0) & (depth < self.cfg.th_depth)
        tracked_close = int((close & (fr.pt_ids >= 0) & ~fr.is_outlier).sum())
        non_tracked_close = int((close & (fr.pt_ids < 0)).sum())
        need_close = tracked_close < 100 and non_tracked_close > 70

        frames_since_kf = fr.frame_id - self.last_kf_frame_id
        # conditions exactly as the reference's c1a/c1b/c1c/c2; a monocular
        # tracker has no c1c and a reference ratio of 0.9
        c1a = frames_since_kf >= self.cfg.max_frames_between_kf
        c1b = frames_since_kf >= self.cfg.min_frames_between_kf and mapping_idle
        c1c = not self.is_mono and (
            self.matches_inliers < ref_tracked * 0.25 or need_close)
        if self.is_mono:
            th_ref = 0.9
        else:
            th_ref = 0.75 if n_kfs >= 2 else 0.4
        c2 = (self.matches_inliers < ref_tracked * th_ref or need_close) \
            and self.matches_inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if mapping_idle:
            return True
        # mapping busy: signal the BA abort; stereo and RGB-D may queue up to
        # 3 keyframes, a monocular tracker never queues
        if self.local_mapper is not None:
            self.local_mapper.interrupt_ba = True
        if self.is_mono:
            return False
        return self.mapping_worker.queue_size() < 3

    # ------------------------------------------------------------------
    # keyframe creation (Tracking::CreateNewKeyFrame)
    # ------------------------------------------------------------------
    def _create_new_keyframe(self, fr: frame_mod.Frame) -> None:
        with self.stats.stage("kf_insert"):
            kf = self._insert_keyframe(fr)
        self.ref_kf = kf
        self.last_kf_frame_id = fr.frame_id
        # a keyframe changes the map (spawned points, covisibility): any
        # selection computed earlier this frame is stale
        self._selection_fresh = False
        # existing associations become observations (one scatter)
        obs_sel = (fr.pt_ids >= 0) & self.map.pt_valid[np.maximum(fr.pt_ids, 0)]
        self.map.kf_pt[kf, obs_sel] = fr.pt_ids[obs_sel]
        self.map.touch_obs()
        # RGBD: spawn points for the closest unmatched keypoints
        h = fr.host_kp()
        depth, valid = h.depth, h.valid
        candidates = np.where(valid & (depth > 0) & (fr.pt_ids < 0))[0]
        if len(candidates):
            with self.stats.stage("kf_new_points"):
                order = candidates[np.argsort(depth[candidates])]
                # spawn every close point, and far points only within the
                # budget (the reference's depth-sorted break); depth-sorted
                # order makes the break equivalent to this filter
                take = order[(depth[order] <= self.cfg.th_depth)
                             | (np.arange(len(order))
                                < self.cfg.max_new_points_per_kf)]
                pts_cam = self.cam.backproject_np(h.xy[take], depth[take])
                twc = np.linalg.inv(fr.tcw)
                pts_w = pts_cam @ twc[:3, :3].T + twc[:3, 3]
                new_pts = self.map.add_points_batch(
                    pts_w.astype(np.float32), h.desc[take], kf, fr.frame_id)
                take = take[: len(new_pts)]
                self.map.kf_pt[kf, take] = new_pts
                self.map.touch_obs()
                fr.pt_ids[take] = new_pts
                fr.pt_stamp = self.map._pt_counter
                # the device-side carry no longer matches fr.pt_ids
                self._last_pid_dev = None
                self.map.update_point_descriptor_and_normal(
                    new_pts, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)
        with self.stats.stage("kf_covis"):
            self._covis_w = covisibility.weight_matrix(self.map)
            covisibility.assign_spanning_parent(self.map, self._covis_w, kf)
        wids = self._word_ids(fr)
        if self.mapping_worker is not None:
            # hand the keyframe to the background worker
            with self.stats.stage("kf_handoff"):
                self.mapping_worker.insert_keyframe(kf, wids)
            if self.mapping_worker.sync_mapping:
                # the keyframe was mapped inline: its triangulated points
                # are the monocular map's only new points, and a pipelined
                # frame in flight was dispatched against the map before
                # them. Left to land, its depleted inlier ratio fires the
                # keyframe decision again and keyframes cascade (the JAX
                # package measured 94 keyframes against 71 on the mono
                # circuit, the capacity hit and the loop missed): the frame
                # in flight is dispatched again against the new map
                self._carry_wrong = True
            return
        if self.local_mapper is not None:
            self.local_mapper.process_keyframe(kf)
            self._covis_w = covisibility.weight_matrix(self.map)
        # place recognition: loop detection (which adds to the KFDB) or a
        # plain add
        if wids is not None and self.map.kf_valid[kf]:
            if self.loop_closer is not None:
                if self.loop_closer.process_keyframe(kf, wids):
                    self._covis_w = covisibility.weight_matrix(self.map)
            elif self.kfdb is not None:
                self.kfdb.add(kf, wids)

    # ------------------------------------------------------------------
    def _insert_keyframe(self, fr: frame_mod.Frame) -> int:
        h = fr.host_kp()  # one batched fetch for all eight arrays
        return self.map.add_keyframe(
            pose=fr.tcw,
            timestamp=fr.timestamp,
            frame_id=fr.frame_id,
            kp_xy=h.xy,
            kp_octave=h.octave,
            kp_angle=h.angle,
            kp_response=h.response,
            kp_desc=h.desc,
            kp_valid=h.valid,
            kp_ur=h.ur,
            kp_depth=h.depth,
        )

    # ------------------------------------------------------------------
    def _record_trajectory(self, fr: frame_mod.Frame, lost: bool) -> None:
        # solved-pose hook: with the pipelined fetch this fires a frame after
        # the track_* call, which returned the motion-model prediction for a
        # frame in flight; the stamps stay the frames' own
        if self.applied_pose_cb is not None:
            self.applied_pose_cb(fr.timestamp, None if lost else fr.tcw.copy())
        if self.ref_kf >= 0 and self.map.kf_valid[self.ref_kf]:
            tcr = fr.tcw @ np.linalg.inv(self.map.kf_pose[self.ref_kf])
            ref_order = int(self.map.kf_order[self.ref_kf])
        else:
            tcr = np.eye(4, dtype=np.float32)
            ref_order = -1
        self.trajectory.append(FrameTrajectoryEntry(
            tcr=tcr.astype(np.float32), ref_kf=self.ref_kf, ref_order=ref_order,
            timestamp=fr.timestamp, lost=lost))

    @graph_capture.entry()     # waits for the worker, takes the map lock
    def full_trajectory_twc(self, wait: bool = True) -> np.ndarray:
        """Recover all frame poses through their reference keyframes,
        chaining through culled keyframes via stored relative poses (one
        pose per frame, lost frames carried forward). For TUM export, which
        skips lost frames, pair with `trajectory_lost_mask`.

        Applies the frames in flight and waits for the mapping worker to
        drain first, and reads under the map lock; `wait=False` gives a
        snapshot without waiting."""
        if wait:
            self.flush_frames()
            if self.mapping_worker is not None:
                self.mapping_worker.wait_idle()
        with self.map_lock:
            return self._full_trajectory_twc_locked()

    def _full_trajectory_twc_locked(self) -> np.ndarray:
        out = []
        last = np.eye(4, dtype=np.float32)
        for e in self.trajectory:
            ref_pose = None
            if e.ref_kf >= 0:
                ref_pose = self.map.resolve_kf_pose(e.ref_kf, e.ref_order)
            if ref_pose is None:
                out.append(last)
                continue
            tcw = e.tcr @ ref_pose
            last = np.linalg.inv(tcw).astype(np.float32)
            out.append(last)
        return np.stack(out)

    def trajectory_lost_mask(self) -> np.ndarray:
        """[F] bool: frame was lost, after the frames in flight are applied.
        The TUM saver drops these rows."""
        self.flush_frames()
        return np.array([e.lost for e in self.trajectory], bool)
