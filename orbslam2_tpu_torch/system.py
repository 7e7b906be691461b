"""System facade: the public entry point of the port.

Counterpart of ``orbslam2_tpu/system.py`` (the reference's
ORB_SLAM2::System): constructs the map, the tracker and the local mapper
and, with a vocabulary, the keyframe database and the loop closer; starts
the mapping worker (``async_mapping``, the default) and exposes the track
call of each sensor, reset, shutdown, map save/load and the trajectory
savers.

Every keyframe is mapped (triangulation, fusion, local BA, culling) and,
with a vocabulary, goes through loop detection and correction, on the
worker's thread or inline at insertion; a lost tracker relocalizes through
the keyframe database. The three sensors are ported: RGB-D (``track_rgbd``),
stereo (``track_stereo``, rectified pairs) and monocular
(``track_monocular``: a two-view initialization, a local mapper with the
monocular branches, each keyframe mapped inline at insertion unless
``mono_async_mapping``), with every ``SLAMConfig`` field (the pipelined and
batched fetch among them). The loop closer solves with fixed scale for
stereo and RGB-D and with scale (Sim3) for monocular. Localization mode
(``activate_localization_mode``: track against a frozen map, on temporal
visual-odometry points where the map ends), a global bundle adjustment on
request and a change of calibration are there too.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from orbslam2_tpu_torch.frontend.local_mapping import LocalMapper, LocalMapperConfig
from orbslam2_tpu_torch.frontend.loop_closing import LoopCloser, LoopCloserConfig
from orbslam2_tpu_torch.frontend.orchestrator import MappingWorker
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker, TrackingState
from orbslam2_tpu_torch.io import trajectory as traj_io
from orbslam2_tpu_torch.ops.orb import ORBExtractor
from orbslam2_tpu_torch.slammap.keyframe_db import KeyFrameDatabase
from orbslam2_tpu_torch.slammap.mapstate import MapState


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class SLAMSystem:
    def __init__(self, config: SLAMConfig, sensor: Sensor, vocabulary=None,
                 device="cuda"):
        """`device`: where the per-frame work, the mapping and the loop
        closing run; "cuda" unless the caller asks for "cpu". `vocabulary`:
        a place.vocabulary.Vocabulary (e.g. place.pretrained's), or None to
        run without place recognition (no loop closing; relocalization then
        tries the reference keyframe only)."""
        self.cfg = config
        self.sensor = sensor
        mono = sensor == Sensor.MONOCULAR
        # the tracker owns the map and the map lock, which the local mapper
        # shares
        self.tracker = Tracker(config, device=device)
        self.map = self.tracker.map
        self.device = self.tracker.device
        self.local_mapper = LocalMapper(
            self.map, config.cam,
            LocalMapperConfig(scale_factor=config.orb.scale_factor,
                              n_levels=config.orb.n_levels, monocular=mono),
            device=self.device)
        self.local_mapper.stats.enabled = config.profile_stages
        self.local_mapper.map_lock = self.tracker.map_lock
        self.tracker.local_mapper = self.local_mapper
        self.vocabulary = vocabulary
        self.kfdb = None
        self.loop_closer = None
        if vocabulary is not None:
            self.kfdb = KeyFrameDatabase(vocabulary, config.max_keyframes)
            self.loop_closer = LoopCloser(
                self.map, config.cam, self.kfdb,
                LoopCloserConfig(scale_factor=config.orb.scale_factor,
                                 n_levels=config.orb.n_levels,
                                 fix_scale=not mono,
                                 async_gba=config.async_mapping),
                device=self.device)
            self.loop_closer.stats.enabled = config.profile_stages
            # one map lock shared by tracker, mapper and the GBA thread
            self.loop_closer.map_lock = self.tracker.map_lock
            self.local_mapper.kfdb = self.kfdb
        self.tracker.vocabulary = vocabulary
        self.tracker.kfdb = self.kfdb
        self.tracker.loop_closer = self.loop_closer
        self.mapping_worker = None
        if config.async_mapping:
            self.mapping_worker = MappingWorker(
                self.local_mapper, self.loop_closer, self.tracker.map_lock,
                sync_mapping=mono and not config.mono_async_mapping)
            self.tracker.mapping_worker = self.mapping_worker

    # ------------------------------------------------------------------
    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float
                   ) -> Optional[np.ndarray]:
        """-> Tcw or None if tracking failed (System::TrackRGBD)."""
        if self.sensor != Sensor.RGBD:
            raise ValueError(f"track_rgbd on a {self.sensor.name} system")
        return self.tracker.track_rgbd(gray, depth, timestamp)

    def track_monocular(self, gray: np.ndarray, timestamp: float
                        ) -> Optional[np.ndarray]:
        """-> Tcw or None if tracking failed (System::TrackMonocular). The
        map's scale is the first two views' median depth."""
        if self.sensor != Sensor.MONOCULAR:
            raise ValueError(f"track_monocular on a {self.sensor.name} system")
        return self.tracker.track_mono(gray, timestamp)

    def track_stereo(self, left: np.ndarray, right: np.ndarray, timestamp: float
                     ) -> Optional[np.ndarray]:
        """Rectified pair -> Tcw or None if tracking failed
        (System::TrackStereo)."""
        if self.sensor != Sensor.STEREO:
            raise ValueError(f"track_stereo on a {self.sensor.name} system")
        return self.tracker.track_stereo(left, right, timestamp)

    # ------------------------------------------------------------------
    def activate_localization_mode(self) -> None:
        """System::ActivateLocalizationMode: apply the frames in flight, let
        mapping finish what is queued, then track only: no keyframe, no map
        change."""
        self.tracker.flush_frames()
        self.wait_mapping_idle()
        self.cfg.localization_only = True
        self.tracker.cfg.localization_only = True

    def deactivate_localization_mode(self) -> None:
        """System::DeactivateLocalizationMode: map again."""
        self.tracker.flush_frames()
        self.cfg.localization_only = False
        self.tracker.cfg.localization_only = False

    def reset(self) -> None:
        """System::Reset."""
        self.tracker.flush_frames()
        self.wait_mapping_idle()
        with self.tracker.map_lock:
            self.tracker.reset()

    def shutdown(self) -> None:
        """System::Shutdown: apply the frames in flight, map what is queued,
        join the mapping worker, then wait for a global BA in flight.
        Idempotent; raises the worker's first exception once, and a failed
        GBA's."""
        self.tracker.flush_frames()
        worker, self.mapping_worker = self.mapping_worker, None
        if worker is not None:
            self.tracker.mapping_worker = None
            worker.stop()
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()

    def wait_mapping_idle(self, timeout: float = 60.0) -> bool:
        """Block until background mapping and a global BA in flight have
        drained (before reading the trajectory or saving the map). -> False
        on timeout; raises the exception of a failed mapping stage or GBA."""
        ok = True
        if self.mapping_worker is not None:
            ok = self.mapping_worker.wait_idle(timeout)
        if self.loop_closer is not None:
            ok = self.loop_closer.wait_gba(timeout) and ok
        return ok

    # ------------------------------------------------------------------
    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def map_changed(self) -> int:
        return self.map.change_index

    def get_tracked_points(self) -> np.ndarray:
        lf = self.tracker.last_frame
        if lf is None:
            return np.zeros(0, np.int32)
        return lf.pt_ids[lf.pt_ids >= 0]

    def get_tracked_keypoints(self):
        """Undistorted keypoints of the last frame.
        -> (xy [N,2], tracked mask [N])."""
        lf = self.tracker.last_frame
        if lf is None:
            return np.zeros((0, 2), np.float32), np.zeros(0, bool)
        return lf.kp.xy.cpu().numpy(), (lf.pt_ids >= 0) & ~lf.is_outlier

    def global_bundle_adjust(self, iters: int = 10) -> None:
        """Full-map bundle adjustment (the reference's
        GlobalBundleAdjustemnt): the loop closer's global BA (Schur-complement
        PCG, staged in float64) over every valid observation, with the first
        keyframe fixed, solved on this thread. Applies the frames in flight
        and waits for mapping and a global BA in flight first, so that no
        thread is joined under the map lock. Needs no vocabulary. `iters` is
        the JAX package's argument, which its solve does not read either:
        the solve runs the loop closer's fixed LM phases."""
        self.tracker.flush_frames()
        self.wait_mapping_idle()
        gba = LoopCloser(self.map, self.cfg.cam, None,
                         LoopCloserConfig(scale_factor=self.cfg.orb.scale_factor,
                                          n_levels=self.cfg.orb.n_levels,
                                          async_gba=False),
                         device=self.device)
        gba.stats.enabled = self.cfg.profile_stages
        with self.tracker.map_lock:
            ids = self.map.keyframe_ids()
            if len(ids) < 2:
                return
            gba.map_lock = self.tracker.map_lock
            gba.request_global_ba(fixed_kf=int(ids[0]))
            self.map.change_index += 1

    def change_calibration(self, cam) -> None:
        """Tracking::ChangeCalibration: new intrinsics from the next frame,
        for the tracker, the local mapper and the loop closer. A new image
        size builds a new extractor (its pyramid and budgets follow the
        size); the stereo matcher and every kernel read the camera per
        call, and the map's device mirror holds no camera."""
        self.tracker.flush_frames()
        old = self.cfg.cam
        with self.tracker.map_lock:
            self.cfg.cam = cam
            self.tracker.cfg.cam = cam
            self.tracker.cam = cam
            self.local_mapper.cam = cam
            if self.loop_closer is not None:
                self.loop_closer.cam = cam
            if (cam.height, cam.width) != (old.height, old.width):
                self.tracker.extractor = ORBExtractor(
                    self.cfg.orb, (cam.height, cam.width), self.device)

    def save_map(self, path: str) -> None:
        """Persist the full map as one compressed npz."""
        self.tracker.flush_frames()
        self.wait_mapping_idle()
        with self.tracker.map_lock:
            self.map.save(path)

    def load_map(self, path: str) -> None:
        """Load a saved map; the tracker then relocalizes against it."""
        loaded = MapState.load(path)
        self.tracker.flush_frames()
        self.wait_mapping_idle()
        with self.tracker.map_lock:
            # copy arrays into the existing shared MapState instance
            self.map.__dict__.update(loaded.__dict__)
            if self.kfdb is not None:
                self.kfdb.__init__(self.vocabulary, self.cfg.max_keyframes)
                for kf in self.map.keyframe_ids():
                    self.kfdb.add(int(kf), self.vocabulary.transform_packed(
                        torch.from_numpy(self.map.kf_kp_desc[kf].view(np.int32)).to(self.device),
                        torch.from_numpy(self.map.kf_kp_valid[kf]).to(self.device)
                    ).cpu().numpy())
        self.tracker.state = TrackingState.LOST if self.map.n_keyframes() \
            else TrackingState.NO_IMAGES_YET

    def save_trajectory_tum(self, path: str) -> None:
        """Lost frames are skipped, matching the reference saver."""
        twc = self.tracker.full_trajectory_twc()
        ts = np.array([e.timestamp for e in self.tracker.trajectory])
        keep = ~self.tracker.trajectory_lost_mask()
        traj_io.save_tum(path, ts[keep], twc[keep])

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        ids = self.map.keyframe_ids()
        twc = np.stack([np.linalg.inv(self.map.kf_pose[k]) for k in ids]) \
            if len(ids) else np.zeros((0, 4, 4), np.float32)
        ts = self.map.kf_timestamp[ids]
        traj_io.save_tum(path, ts, twc)

    def save_trajectory_kitti(self, path: str) -> None:
        twc = self.tracker.full_trajectory_twc()
        traj_io.save_kitti(path, twc)
