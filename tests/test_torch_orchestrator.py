"""The port's mapping worker: the queue and idle protocol on a stand-in
mapper, and one short RGB-D drive of SLAMSystem with the worker on
(async_mapping, the default), on the CPU. Also the tracker's side of the
concurrency: a fused frame whose map changed while its device step ran.

The worker keeps a failing stage's exception and raises it on the caller's
thread (wait_mapping_idle, the next keyframe hand-off, shutdown): the JAX
package's worker prints it and goes on, which would leave the tracker on a
map no longer refined.
"""
import threading

import numpy as np
import pytest

from orbslam2_tpu_torch.frontend import kernels
from orbslam2_tpu_torch.frontend.orchestrator import MappingWorker
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io.evaluate import ate_rmse
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)


class StandInMapper:
    def __init__(self, fail_on=None):
        self.done, self.backlogs = [], []
        self.fail_on = fail_on
        self.release = threading.Event()
        self.release.set()
        self.started = threading.Event()
        self.pending_fn = None

    def process_keyframe(self, kf, backlog=False):
        self.started.set()
        self.release.wait(10)
        if kf == self.fail_on:
            raise ValueError(f"stage failed on keyframe {kf}")
        self.done.append(kf)
        self.backlogs.append(backlog)


def test_queue_order_idle_and_backlog():
    mapper = StandInMapper()
    mapper.release.clear()
    worker = MappingWorker(mapper)
    for kf in (3, 1, 2):
        worker.insert_keyframe(kf)
    assert not worker.idle() and mapper.pending_fn()
    assert worker.accept_keyframes() == (worker.queue_size() < 3)
    mapper.release.set()
    assert worker.wait_idle(10) and worker.idle()
    assert mapper.done == [3, 1, 2] and mapper.backlogs[-1] is False
    assert not mapper.pending_fn()
    worker.stop()
    worker.stop()                       # idempotent
    assert not worker._thread.is_alive()


def test_accept_keyframes_caps_the_queue_at_three():
    """The tracker stops handing keyframes over while three wait behind the
    one being mapped; wait_idle times out, and reports it, while they do."""
    mapper = StandInMapper()
    mapper.release.clear()
    worker = MappingWorker(mapper)
    worker.insert_keyframe(0)
    assert mapper.started.wait(10), "the worker did not take keyframe 0"
    for kf in (1, 2):
        worker.insert_keyframe(kf)
        assert worker.accept_keyframes()
    worker.insert_keyframe(3)
    assert not worker.accept_keyframes() and worker.queue_size() == 3
    assert not worker.wait_idle(0.05)
    mapper.release.set()
    assert worker.wait_idle(10) and mapper.done == [0, 1, 2, 3]
    assert mapper.backlogs[1:] == [True, True, False]
    worker.stop()


def test_a_failing_stage_is_raised_on_the_callers_thread():
    mapper = StandInMapper(fail_on=2)
    worker = MappingWorker(mapper)
    for kf in (1, 2, 3):
        worker.insert_keyframe(kf)
    with pytest.raises(RuntimeError, match="mapping worker failed") as info:
        worker.wait_idle(10)
    assert isinstance(info.value.__cause__, ValueError)
    assert mapper.done == [1]           # nothing mapped after the failure
    with pytest.raises(RuntimeError):
        worker.insert_keyframe(4)
    with pytest.raises(RuntimeError):
        worker.stop()
    assert not worker._thread.is_alive()


def test_rgbd_drive_with_the_worker():
    cam = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240,
                        bf=26.0)
    cfg = SLAMConfig(cam=cam, orb=ORBConfig(n_features=800, n_levels=4), th_depth=4.0,
                     max_keyframes=16, max_points=4096, local_point_cap=2048,
                     min_init_features=300, force_kf_every=2, pipelined_fetch=False)
    assert cfg.async_mapping
    system = SLAMSystem(cfg, Sensor.RGBD, device="cpu")
    assert system.mapping_worker is not None
    assert system.local_mapper.map_lock is system.tracker.map_lock
    seq = SyntheticSequence(cam, n_frames=8, trajectory="lateral", seed=1)
    for i in range(8):
        gray, depth = seq.render(i)
        assert system.track_rgbd(gray, depth, i / 30.0) is not None
    assert system.wait_mapping_idle(60)
    assert not system.tracker.trajectory_lost_mask().any()
    assert system.map.n_keyframes() >= 3
    counts = system.local_mapper.counts
    assert counts["points_created"] + counts["obs_fused"] + counts["points_merged"] > 0
    est = system.tracker.full_trajectory_twc()
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    assert ate_rmse(est, gt) < 0.05

    # a mapping stage that fails on the worker fails the caller
    def boom(kf, backlog=False):
        raise ValueError("stage failed")
    system.local_mapper.process_keyframe = boom
    system.mapping_worker.insert_keyframe(int(system.map.keyframe_ids()[-1]))
    with pytest.raises(RuntimeError, match="mapping worker failed"):
        system.wait_mapping_idle(60)
    worker = system.mapping_worker
    with pytest.raises(RuntimeError):
        system.shutdown()
    system.shutdown()                   # idempotent: the worker is gone
    assert system.mapping_worker is None and not worker._thread.is_alive()


def _small_system(**kw):
    cam = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240,
                        bf=26.0)
    cfg = SLAMConfig(cam=cam, orb=ORBConfig(n_features=800, n_levels=4), th_depth=4.0,
                     max_keyframes=16, max_points=4096, local_point_cap=2048,
                     min_init_features=300, pipelined_fetch=False, **kw)
    seq = SyntheticSequence(cam, n_frames=6, trajectory="lateral", seed=1)
    return SLAMSystem(cfg, Sensor.RGBD, device="cpu"), seq


@pytest.mark.parametrize("change", ["correction", "erased_points"])
def test_fused_frame_revalidates_a_map_changed_mid_flight(change, monkeypatch):
    """A pose correction during a fused frame's device step makes the frame
    run again against the corrected map; points erased during it are dropped
    from the frame's associations and from the device carry."""
    system, seq = _small_system(async_mapping=False)
    for i in range(4):
        assert system.track_rgbd(*seq.render(i), i / 30.0) is not None
    tracker, m = system.tracker, system.map
    # the next frame takes the fused path, and its motion-model search holds
    # (frames 2, 3 and 5 of this sequence fall back to the classic path)
    assert tracker.state.name == "OK" and tracker._local_ids is not None
    step = kernels.fused_frame_step
    calls, erased = [], []

    def step_while_the_map_changes(*args, **kw):
        out = step(*args, **kw)
        calls.append(1)
        if len(calls) == 1:
            with tracker.map_lock:
                if change == "correction":
                    m.correction_gen += 1
                else:
                    ids = out.pt_ids[out.pt_ids >= 0][:20].numpy()
                    erased.extend(ids.tolist())
                    m.erase_points(ids)
        return out

    monkeypatch.setattr(kernels, "fused_frame_step", step_while_the_map_changes)
    assert system.track_rgbd(*seq.render(4), 4 / 30.0) is not None
    lf = tracker.last_frame
    if change == "correction":
        assert len(calls) == 2 and tracker.revalidated_frames == 0
    else:
        assert len(calls) == 1 and len(erased) == 20
        assert not np.isin(lf.pt_ids, erased).any()
        assert tracker._last_pid_dev is None          # the carry held them too
        assert tracker.revalidated_frames == 1
    assert (lf.pt_ids[lf.pt_ids >= 0] < m.cap.max_points).all()
    assert m.pt_valid[lf.pt_ids[lf.pt_ids >= 0]].all()
