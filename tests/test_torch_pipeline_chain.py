"""The port's pipelined tracker with frames in flight, on the CPU, port only:
two of the three deliberate divergences from the JAX package (ROADMAP.md):
the batch chained off a batch that broke is tracked again; a frame that
failed after chaining across a keyframe is dispatched again, only after the
reference-keyframe fallback, as in the JAX package, failed too. Each
divergence is held against what the JAX package does (the same code with
the divergence taken out). The third, the pose returned for a frame in
flight, and the savers and a reset with a batch in flight are in
test_torch_pipeline_batch.py.

Frames of tests/test_async.py's forward drive (320x240, 800 features, 4
levels, seed 1), mapping inline (async_mapping=False) so that the order of
frames is deterministic. A failure is simulated by monkeypatching (stale ids
found on apply; an inlier count of 0), so every assertion is exact.
"""
import numpy as np
import pytest

from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.frontend import tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_keyframes=64, max_points=8192, local_point_cap=2048,
              max_frames_between_kf=10, min_init_features=300, async_mapping=False)


def _port(**kw):
    return SLAMSystem(ttracking.SLAMConfig(
        cam=TCamera(**CAM_KW), orb=TORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        Sensor.RGBD, device="cpu")


def _in_flight(tracker) -> int:
    return len(tracker._pending) + (len(tracker._inflight[0]) if tracker._inflight else 0)


@pytest.fixture(scope="module")
def forward():
    seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=40, trajectory="forward", seed=1)
    frames = [seq.render(i) for i in range(40)]
    return frames, np.stack([np.linalg.inv(p) for p in seq.poses])


def test_a_broken_batch_makes_the_chained_batch_track_again(forward, monkeypatch):
    """Divergence from the JAX package (its chain validation): a frame whose
    apply found stale ids breaks the chain; the rest of its batch is tracked
    again, and so is every frame of the batch chained off it, although
    tracking the rest again cleared the stale-carry flag."""
    frames, _ = forward
    system = _port(fetch_batch=4)
    tr = system.tracker
    apply = ttracking.Tracker._fused_apply
    finish = ttracking.Tracker._finish_batch
    retrack = ttracking.Tracker._retrack_sync
    seen = dict(target=None, retracked=[], chained=None)

    def finish_batch(self, entry):
        batch = entry[0]
        if seen["target"] is None and batch[0]["frame_id"] >= 6:
            seen["target"] = batch[0]["frame_id"]
            seen["chained"] = [r["frame_id"] for r in self._pending_chained]
        return finish(self, entry)

    def fused_apply(self, rec, fetched):
        ret = apply(self, rec, fetched)
        if rec["frame_id"] == seen["target"]:
            self._carry_wrong = True      # as when stale ids were dropped
        return ret

    def retrack_sync(self, rec):
        seen["retracked"].append(rec["frame_id"])
        return retrack(self, rec)

    # the batch submitted just before the one that breaks is applied: the
    # frames chained off the breaking batch
    submit = ttracking.Tracker._submit_batch_fetch

    def submit_batch(self, batch):
        self._pending_chained = batch
        return submit(self, batch)

    monkeypatch.setattr(ttracking.Tracker, "_finish_batch", finish_batch)
    monkeypatch.setattr(ttracking.Tracker, "_fused_apply", fused_apply)
    monkeypatch.setattr(ttracking.Tracker, "_retrack_sync", retrack_sync)
    monkeypatch.setattr(ttracking.Tracker, "_submit_batch_fetch", submit_batch)
    for i, (g, d) in enumerate(frames[:15]):
        system.track_rgbd(g, d, i / 30.0)
    lost = tr.trajectory_lost_mask()
    system.shutdown()
    target = seen["target"]
    assert target is not None
    rest = [target + 1, target + 2, target + 3]
    assert set(rest) <= set(seen["retracked"]), seen
    assert set(seen["chained"]) <= set(seen["retracked"]), seen
    assert len(lost) == 15 and not lost.any()


@pytest.mark.parametrize("rescue", [True, False])
def test_a_frame_that_missed_a_keyframe_is_tracked_again(forward, monkeypatch, rescue):
    """Divergence from the JAX package: a pipelined frame dispatched before
    the keyframe its predecessor created, which then fails (made to fail
    here: its inlier count is reported as 0), is dispatched again against the
    map with the keyframe's points instead of being lost. Without the rescue
    (the JAX package's behaviour) it is lost, and the young map is reset."""
    frames, _ = forward
    system = _port(force_kf_every=4)
    tr = system.tracker
    create = ttracking.Tracker._create_new_keyframe
    unpack = ttracking.Tracker._unpack
    state = dict(armed=False, failed=None)

    def create_keyframe(self, fr):
        create(self, fr)
        if fr.frame_id >= 6 and state["failed"] is None:
            state["armed"] = True

    def unpack_failing(out, ints, floats):
        got = unpack(out, ints, floats)
        if state["armed"]:
            state["armed"] = False
            state["failed"] = True
            got = got[:6] + (0,) + got[7:]      # n_inliers
        return got

    monkeypatch.setattr(ttracking.Tracker, "_create_new_keyframe", create_keyframe)
    monkeypatch.setattr(ttracking.Tracker, "_unpack", staticmethod(unpack_failing))
    if not rescue:
        monkeypatch.setattr(ttracking.Tracker, "_missed_keyframe", lambda *a: False)
    for i, (g, d) in enumerate(frames[:12]):
        system.track_rgbd(g, d, i / 30.0)
    lost = tr.trajectory_lost_mask()
    retracked, n_kf = tr.retracked_frames, system.map.n_keyframes()
    system.shutdown()
    assert state["failed"] and len(lost) == 12
    if rescue:
        assert not lost.any() and retracked >= 1 and n_kf >= 3
    else:
        # lost, and the map was reset (the frames after it, with under 300
        # keypoints, do not initialise a new map)
        assert lost.any() and n_kf < 3


@pytest.mark.parametrize("fallback_ok", [True, False])
def test_a_motion_model_failure_tries_the_reference_fallback_first(forward, monkeypatch,
                                                                   fallback_ok):
    """The JAX package's order is kept wherever it succeeds: a pipelined
    frame dispatched before its predecessor's keyframe whose motion model
    fails (made to fail here: its motion-model match count is reported as 0)
    first takes the reference-keyframe fallback, as in the JAX package, and
    stands if that succeeds. Only when the fallback fails too (made to fail)
    is the frame dispatched again against the map with the keyframe."""
    frames, _ = forward
    system = _port(force_kf_every=4)
    tr = system.tracker
    create = ttracking.Tracker._create_new_keyframe
    unpack = ttracking.Tracker._unpack
    reference = ttracking.Tracker._track_reference_keyframe
    dispatch = ttracking.Tracker._fused_dispatch
    state = dict(armed=False, failed=None, fallback=[], again=[])

    def create_keyframe(self, fr):
        create(self, fr)
        if fr.frame_id >= 6 and state["failed"] is None:
            state["armed"] = True

    def unpack_failing(out, ints, floats):
        got = unpack(out, ints, floats)
        if state["armed"]:
            state["armed"] = False
            state["failed"] = True
            got = got[:4] + (0,) + got[5:]      # mm_matches
        return got

    def reference_keyframe(self, fr):
        ok = reference(self, fr)
        if not state["failed"]:
            return ok       # the classic path before the failure
        state["fallback"].append(fr.frame_id)
        return ok and (fallback_ok or len(state["fallback"]) > 1)

    def fused_dispatch(self, kind, imgs_d, timestamp, frame_id=None, chain_off_pipe=True):
        if frame_id is not None:
            state["again"].append(frame_id)
        return dispatch(self, kind, imgs_d, timestamp, frame_id=frame_id,
                        chain_off_pipe=chain_off_pipe)

    monkeypatch.setattr(ttracking.Tracker, "_create_new_keyframe", create_keyframe)
    monkeypatch.setattr(ttracking.Tracker, "_unpack", staticmethod(unpack_failing))
    monkeypatch.setattr(ttracking.Tracker, "_track_reference_keyframe", reference_keyframe)
    monkeypatch.setattr(ttracking.Tracker, "_fused_dispatch", fused_dispatch)
    for i, (g, d) in enumerate(frames[:12]):
        system.track_rgbd(g, d, i / 30.0)
    lost = tr.trajectory_lost_mask()
    system.shutdown()
    assert state["failed"] and len(lost) == 12 and not lost.any()
    target = state["fallback"][0]
    assert state["fallback"].count(target) == 1
    if fallback_ok:
        assert target not in state["again"], state
    else:
        assert target in state["again"], state
