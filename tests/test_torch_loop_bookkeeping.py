"""The loop closer's bookkeeping in the port, on the CPU: a global BA's
result propagated as the JAX package propagates it, a superseded GBA
discarded, a failed GBA thread raised on the caller, a culled keyframe
skipping the loop stage, and the worker raising a failed loop-closing stage
(the loop correction and the slice as a whole are in
test_torch_loop_closing.py).
"""
import copy
import threading

import numpy as np
import pytest

from orbslam2_tpu.frontend import loop_closing as jlc
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.slammap import mapstate as jmapstate
from orbslam2_tpu_torch.frontend import loop_closing as lc
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.place.pretrained import get_default_vocabulary
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import j, n, t
from test_torch_loop_closing import TCAM, _closer, _grow, _line_map, _snap


def test_gba_result_propagates_like_jax():
    m = _line_map()
    jm = jmapstate.MapState(jmapstate.MapCapacity(8, 512, 64))
    for name in vars(jm):
        if name in vars(m) and name != "cap":
            setattr(jm, name, copy.deepcopy(getattr(m, name)))
    snaps = [_snap(m, 1), _snap(jm, 1)]
    grown = [_grow(m), _grow(jm)]
    assert grown[0] == grown[1]
    rng = np.random.default_rng(3)
    new_poses = m.kf_pose.copy()
    new_poses[:6] = n(jse3.exp(j((rng.normal(size=(6, 6)) * 0.02).astype(np.float32)))) \
        @ m.kf_pose[:6]
    new_points = m.pt_pos + rng.normal(size=m.pt_pos.shape).astype(np.float32) * 0.01
    closer = _closer(m)
    jcloser = jlc.LoopCloser.__new__(jlc.LoopCloser)
    jcloser.map = jm
    closer._apply_gba(snaps[0], new_poses, new_points)
    jcloser._apply_gba(snaps[1], new_poses, new_points)
    np.testing.assert_allclose(m.kf_pose, jm.kf_pose, atol=1e-5)
    np.testing.assert_allclose(m.pt_pos, jm.pt_pos, atol=1e-5)
    kf, pt = grown[0]
    assert not np.allclose(m.kf_pose[kf], np.eye(4))  # the fresh keyframe moved
    assert m.correction_gen == 1


def test_superseded_gba_is_discarded(monkeypatch):
    m = _line_map()
    closer = _closer(m)
    closer.full_ba_idx = 2                       # a newer loop landed meanwhile
    poses_before = m.kf_pose.copy()

    class FakeRes:
        poses = t(m.kf_pose + 7.0)
        points = t(m.pt_pos + 7.0)

    monkeypatch.setattr(lc.ba, "bundle_adjust_pcg", lambda *a, **k: FakeRes())
    closer._run_gba(dict(_snap(m, 1), pt_fixed=None))
    assert (closer.n_gba_superseded, closer.n_gba_applied) == (1, 0)
    np.testing.assert_array_equal(m.kf_pose, poses_before)


def test_failed_gba_thread_is_raised_on_the_caller(monkeypatch):
    m = _line_map()
    closer = _closer(m, async_gba=True)
    closer.cfg.run_global_ba = True
    started = threading.Event()

    def boom(*a, **k):
        started.set()
        raise ValueError("injected GBA failure")

    monkeypatch.setattr(lc.ba, "bundle_adjust_pcg", boom)
    closer.request_global_ba(fixed_kf=0)
    assert started.wait(30)
    with pytest.raises(RuntimeError, match="global BA") as info:
        closer.wait_gba(30)
    assert isinstance(info.value.__cause__, ValueError)
    with pytest.raises(RuntimeError):
        closer.process_keyframe(1, np.zeros(4, np.int32))


def test_a_culled_keyframe_skips_the_loop_stage():
    """A keyframe that local mapping culled before its loop stage stays out
    of the keyframe database (the JAX worker passes it to the loop closer,
    which adds it back); the next live keyframe goes through."""
    from orbslam2_tpu_torch.frontend.orchestrator import MappingWorker
    from orbslam2_tpu_torch.slammap.keyframe_db import KeyFrameDatabase
    from orbslam2_tpu_torch.utils.profiling import StageTimer

    m = _line_map()
    voc = get_default_vocabulary()
    kfdb = KeyFrameDatabase(voc, m.cap.max_keyframes)
    closer = lc.LoopCloser(m, TCAM, kfdb, lc.LoopCloserConfig(run_global_ba=False),
                           device="cpu")
    seen = []
    process = closer.process_keyframe
    closer.process_keyframe = lambda kf, wids: seen.append(kf) or process(kf, wids)

    class CullingMapper:
        stats = StageTimer(enabled=True)
        pending_fn = None

        def process_keyframe(self, kf, backlog):
            if kf == 4:                              # KeyFrameCulling
                m.kf_valid[kf] = False
                kfdb.erase(kf)

    worker = MappingWorker(CullingMapper(), closer, closer.map_lock)
    wids = np.random.default_rng(0).integers(0, voc.n_words, 64).astype(np.int32)
    worker.insert_keyframe(4, wids)
    worker.insert_keyframe(5, wids)
    assert worker.wait_idle(30)
    worker.stop()
    assert seen == [5]
    assert not kfdb.valid[4] and kfdb.valid[5]
    assert CullingMapper.stats.summary()["loop_closing"]["n"] == 2


def test_worker_raises_a_failed_loop_closing_stage():
    cfg = SLAMConfig(cam=TCAM, orb=ORBConfig(n_features=400, n_levels=4), th_depth=4.0,
                     max_keyframes=16, max_points=4096, local_point_cap=1024,
                     min_init_features=200, force_kf_every=2, pipelined_fetch=False)
    system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=get_default_vocabulary(), device="cpu")
    seen = []

    def boom(kf, wids):
        seen.append(kf)
        raise ValueError("injected loop-closing failure")

    system.loop_closer.process_keyframe = boom
    seq = SyntheticSequence(TCAM, n_frames=6, trajectory="lateral", seed=1)
    with pytest.raises(RuntimeError, match="mapping worker") as info:
        for i in range(6):
            system.track_rgbd(*seq.render(i), i / 30.0)
        system.wait_mapping_idle(60)
    assert isinstance(info.value.__cause__, ValueError)
    assert len(seen) == 1                        # nothing after the failure
    with pytest.raises(RuntimeError):
        system.shutdown()
