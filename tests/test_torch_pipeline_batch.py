"""The port's pipelined tracker with a batch of 4 frames in flight, on the
CPU, port only: the returned predictions step the velocity once for each
frame a frame is ahead (one of the deliberate divergences from the JAX
package, ROADMAP.md, held against its formula), the savers flush the frames
in flight, and a reset with a batch in flight keeps one trajectory entry
per frame (the chained batches and the fallbacks are in
test_torch_pipeline_chain.py).

Frames of tests/test_async.py's forward drive (320x240, 800 features, 4
levels, seed 1), mapping inline (async_mapping=False) so that the order of
frames is deterministic.
"""
import numpy as np
import pytest

from orbslam2_tpu_torch.io.trajectory import load_tum

from test_torch_pipeline_chain import _in_flight, _port, forward


@pytest.fixture(scope="module")
def batch4(forward, tmp_path_factory):
    """A port drive with fetch_batch 4 and mapping inline: the returned
    predictions against the truth and against the JAX package's formula,
    the savers with frames in flight, then a reset with a batch in flight."""
    frames, gt = forward
    system = _port(fetch_batch=4)
    tr = system.tracker
    out = dict(pred=[], saved=None)
    for i, (g, d) in enumerate(frames[:30]):
        ret = system.track_rgbd(g, d, i / 30.0)
        ahead = _in_flight(tr)
        if ahead:
            # the JAX package returns one velocity step on the last applied
            # frame, however far ahead this frame is
            jax_like = (tr.velocity @ tr.last_frame.tcw).astype(np.float32)
            out["pred"].append((i, i - tr.last_frame.frame_id, ret, jax_like))
        if out["saved"] is None and ahead == 7:
            out["saved"] = i + 1, len(tr.trajectory), ahead
            out["tum"] = str(tmp_path_factory.mktemp("savers") / "trajectory.txt")
            system.save_trajectory_tum(out["tum"])
            out["traj_after_save"] = len(tr.trajectory)
    out["gt"] = gt
    out["system"] = system
    return out


def test_savers_flush_the_frames_in_flight(batch4):
    assert batch4["saved"] is not None, "never 7 frames in flight"
    fed, before, ahead = batch4["saved"]
    assert before + ahead == fed and batch4["traj_after_save"] == fed
    ts, _ = load_tum(batch4["tum"])
    assert len(ts) == fed


def test_prediction_steps_the_velocity_once_per_frame_ahead(batch4):
    """Divergence from the JAX package: a frame 2 or more frames ahead of the
    last applied one gets the velocity composed that many times."""
    gt = batch4["gt"]
    far = [(i, ret, jx) for i, ahead, ret, jx in batch4["pred"] if ahead >= 2]
    assert len(far) >= 5

    def err(i, tcw):
        return np.linalg.norm(np.linalg.inv(tcw)[:3, 3] - gt[i][:3, 3])

    ours = np.mean([err(i, ret) for i, ret, _ in far])
    theirs = np.mean([err(i, jx) for i, _, jx in far])
    assert ours < 0.5 * theirs, (ours, theirs)
    # one frame ahead: the same pose as the JAX package's formula
    near = [(ret, jx) for _, ahead, ret, jx in batch4["pred"] if ahead == 1]
    for ret, jx in near:
        np.testing.assert_allclose(ret, jx, atol=1e-5)


def test_reset_with_a_batch_in_flight_keeps_one_entry_per_frame(batch4, forward):
    frames, _ = forward
    system = batch4["system"]
    tr = system.tracker
    fed = 30
    for i in range(30, 40):
        system.track_rgbd(*frames[i], i / 30.0)
        fed += 1
        if _in_flight(tr) >= 2:
            break
    ahead = _in_flight(tr)
    assert ahead >= 2
    with tr.map_lock:   # as an auto-reset fired by an apply would
        tr.reset()
    assert _in_flight(tr) == 0
    for i in range(fed, 40):
        system.track_rgbd(*frames[i], i / 30.0)
    stamps = [e.timestamp for e in tr.trajectory]
    lost = tr.trajectory_lost_mask()
    assert len(lost) == 40 and len(set(stamps)) == 40
    assert lost[fed - ahead:fed].all()        # the discarded frames
    system.shutdown()
