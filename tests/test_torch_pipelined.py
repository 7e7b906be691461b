"""The pipelined and batched fetch of the port's tracker (the default
configuration) against the JAX package, on the CPU.

Sequences are rendered once with the JAX package's renderer (320x240, 800
features, 4 levels, tests/test_async.py's settings) and the identical arrays
go to both packages. What is compared, and with which tolerance:

- ``kernels._resolve_pred``: the same float32 product, within 1e-6.
- A pipelined drive with inline mapping (async_mapping=False, so the order of
  frames is deterministic): per-frame camera positions and returned poses
  within 1 cm, keyframe counts within 1, as tests/test_torch_slice.py, with
  the port's repair of replaced points switched off (the JAX package has
  none); with it on, the drive is held to the limits of the JAX test on
  this sequence, tests/test_async.py::TestBatchedFetch: every frame
  tracked, ATE under 0.03 m.
The twins of tests/test_async.py::TestBatchedFetch are
tests/test_torch_batched_fetch.py (fetch_batch 1) and
tests/test_torch_batched_fetch_k4.py (fetch_batch 4); the savers with frames
in flight, a reset with a batch in flight and the deliberate divergences
from the JAX package are tests/test_torch_pipeline_chain.py.
"""
import numpy as np
import pytest

from orbslam2_tpu.frontend import kernels as jkernels
from orbslam2_tpu.frontend import tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu_torch.frontend import kernels as tkernels
from orbslam2_tpu_torch.frontend import tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io.evaluate import ate_rmse
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import beside, n, t, without_replacement_lookup

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_keyframes=64, max_points=8192, local_point_cap=2048,
              max_frames_between_kf=10, min_init_features=300)
N_FRAMES = 15


def _port(**kw):
    """The port's system with these settings (defaults else)."""
    return SLAMSystem(ttracking.SLAMConfig(
        cam=TCamera(**CAM_KW), orb=TORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        Sensor.RGBD, device="cpu")


def _systems(**kw):
    """One system of each package with the same settings (defaults else)."""
    jsys = JSystem(jtracking.SLAMConfig(
        cam=JCamera(**CAM_KW), orb=JORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        JSensor.RGBD)
    return jsys, _port(**kw)


@pytest.fixture(scope="module")
def forward():
    seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=N_FRAMES, trajectory="forward", seed=1)
    frames = [seq.render(i) for i in range(N_FRAMES)]
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    return frames, gt


def test_resolve_pred_matches_jax():
    rng = np.random.default_rng(5)
    vel = np.eye(4, dtype=np.float32)
    vel[:3, :4] += rng.normal(0, 0.01, (3, 4)).astype(np.float32)
    prev = np.eye(4, dtype=np.float32)
    prev[:3, 3] = rng.normal(0, 1, 3)
    want = n(jkernels._resolve_pred((vel, prev)))
    got = n(tkernels._resolve_pred((t(vel), t(prev))))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(n(tkernels._resolve_pred(t(prev))), prev)


@pytest.fixture(scope="module")
def inline(forward):
    """A pipelined drive (fetch_batch 1) with mapping inline in both
    packages: the order of frames is the same. The port runs without its
    repair of replaced points, which the JAX package lacks (a fusion moves
    the returned poses of the frames after it by up to 1.7 cm); after it,
    still beside the JAX drive, ``repaired`` drives the port with the
    repair."""
    frames, gt = forward
    jsys, tsys = _systems(async_mapping=False)
    without_replacement_lookup(tsys)
    rsys = _port(async_mapping=False)
    out = {}

    def drive(name, system):
        ret = [system.track_rgbd(g, d, i / 30.0) for i, (g, d) in enumerate(frames)]
        out[name] = dict(ret=ret, est=system.tracker.full_trajectory_twc(),
                         lost=system.tracker.trajectory_lost_mask(),
                         kf=system.map.n_keyframes())

    beside(lambda: drive("jax", jsys),
           lambda: (drive("torch", tsys), drive("repaired", rsys)))
    out["fused"] = tsys.tracker.stats
    out["repaired"]["remapped"] = rsys.tracker.remapped_ids
    for system in (rsys, tsys, jsys):
        system.shutdown()
    return out


def test_pipelined_drive_matches_jax_frame_by_frame(inline):
    j, p = inline["jax"], inline["torch"]
    assert not j["lost"].any() and not p["lost"].any()
    assert abs(p["kf"] - j["kf"]) <= 1
    gap = np.linalg.norm(p["est"][:, :3, 3] - j["est"][:, :3, 3], axis=1)
    assert gap.max() < 0.01, gap
    # the returned poses: solved on the classic frames, predicted on the
    # pipelined ones, in both packages
    for a, b in zip(p["ret"], j["ret"]):
        assert a is not None and b is not None
        assert np.abs(a - b).max() < 0.01


def test_pipelined_drive_with_the_repair_keeps_the_jax_tests_limits(inline, forward):
    """The same drive with the port's repair of replaced points: the
    fusions merge points the last frame tracked, which are remapped."""
    r = inline["repaired"]
    assert not r["lost"].any() and r["kf"] >= 2
    assert r["remapped"] > 0
    assert ate_rmse(r["est"], forward[1]) < 0.03
