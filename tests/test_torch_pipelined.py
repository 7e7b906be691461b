"""The pipelined and batched fetch of the port's tracker (the default
configuration) against the JAX package, on the CPU.

Sequences are rendered once with the JAX package's renderer (320x240, 800
features, 4 levels, tests/test_async.py's settings) and the identical arrays
go to both packages. What is compared, and with which tolerance:

- ``kernels._resolve_pred``: the same float32 product, within 1e-6.
- A pipelined drive with inline mapping (async_mapping=False, so the order of
  frames is deterministic): per-frame camera positions and returned poses
  within 1 cm, keyframe counts within 1, as tests/test_torch_system_api.py, with
  the port's repair of replaced points switched off (the JAX package has
  none); with it on, the drive is held to the limits of the JAX test on
  this sequence, tests/test_async.py::TestBatchedFetch: every frame
  tracked, ATE under 0.03 m.
- The twin of tests/test_async.py::TestBatchedFetch, once with fetch_batch 1
  and once with 4 (40 frames of the forward drive, seed 1, the mapping
  worker on): the same number of tracked frames in both packages, counted
  from ``trajectory_lost_mask()``, and the ATE under the floor of the JAX
  test's limit, 0.03 m, in both (that limit is ATE(K=4) < max(2 ATE(K=1),
  0.03); each drive is held to its floor, which is stricter).

Every JAX system here is built by ``torch_port_helpers.jax_system``, so the
drives after the first run the JAX frame programs the first one compiled;
they run one after another on a thread of their own, beside the port's
(``torch_port_helpers.beside``). The savers with frames in flight, a reset
with a batch in flight and the deliberate divergences from the JAX package
are tests/test_torch_pipeline_chain.py.
"""
import numpy as np
import pytest

from orbslam2_tpu.frontend import kernels as jkernels
from orbslam2_tpu.frontend import tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.system import Sensor as JSensor
from orbslam2_tpu_torch.frontend import kernels as tkernels
from orbslam2_tpu_torch.frontend import tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io.evaluate import ate_rmse
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import beside, jax_system, n, t, without_replacement_lookup

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_keyframes=64, max_points=8192, local_point_cap=2048,
              max_frames_between_kf=10, min_init_features=300)
N_FRAMES = 15
BATCHED_FRAMES = 40
ATE_MAX_M = 0.03


def _port(**kw):
    """The port's system with these settings (defaults else)."""
    return SLAMSystem(ttracking.SLAMConfig(
        cam=TCamera(**CAM_KW), orb=TORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        Sensor.RGBD, device="cpu")


def _jax(**kw):
    """The JAX package's system with the same settings."""
    return jax_system(jtracking.SLAMConfig(
        cam=JCamera(**CAM_KW), orb=JORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        JSensor.RGBD)


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
def forward40():
    seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=BATCHED_FRAMES, trajectory="forward",
                            seed=1)
    frames = [seq.render(i) for i in range(BATCHED_FRAMES)]
    return frames, np.stack([np.linalg.inv(p) for p in seq.poses]), seq.fps


@pytest.fixture(scope="module")
def drives(forward, forward40):
    """Every drive of this file: the JAX package's one after another on a
    thread of their own, beside the port's (torch_port_helpers.beside).

    ``inline``: a pipelined drive (fetch_batch 1) with mapping inline in
    both packages: the order of frames is the same. The port runs without
    its repair of replaced points, which the JAX package lacks (a fusion
    moves the returned poses of the frames after it by up to 1.7 cm); after
    it ``repaired`` drives the port with the repair.

    ``1`` and ``4``: TestBatchedFetch's drive over the same rendered frames
    in both packages, with that fetch_batch and the mapping worker on."""
    frames, gt = forward
    frames40, gt40, fps = forward40
    out = {"inline": {}, 1: {}, 4: {}}

    def inline_drive(name, system):
        ret = [system.track_rgbd(g, d, i / 30.0) for i, (g, d) in enumerate(frames)]
        out["inline"][name] = dict(ret=ret, est=system.tracker.full_trajectory_twc(),
                                   lost=system.tracker.trajectory_lost_mask(),
                                   kf=system.map.n_keyframes())

    def batched_drive(k, name, system):
        for i, (g, d) in enumerate(frames40):
            system.track_rgbd(g, d, i / fps)
        system.wait_mapping_idle()
        est = system.tracker.full_trajectory_twc()
        lost = system.tracker.trajectory_lost_mask()
        out[k][name] = dict(tracked=int((~lost).sum()), n=len(lost), ate=ate_rmse(est, gt40),
                            kf=system.map.n_keyframes())
        system.shutdown()

    def jax_drives():
        jsys = _jax(async_mapping=False)
        inline_drive("jax", jsys)
        jsys.shutdown()
        for k in (1, 4):
            batched_drive(k, "jax", _jax(fetch_batch=k, async_mapping=True))

    def port_drives():
        tsys = without_replacement_lookup(_port(async_mapping=False))
        rsys = _port(async_mapping=False)
        inline_drive("torch", tsys)
        inline_drive("repaired", rsys)
        out["inline"]["fused"] = tsys.tracker.stats
        out["inline"]["repaired"]["remapped"] = rsys.tracker.remapped_ids
        for system in (rsys, tsys):
            system.shutdown()
        for k in (1, 4):
            batched_drive(k, "torch", _port(fetch_batch=k, async_mapping=True))

    beside(jax_drives, port_drives)
    return out


@pytest.fixture(scope="module")
def inline(drives):
    return drives["inline"]


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


@pytest.fixture(scope="module", params=[1, 4])
def batched(request, drives):
    return drives[request.param]


def test_tracks_as_many_frames_as_jax(batched):
    j, p = batched["jax"], batched["torch"]
    assert p["n"] == j["n"] == BATCHED_FRAMES
    assert p["tracked"] == j["tracked"] == BATCHED_FRAMES
    assert p["kf"] >= 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_ate_within_the_jax_tests_limit(batched, pkg):
    assert batched[pkg]["ate"] < ATE_MAX_M, batched
