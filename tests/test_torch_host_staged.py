"""The host-staged local map (``device_local_map=False``) of the port's
tracker against its device-resident one and against the JAX package's
host-staged branch, on the CPU.

The sequence (320x240, 800 features, 4 levels) is rendered once with the
JAX package's renderer and the identical arrays go to every drive. The
classic two-step path (``fused_frame=False``) takes the local-map stage
every frame; the fetch is synchronous and mapping inline, so the drives
are deterministic.

Tolerances, and why: the host-staged and the device-resident local map run
the same search on the same candidates, and the JAX package's host-staged
branch the same arithmetic up to float32 noise in a pose, which moves a
handful of associations at window and chi-square edges
(tests/test_torch_slice.py): per-frame camera positions agree within 1 cm,
keyframe counts within 1, and the ATE is under 0.05 m.
"""
import numpy as np
import pytest

from orbslam2_tpu.frontend import tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu_torch.frontend import tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io.evaluate import ate_rmse
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import beside

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_keyframes=32, max_points=8192, local_point_cap=2048,
              min_init_features=300)


def _jax(**kw):
    return JSystem(jtracking.SLAMConfig(
        cam=JCamera(**CAM_KW), orb=JORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        JSensor.RGBD)


def _port(**kw):
    return SLAMSystem(ttracking.SLAMConfig(
        cam=TCamera(**CAM_KW), orb=TORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        Sensor.RGBD, device="cpu")


@pytest.fixture(scope="module")
def host_staged():
    """10 frames of the lateral drive (seed 1) with the host-staged local map
    in both packages and with the device-resident one in the port; the
    classic two-step path (fused_frame=False) takes the local-map stage every
    frame, synchronous fetch, mapping inline."""
    seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=10, trajectory="lateral", seed=1)
    frames = [seq.render(i) for i in range(10)]
    kw = dict(max_frames_between_kf=10, fused_frame=False, async_mapping=False,
              pipelined_fetch=False)
    out = {"gt": np.stack([np.linalg.inv(p) for p in seq.poses])}

    def drive(name, system):
        for i, (g, d) in enumerate(frames):
            system.track_rgbd(g, d, i / seq.fps)
        out[name] = dict(est=system.tracker.full_trajectory_twc(),
                         lost=system.tracker.trajectory_lost_mask(),
                         kf=system.map.n_keyframes())
        system.shutdown()

    # the JAX drive beside the port's two (all three synchronous)
    beside(lambda: drive("jax", _jax(device_local_map=False, **kw)),
           lambda: [drive(name, _port(device_local_map=dev, **kw))
                    for name, dev in (("host", False), ("device", True))])
    return out


@pytest.mark.parametrize("other", ["device", "jax"])
def test_host_staged_local_map_matches(host_staged, other):
    h, o = host_staged["host"], host_staged[other]
    assert not h["lost"].any() and not o["lost"].any()
    assert abs(h["kf"] - o["kf"]) <= 1
    gap = np.linalg.norm(h["est"][:, :3, 3] - o["est"][:, :3, 3], axis=1)
    assert gap.max() < 0.01, gap
    assert ate_rmse(h["est"], host_staged["gt"]) < 0.05
