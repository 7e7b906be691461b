"""The drive of tests/test_async.py::TestBatchedFetch (40 frames of the
forward drive, seed 1, 320x240 / 800 / 4, the mapping worker on) in both
packages, shared by the two twin files, one for each fetch_batch."""
import numpy as np

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
CFG_KW = dict(th_depth=4.0, max_keyframes=64, max_points=8192, local_point_cap=2048,
              max_frames_between_kf=10, min_init_features=300, async_mapping=True)
N_FRAMES = 40
# the JAX test's limit is ATE(K=4) < max(2 ATE(K=1), 0.03); each twin file
# drives one K, so each holds its ATE to the limit's floor, which is stricter
ATE_MAX_M = 0.03


def run(k: int) -> dict:
    """Both packages over the same rendered frames with fetch_batch `k`.
    Tracked frames are counted from the lost mask in both."""
    seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=N_FRAMES, trajectory="forward", seed=1)
    frames = [seq.render(i) for i in range(N_FRAMES)]
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    systems = {
        "jax": JSystem(jtracking.SLAMConfig(
            cam=JCamera(**CAM_KW), orb=JORBConfig(n_features=800, n_levels=4),
            fetch_batch=k, **CFG_KW), JSensor.RGBD),
        "torch": SLAMSystem(ttracking.SLAMConfig(
            cam=TCamera(**CAM_KW), orb=TORBConfig(n_features=800, n_levels=4),
            fetch_batch=k, **CFG_KW), Sensor.RGBD, device="cpu")}
    out = {}

    def drive(name):
        system = systems[name]
        for i, (g, d) in enumerate(frames):
            system.track_rgbd(g, d, i / seq.fps)
        system.wait_mapping_idle()
        est = system.tracker.full_trajectory_twc()
        lost = system.tracker.trajectory_lost_mask()
        out[name] = dict(tracked=int((~lost).sum()), n=len(lost), ate=ate_rmse(est, gt),
                         kf=system.map.n_keyframes())
        system.shutdown()

    beside(lambda: drive("jax"), lambda: drive("torch"))
    return out


def check_tracked(runs: dict) -> None:
    j, p = runs["jax"], runs["torch"]
    assert p["n"] == j["n"] == N_FRAMES
    assert p["tracked"] == j["tracked"] == N_FRAMES
    assert p["kf"] >= 2


def check_ate(runs: dict, pkg: str) -> None:
    assert runs[pkg]["ate"] < ATE_MAX_M, runs
