"""Parity of orbslam2_tpu_torch.backend.pose_opt with the JAX package (its
parts, and the capture form against the early-stop form, are in
test_torch_pose_opt_parts.py).

The same seeded problems go through both. Tolerances: pose within 1e-4 in
twist norm (float32 normal equations summed in another order, LU of a 6x6),
identical inlier masks (no observation of these problems lies within float32
noise of its chi-square threshold at the solution).
"""
import numpy as np
import pytest
import torch

from orbslam2_tpu.backend import pose_opt as jpo
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.backend import pose_opt as tpo
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera

from torch_port_helpers import j, n, t

CAM_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0)
JCAM, TCAM = JCamera(**CAM_KW), TCamera(**CAM_KW)


def make_problem(seed, n_obs=200, noise=0.5, outlier_frac=0.0, stereo_frac=0.0,
                 valid_frac=1.0, init_scale=0.05):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, size=(n_obs, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(4.0, 12.0, size=n_obs)
    tcw_true = n(jse3.exp(j((rng.normal(size=6) * 0.2).astype(np.float32))))
    uvr, _ = JCAM.project_stereo(jse3.apply(j(tcw_true), j(pts)))
    uv = np.array(uvr)
    is_stereo = rng.uniform(size=n_obs) < stereo_frac
    uv[~is_stereo, 2] = -1.0
    uv[:, :2] += rng.normal(size=(n_obs, 2)).astype(np.float32) * noise
    n_out = int(n_obs * outlier_frac)
    uv[:n_out, :2] += rng.uniform(30, 80, size=(n_out, 2)).astype(np.float32)
    octave = rng.integers(0, 8, n_obs)
    obs = dict(pts_w=pts, uv=uv,
               inv_sigma2=((1.0 / 1.44) ** octave).astype(np.float32),
               is_stereo=is_stereo, valid=rng.uniform(size=n_obs) < valid_frac)
    tcw0 = n(jse3.retract(j(tcw_true), j((rng.normal(size=6) * init_scale).astype(np.float32))))
    return tcw_true, tcw0, obs


def jax_obs(o):
    return jpo.PoseObs(pts_w=j(o["pts_w"]), uv=j(o["uv"]), inv_sigma2=j(o["inv_sigma2"]),
                       is_stereo=j(o["is_stereo"]), valid=j(o["valid"]))


def torch_obs(o):
    return convert.pose_obs_from_numpy(o["pts_w"], o["uv"], o["inv_sigma2"],
                                       o["is_stereo"], o["valid"])


def pose_gap(a, b):
    return float(np.linalg.norm(n(jse3.log(j(a) @ jse3.inverse(j(b))))))


CASES = {
    "mono_clean": dict(noise=0.0, init_scale=0.1),
    "mono_noise": dict(noise=0.5),
    "stereo_noise": dict(noise=0.5, stereo_frac=1.0),
    "mixed_outliers": dict(noise=0.3, outlier_frac=0.25, stereo_frac=0.6),
    "masked": dict(noise=0.4, outlier_frac=0.1, stereo_frac=0.5, valid_frac=0.4),
    "compacted": dict(n_obs=2000, noise=0.4, outlier_frac=0.1, stereo_frac=0.5,
                      valid_frac=0.35),
    "compacted_overflow": dict(n_obs=2600, noise=0.4, outlier_frac=0.05,
                               stereo_frac=0.5, valid_frac=0.6),
}


@pytest.mark.parametrize("name", list(CASES))
def test_pose_optimization_matches_jax(name):
    tcw_true, tcw0, o = make_problem(sum(map(ord, name)), **CASES[name])
    tcw_j, inl_j, n_j = jpo.pose_optimization(j(tcw0), jax_obs(o), JCAM)
    tcw_t, inl_t, n_t = tpo.pose_optimization(t(tcw0), torch_obs(o), TCAM)
    assert tcw_t.dtype == torch.float32 and n_t.dtype == torch.int32
    assert pose_gap(n(tcw_t), n(tcw_j)) < 1e-4
    assert pose_gap(n(tcw_t), tcw_true) < 0.02
    np.testing.assert_array_equal(n(inl_t), n(inl_j))
    assert int(n_t) == int(n_j) == int(n(inl_t).sum())
    if name == "compacted_overflow":
        # more valid rows than the compaction holds: rows beyond it are still
        # classified at the final pose
        assert o["valid"].sum() > 1024 and n(inl_t)[np.where(o["valid"])[0][1024:]].any()


