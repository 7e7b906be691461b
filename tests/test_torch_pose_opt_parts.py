"""The pose optimization's parts in the port, on the CPU: a frame without
observations, the residuals, Jacobian and compaction against the JAX
package's, the observation set against ``make_pose_obs``, and the capture
form (every LM step run, the flag on the device) against the early-stop
form bit for bit (the whole optimization against the JAX package is in
test_torch_pose_opt.py).
"""
import numpy as np
import pytest
import torch

from orbslam2_tpu.backend import pose_opt as jpo
from orbslam2_tpu_torch.backend import pose_opt as tpo

from torch_port_helpers import j, n, t
from test_torch_pose_opt import JCAM, TCAM, jax_obs, make_problem, torch_obs


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _lm_steps(monkeypatch, fn):
    """-> (fn(), the LM steps it took): each step retracts the pose once."""
    steps = [0]
    retract = tpo.se3.retract

    def counting(*a, **k):
        steps[0] += 1
        return retract(*a, **k)

    monkeypatch.setattr(tpo.se3, "retract", counting)
    out = fn()
    monkeypatch.setattr(tpo.se3, "retract", retract)
    return out, steps[0]


# one round each: (problem, LM steps per round, how the early-stop form ends)
STOP_CASES = {
    # converges: the proposed step falls below noise after a few steps
    "converges": (dict(noise=0.0, init_scale=0.1), 10, "below 10"),
    # a non-finite observation makes every cost NaN, so every step is
    # rejected and the damping grows 4x a step: at least 1e6 at step 15
    "damping_maxed": (dict(noise=0.5, nan_obs=True), 20, 15),
    # 30 % outliers and a far start: no step of the round converges
    "all_steps": (dict(noise=0.5, init_scale=0.3, outlier_frac=0.3), 10, 10),
}


def test_zero_observations_leave_the_pose_unchanged():
    _, tcw0, o = make_problem(5)
    o["valid"][:] = False
    tcw_j, inl_j, n_j = jpo.pose_optimization(j(tcw0), jax_obs(o), JCAM)
    tcw_t, inl_t, n_t = tpo.pose_optimization(t(tcw0), torch_obs(o), TCAM)
    assert np.isfinite(n(tcw_t)).all()
    np.testing.assert_allclose(n(tcw_t), n(tcw_j), atol=1e-6)
    np.testing.assert_allclose(n(tcw_t), tcw0, atol=1e-6)
    assert int(n_t) == int(n_j) == 0 and not n(inl_t).any()


def test_residuals_jacobian_and_compaction_match_jax():
    _, tcw0, o = make_problem(9, stereo_frac=0.5, valid_frac=0.5)
    o["pts_w"][0, 2] = -50.0                    # behind the camera: guarded depth
    e_j, jac_j, z_j = jpo._residual_jacobian_flat(j(tcw0), jax_obs(o), JCAM)
    e_t, jac_t, z_t = tpo._residual_jacobian_flat(t(tcw0), torch_obs(o), TCAM)
    np.testing.assert_allclose(n(e_t)[1:], n(e_j)[1:], atol=2e-3)   # pixels
    np.testing.assert_allclose(n(jac_t)[1:], n(jac_j)[1:], rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(n(z_t), n(z_j), atol=1e-5)
    e2_t, z2_t = tpo._residual_only(t(tcw0), torch_obs(o), TCAM)
    assert torch.equal(e2_t, e_t) and torch.equal(z2_t, z_t)
    c_j = jpo._compact_obs(jax_obs(o), 64)
    c_t = tpo._compact_obs(torch_obs(o), 64)
    for a, b in zip(c_t, c_j):
        np.testing.assert_array_equal(n(a), n(b))
    assert n(c_t.valid).sum() == 64 and o["valid"].sum() > 64


def test_make_pose_obs_matches_jax(rng):
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    uv = rng.uniform(0, 400, (20, 2)).astype(np.float32)
    octave = rng.integers(0, 8, 20).astype(np.int32)
    flags = rng.uniform(size=20) < 0.5
    a = jpo.make_pose_obs(j(pts), j(uv), j(octave), j(flags), j(~flags))
    b = tpo.make_pose_obs(t(pts), t(uv), t(octave), t(flags), t(~flags))
    for x, y in zip(b, a):
        np.testing.assert_allclose(n(x), n(y), rtol=1e-6)
    assert (tpo.CHI2_MONO, tpo.CHI2_STEREO) == (jpo.CHI2_MONO, jpo.CHI2_STEREO)


@pytest.mark.parametrize("name", list(STOP_CASES))
def test_capture_form_equals_early_stop_bit_for_bit(monkeypatch, name):
    """`stop_early=False` (every step run, the flag carried on the device and
    the pose, damping and cost frozen once it is set: the form a CUDA graph
    captures) gives `stop_early=True`'s pose, inlier mask and count bit for
    bit, in one round that stops early for each reason and over the full
    four-round schedule."""
    kw, iters, ends = STOP_CASES[name]
    kw = dict(kw)
    nan_obs = kw.pop("nan_obs", False)
    _, tcw0, o = make_problem(1, **kw)
    if nan_obs:
        o["uv"][0, 0] = np.nan
    for rounds in (1, 4):
        (early, steps) = _lm_steps(monkeypatch, lambda: tpo.pose_optimization(
            t(tcw0), torch_obs(o), TCAM, rounds=rounds, iters=iters, stop_early=True))
        (full, all_steps) = _lm_steps(monkeypatch, lambda: tpo.pose_optimization(
            t(tcw0), torch_obs(o), TCAM, rounds=rounds, iters=iters, stop_early=False))
        assert all_steps == rounds * iters
        if rounds == 1:
            assert steps < 10 if ends == "below 10" else steps == ends
        for a, b in zip(early, full):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert tpo.host_may_read(t(tcw0))
