"""The two-view initializer of the port against the JAX package's, on the CPU
(its steps one by one are in test_torch_initializer_steps.py).

Inputs are tests/test_initializer.py's seeded scenes (the general scene and
F, the planar scene and H, outliers, pure rotation), made with numpy from
the same seed; the port gets the sample sets the JAX package draws for
PRNGKey(7) (torch_port_helpers.jax_sample_sets), so both score the same 200
hypotheses.

Tolerances: both solve in float32 with eigh / SVD from different LAPACK
paths, so the chosen motion agrees within 1e-4 rad and its translation
direction within 1e-4, `good` may differ on 1 % of the pairs (a point at the
edge of the reprojection gate), and the points good in both agree within
1e-3 relative to their depth. The pure functions are held tighter: equal
normalisations and masks, scores within float32 summation noise, H within
1e-4 after dividing out sign and Frobenius norm, the decompositions equal
as sets within 1e-4. F is the null vector of AᵀA, which float32 determines
only to about its rounding over the relative eigenvalue gap: an eight-point
F of either package lies up to 0.3-0.7 from the float64 solution on this
scene's worst samples, so each F is held within 1e-7 over that gap (1e-4
where the gap is above 1e-3) and the all-inlier refit, well conditioned,
within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.solvers import initializer as ji
from orbslam2_tpu_torch.solvers import initializer as ti

from test_initializer import K, general_scene, planar_scene
from torch_port_helpers import jax_sample_sets, n, t

SEED = 42   # tests/conftest.py's rng
KEY = 7


def _pure_rotation(rng):
    """tests/test_initializer.py::test_pure_rotation_rejected's inputs."""
    from orbslam2_tpu.geometry import se3
    from test_initializer import CAM
    pts = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(4.0, 14.0, size=300)
    r = np.asarray(se3.so3_exp(jnp.asarray(np.array([0.0, 0.05, 0.0], np.float32))))
    uv1, _ = CAM.project(jnp.asarray(pts))
    uv2, _ = CAM.project(jnp.asarray(pts @ r.T))
    return np.array(uv1), np.array(uv2), np.ones(300, bool)


SCENES = {
    "general_scene_uses_F": lambda rng: general_scene(rng, noise=0.2)[:3],
    "planar_scene_uses_H": lambda rng: planar_scene(rng, noise=0.2)[:3],
    "outliers": lambda rng: general_scene(rng, noise=0.3, outlier_frac=0.2)[:3],
    "pure_rotation_rejected": _pure_rotation,
}


def _solve_both(uv1, uv2, valid):
    k = K.astype(np.float32)
    res_j = ji.initialize_two_view(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                                   jnp.asarray(k), jax.random.PRNGKey(KEY))
    sets = jax_sample_sets(valid, 200, 8, KEY)
    res_t = ti.initialize_two_view(t(uv1), t(uv2), t(valid), t(k), sets)
    return res_j, res_t


@pytest.fixture(scope="module")
def solved():
    out = {}
    for name, make in SCENES.items():
        uv1, uv2, valid = make(np.random.default_rng(SEED))
        out[name] = (uv1, uv2, valid, *_solve_both(uv1, uv2, valid))
    return out


def _rot_angle(r):
    """Angle of a rotation, accurate near 0 (arccos of the trace is not)."""
    sin = 0.5 * np.linalg.norm([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return float(np.arctan2(sin, (np.trace(r) - 1) / 2))


@pytest.mark.parametrize("name", list(SCENES))
def test_two_view_matches_jax(solved, name):
    uv1, uv2, valid, rj, rt = solved[name]
    assert bool(rt.success) == bool(rj.success)
    assert bool(rt.used_homography) == bool(rj.used_homography)
    if name == "pure_rotation_rejected":
        assert not bool(rt.success)
        return
    assert bool(rt.success)
    assert bool(rt.used_homography) == (name == "planar_scene_uses_H")
    r_t, r_j = n(rt.r21).astype(np.float64), n(rj.r21).astype(np.float64)
    assert _rot_angle(r_t @ r_j.T) < 1e-4
    t_t, t_j = n(rt.t21).astype(np.float64), n(rj.t21).astype(np.float64)
    assert np.arccos(np.clip(t_t @ t_j / np.linalg.norm(t_t) / np.linalg.norm(t_j),
                             -1, 1)) < 1e-4
    g_t, g_j = n(rt.good), n(rj.good)
    assert (g_t != g_j).mean() <= 0.01
    assert abs(int(rt.n_good) - int(rj.n_good)) <= 0.01 * len(g_j)
    both = g_t & g_j
    assert both.sum() > 100
    p_t, p_j = n(rt.points)[both], n(rj.points)[both]
    rel = np.linalg.norm(p_t - p_j, axis=1) / np.abs(p_j[:, 2])
    assert rel.max() < 1e-3


def test_clear_winner_count_is_float32():
    """63 good points against a best of 90: in float32 (0.7 * 90 rounds to
    63.0) the second hypothesis is not similar, in float64 it is."""
    goods = np.array([90, 63, 12, 5, -1, -1, -1, -1], np.int32)
    got = int(ti._n_similar(t(goods).long(), t(goods[:1]).long()[0]))
    want = int(jnp.sum((jnp.asarray(goods) > 0.7 * jnp.asarray(goods)[0]).astype(jnp.int32)))
    assert got == want == 1
    assert int((goods.astype(np.float64) > 0.7 * 90.0).sum()) == 2


def test_singular_sample_does_not_raise():
    """A degenerate sample gives a singular homography: the symmetric
    transfer score inverts it without raising (inv_ex), like JAX's inf."""
    h = torch.zeros(2, 3, 3)
    h[1] = torch.eye(3)
    uv = torch.rand(10, 2) * 100
    score, inl = ti._score_h(h, uv, uv, torch.ones(10, dtype=torch.bool))
    assert torch.isfinite(score).all() and bool(inl[1].all())
