"""The two-view initializer's steps in the port against the JAX package's,
on the CPU: the normalisation, the DLT homography, the eight-point F, the
scores and masks, the decompositions of E and H and the motion check, on
tests/test_initializer.py's general scene (the whole initializer is in
test_torch_initializer.py).

Tolerances (both solve in float32 with eigh / SVD from different LAPACK
paths): equal normalisations and masks, scores within float32 summation
noise, H within 1e-4 after dividing out sign and Frobenius norm, the
decompositions equal as sets within 1e-4. F is the null vector of AᵀA,
which float32 determines only to about its rounding over the relative
eigenvalue gap: an eight-point F of either package lies up to 0.3-0.7 from
the float64 solution on this scene's worst samples, so each F is held
within 1e-7 over that gap (1e-4 where the gap is above 1e-3).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from orbslam2_tpu.solvers import initializer as ji
from orbslam2_tpu_torch.solvers import initializer as ti

from test_initializer import K, general_scene, planar_scene
from torch_port_helpers import jax_sample_sets, n
from torch_port_helpers import t
from test_torch_initializer import KEY, SEED


def _gap_up_to_sign(a, b):
    """Largest entry difference of two [..., 3, 3] matrices up to sign and
    scale: each divided by its Frobenius norm, the closer of b and -b."""
    a, b = (np.asarray(m, np.float64).reshape(*np.shape(m)[:-2], 9) for m in (a, b))
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def _same_set(rs_t, ts_t, rs_j, ts_j, tol=1e-4):
    """Each port hypothesis has its own JAX twin (a bijection)."""
    rs_t, ts_t, rs_j, ts_j = (np.asarray(x, np.float64) for x in (rs_t, ts_t, rs_j, ts_j))
    used = set()
    for r, tt in zip(rs_t, ts_t):
        hit = [i for i in range(len(rs_j)) if i not in used
               and np.abs(r - rs_j[i]).max() < tol and np.abs(tt - ts_j[i]).max() < tol]
        assert hit, "a hypothesis of the port has no JAX twin"
        used.add(hit[0])


def _normalized(g):
    """The JAX package's normalisation of both views: (uv1, T1, uv2, T2)."""
    u1, t1 = ji._normalize(jnp.asarray(g["uv1"]), jnp.asarray(g["valid"]))
    u2, t2 = ji._normalize(jnp.asarray(g["uv2"]), jnp.asarray(g["valid"]))
    return n(u1), n(t1), n(u2), n(t2)


def _check_normalize(g):
    for uv in (g["uv1"], g["uv2"]):
        uj, tj = ji._normalize(jnp.asarray(uv), jnp.asarray(g["valid"]))
        ut, tt = ti._normalize(t(uv), t(g["valid"]))
        np.testing.assert_allclose(n(ut), n(uj), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(n(tt), n(tj), rtol=1e-6, atol=1e-6)


def _check_dlt_homography(g):
    u1, _, u2, _ = _normalized(g)
    s = g["sets"]
    h_j = jax.vmap(ji._dlt_homography)(jnp.asarray(u1[s]), jnp.asarray(u2[s]))
    h_t = ti._dlt_homography(t(u1[s]), t(u2[s]))
    assert _gap_up_to_sign(n(h_t), n(h_j)).max() < 1e-4
    w = g["valid"].astype(np.float32)
    assert _gap_up_to_sign(
        n(ti._dlt_homography(t(u1), t(u2), t(w))),
        n(ji._dlt_homography(jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(w)))) < 1e-4


def _relative_gap(p1, p2):
    """Second-smallest over largest eigenvalue of the eight-point AᵀA, in
    float64."""
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    a = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)],
                 -1).astype(np.float64)
    ev = np.linalg.eigvalsh(np.swapaxes(a, -1, -2) @ a)
    return ev[..., 1] / ev[..., -1]


def _check_eight_point_f(g):
    u1, _, u2, _ = _normalized(g)
    s = g["sets"]
    f_j = jax.vmap(ji._eight_point_f)(jnp.asarray(u1[s]), jnp.asarray(u2[s]))
    f_t = ti._eight_point_f(t(u1[s]), t(u2[s]))
    diff = _gap_up_to_sign(n(f_t), n(f_j))
    gap = _relative_gap(u1[s], u2[s])
    assert (diff <= np.maximum(1e-7 / gap, 1e-5)).all()
    assert (gap > 1e-3).sum() == 0 or diff[gap > 1e-3].max() < 1e-4
    assert np.abs(np.linalg.det(n(f_t).astype(np.float64))).max() < 1e-6   # rank 2
    w = g["valid"].astype(np.float32)
    assert _gap_up_to_sign(
        n(ti._eight_point_f(t(u1), t(u2), t(w))),
        n(ji._eight_point_f(jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(w)))) < 1e-4


def _best_models(g):
    """The JAX package's all-valid fits of F (general scene) and H (planar
    scene), in pixels."""
    u1, t1, u2, t2 = _normalized(g)
    w = jnp.asarray(g["valid"].astype(np.float32))
    f = t2.T @ ji._eight_point_f(jnp.asarray(u1), jnp.asarray(u2), w) @ t1
    p1, p2, pv = g["planar"]
    q1, tq1 = ji._normalize(jnp.asarray(p1), jnp.asarray(pv))
    q2, tq2 = ji._normalize(jnp.asarray(p2), jnp.asarray(pv))
    h = jnp.linalg.inv(tq2) @ ji._dlt_homography(q1, q2, jnp.asarray(pv.astype(np.float32))) @ tq1
    return n(f), n(h / h[2, 2])


def _check_scores(g):
    f, h = g["models"]
    p1, p2, pv = g["planar"]
    for fn_j, fn_t, m, (a, b, v) in (
            (ji._score_f, ti._score_f, f, (g["uv1"], g["uv2"], g["valid"])),
            (ji._score_h, ti._score_h, h, (p1, p2, pv))):
        sc_j, in_j = fn_j(jnp.asarray(m), jnp.asarray(a), jnp.asarray(b), jnp.asarray(v))
        sc_t, in_t = fn_t(t(m), t(a), t(b), t(v))
        np.testing.assert_array_equal(n(in_t), n(in_j))
        assert n(in_j).sum() > 100
        np.testing.assert_allclose(float(sc_t), float(sc_j), rtol=1e-5)


def _check_decompose_e(g):
    e = g["k"].T @ g["models"][0] @ g["k"]
    rs_j, ts_j = ji._decompose_e(jnp.asarray(e))
    rs_t, ts_t = ti._decompose_e(t(e))
    _same_set(n(rs_t), n(ts_t), n(rs_j), n(ts_j))


def _check_decompose_h(g):
    h = g["models"][1]
    rs_j, ts_j = ji._decompose_h(jnp.asarray(h), jnp.asarray(g["k"]))
    rs_t, ts_t = ti._decompose_h(t(h), t(g["k"]))
    assert rs_t.shape == (8, 3, 3) and ts_t.shape == (8, 3)
    _same_set(n(rs_t), n(ts_t), n(rs_j), n(ts_j))


def _check_check_rt(g):
    rs, ts = ji._decompose_e(jnp.asarray(g["k"].T @ g["models"][0] @ g["k"]))
    args = (g["uv1"], g["uv2"], g["valid"])
    out_j = jax.jit(jax.vmap(lambda r, tt: ji._check_rt(
        r, tt, *(jnp.asarray(a) for a in args), jnp.asarray(g["k"]))))(rs, ts)
    out_t = ti._check_rt(t(n(rs)), t(n(ts)), *(t(a) for a in args), t(g["k"]))
    ng_j, ng_t = n(out_j[0]), n(out_t[0])
    assert ng_j.max() > 200
    for h in range(4):
        assert abs(int(ng_t[h]) - int(ng_j[h])) <= 0.01 * len(args[0])
        assert (n(out_t[1])[h] != n(out_j[1])[h]).mean() <= 0.01
        np.testing.assert_allclose(n(out_t[2])[h], n(out_j[2])[h], atol=1e-6)
    best = int(ng_j.argmax())
    both = n(out_t[1])[best] & n(out_j[1])[best]
    p_t, p_j = n(out_t[3])[best][both], n(out_j[3])[best][both]
    assert (np.linalg.norm(p_t - p_j, axis=1) / p_j[:, 2]).max() < 1e-3


PURE = {"normalize": _check_normalize, "dlt_homography": _check_dlt_homography,
        "eight_point_f": _check_eight_point_f, "scores_and_masks": _check_scores,
        "decompose_e": _check_decompose_e, "decompose_h": _check_decompose_h,
        "check_rt": _check_check_rt}


@pytest.fixture(scope="module")
def general():
    uv1, uv2, valid = general_scene(np.random.default_rng(SEED), noise=0.2)[:3]
    uvp1, uvp2, validp = planar_scene(np.random.default_rng(SEED), noise=0.2)[:3]
    sets = n(jax_sample_sets(valid, 200, 8, KEY))
    g = dict(uv1=uv1, uv2=uv2, valid=valid, sets=sets, k=K.astype(np.float32),
             planar=(uvp1, uvp2, validp))
    g["models"] = _best_models(g)
    return g


@pytest.mark.parametrize("name", list(PURE))
def test_pure_function_matches_jax(general, name):
    PURE[name](general)
