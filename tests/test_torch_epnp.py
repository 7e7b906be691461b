"""EPnP and its RANSAC in the port against the JAX package, on the CPU: the
minimal sets solved alone and batched, and the RANSAC on the very 4-point
sets the JAX package draws (its split + choice is repeated here with
jax.random), since no torch generator reproduces jax.random (the
relocalization itself is in test_torch_reloc.py). After the draw both
must agree: the same inlier mask and Tcw within 1e-4 (the Tcw is the EPnP
solve refined on all inliers, whose eigen-decompositions have a
one-dimensional null space and a unique answer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.solvers import epnp as jepnp
from orbslam2_tpu_torch.solvers import epnp

from torch_port_helpers import j, n, t
from test_torch_reloc import JCAM, TCAM


def pnp_problem(seed, n_pts=120, noise=0.5, outlier_frac=0.0, cap=None):
    """2D-3D correspondences of a random pose (tests/test_place_solvers.py's
    kind), padded to `cap` rows as the tracker pads them."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(4, 12, n_pts)
    tcw = n(jse3.exp(j((rng.normal(size=6) * 0.3).astype(np.float32))))
    uv = n(JCAM.project(jse3.apply(j(tcw), j(pts)))[0]).copy()
    uv += rng.normal(size=uv.shape).astype(np.float32) * noise
    n_out = int(n_pts * outlier_frac)
    uv[:n_out] += rng.uniform(30, 90, (n_out, 2)).astype(np.float32)
    sigma2 = (1.2 ** (2.0 * rng.integers(0, 4, n_pts))).astype(np.float32)
    cap = cap or n_pts
    pad = lambda a, v: np.concatenate([a, np.full((cap - n_pts,) + a.shape[1:], v, a.dtype)])
    valid = np.ones(cap, bool)
    valid[n_pts:] = False
    return (pad(pts, 0.0), pad(uv.astype(np.float32), 0.0), valid, pad(sigma2, 1.0),
            tcw, n_out)


def test_solve_epnp_on_minimal_sets():
    """A batch of 4-point sets in one call. On a minimal set the M matrix has
    a 4-dimensional null space whose basis each LAPACK call picks freely, so
    the beta approximations land on different answers in the two packages
    and only some sets solve tightly (tests/test_place_solvers.py asserts
    the same for the JAX package): at least 4 of 12 here, as there."""
    errs = []
    for seed in range(12):
        pts, uv, _, _, tcw_true, _ = pnp_problem(seed, n_pts=4, noise=0.0)
        errs.append(np.abs(n(epnp._solve_epnp(t(pts), t(uv), t(np.ones((1, 4), np.float32)),
                                              TCAM))[0] - tcw_true).max())
    assert sum(e < 0.01 for e in errs) >= 4, errs
    # with many points the solve is exact on clean data
    pts, uv, valid, _, tcw_true, _ = pnp_problem(0, noise=0.0)
    np.testing.assert_allclose(n(epnp._solve_epnp(t(pts), t(uv), t(valid.astype(np.float32))[None],
                                                  TCAM))[0], tcw_true, atol=1e-3)
    # one batched call solves each set as a call of its own does
    pts, uv, _, _, _, _ = pnp_problem(1, noise=0.0)
    rng = np.random.default_rng(2)
    w = np.zeros((6, len(pts)), np.float32)
    for row in w:
        row[rng.choice(len(pts), 4, replace=False)] = 1.0
    batched = n(epnp._solve_epnp(t(pts), t(uv), t(w), TCAM))
    alone = np.stack([n(epnp._solve_epnp(t(pts), t(uv), t(row)[None], TCAM))[0] for row in w])
    np.testing.assert_allclose(batched, alone, atol=1e-4)


OUTLIER_FRACS = (0.0, 0.3)


def _ransac_problem(outlier_frac):
    return pnp_problem(3, outlier_frac=outlier_frac, cap=512, n_pts=150)


def _jax_ransac(outlier_frac):
    """The JAX package's EPnP RANSAC on the problem and the 4-point sets it
    drew, as numpy."""
    pts, uv, valid, sigma2, _, _ = _ransac_problem(outlier_frac)
    key = jax.random.PRNGKey(40 * 17 + 3)
    res_j = jepnp.epnp_ransac(j(pts), j(uv), j(valid), j(sigma2), JCAM, key)
    probs = jnp.asarray(valid, jnp.float32) / valid.sum()
    sets = np.asarray(jax.vmap(lambda k_: jax.random.choice(
        k_, len(valid), (4,), replace=False, p=probs))(jax.random.split(key, 300)))
    return dict(success=bool(res_j.success), inliers=n(res_j.inliers), tcw=n(res_j.tcw),
                sets=sets)


@pytest.fixture(scope="module")
def jax_ransac():
    """The JAX package's EPnP RANSAC runs, with the sets they drew."""
    return {f: _jax_ransac(f) for f in OUTLIER_FRACS}


@pytest.mark.parametrize("outlier_frac", OUTLIER_FRACS)
def test_epnp_ransac_on_the_sets_jax_drew(jax_ransac, outlier_frac):
    pts, uv, valid, sigma2, tcw_true, n_out = _ransac_problem(outlier_frac)
    res_j = jax_ransac[outlier_frac]
    res_t = epnp.epnp_ransac(t(pts), t(uv), t(valid), t(sigma2), TCAM,
                             t(res_j["sets"]).long())
    assert bool(res_t.success) and res_j["success"]
    np.testing.assert_array_equal(n(res_t.inliers), res_j["inliers"])
    np.testing.assert_allclose(n(res_t.tcw), res_j["tcw"], atol=1e-4)
    assert not n(res_t.inliers)[:n_out].any()
