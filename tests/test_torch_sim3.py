"""Sim(3) geometry, Umeyama, Sim3 RANSAC, the Sim3 optimization and the
SearchBySim3 search of the port against the JAX package, the port's
essential graph on a drifting ring, and global BA's PCG Schur solve against
the JAX package's (on test_torch_ba.py's problems), on the CPU.

Inputs come from numpy seeds. The RANSAC gets the very index sets the JAX
package draws (its split + choice is repeated here with jax.random), since
no torch generator reproduces jax.random; everything after the draw is then
compared. Tolerances: the Sim3 maps and Umeyama 1e-5 (float32 of unit-sized
quantities, with a cube root and an SVD in between), RANSAC and the
optimisation 1e-4 on the Sim3 and the same inlier mask or count, the
SearchBySim3 matches identical.

The essential graph's setup and LM step (captured as CUDA graphs by its
program on a card) read no tensor on the host; padded edges and padded
global-BA observations add exact zeros: a padded problem solves as the
unpadded one in float64, within 1e-12 (the cost sums over more rows, so
its rounding may differ in the last bits; every sum into a keyframe, a
camera or a point adds only zeros).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.backend import ba as jba
from orbslam2_tpu.backend import sim3_opt as jsim3_opt
from orbslam2_tpu.frontend import kernels as jkernels
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry import sim3 as jsim3
from orbslam2_tpu.geometry import sim3_np as jsim3_np
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.solvers import horn as jhorn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.backend import ba as tba
from orbslam2_tpu_torch.backend import pose_graph, sim3_opt, solve_program
from orbslam2_tpu_torch.frontend import kernels
from orbslam2_tpu_torch.frontend.local_mapping import size_bucket
from orbslam2_tpu_torch.geometry import sim3, sim3_np
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.solvers import horn

from test_torch_ba import CASES, FIELDS, float64_problem, make_problem, pad_observations
from test_torch_ba import JCAM as BA_JCAM, TCAM as BA_TCAM
from torch_port_helpers import (camera_centres, j, jax_keypoints, n, no_host_reads,
                                random_keypoints, t, torch_keypoints)

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), PinholeCamera(**CAM_KW)


def _xis(seed, count=16):
    """Sim3 tangents with angles from 0 to 1 rad and log-scales to 0.3,
    including exact zeros (the clamped branches)."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(count, 7)).astype(np.float32) * [0.5, 0.5, 0.5, 0.4, 0.4, 0.4, 0.15]
    xi[0] = 0.0
    xi[1, 3:] = 0.0
    xi[2, 6] = 0.0
    return xi.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_sim3_maps_match_jax(seed):
    xi = _xis(seed)
    s_j, s_t = jax.jit(jsim3.exp)(jnp.asarray(xi)), sim3.exp(t(xi))
    np.testing.assert_allclose(n(s_t), n(s_j), atol=1e-5)
    np.testing.assert_allclose(n(sim3.log(s_t)), n(jax.jit(jsim3.log)(s_j)), atol=1e-5)
    np.testing.assert_allclose(n(sim3.inverse(s_t)), n(jsim3.inverse(s_j)), atol=1e-5)
    np.testing.assert_allclose(n(sim3.compose(s_t, s_t.flip(0))),
                               n(jsim3.compose(s_j, s_j[::-1])), atol=1e-5)
    np.testing.assert_allclose(n(sim3.to_se3(s_t)), n(jsim3.to_se3(s_j)), atol=1e-5)
    np.testing.assert_allclose(n(sim3.from_se3(sim3.to_se3(s_t), 1.3)),
                               n(jsim3.from_se3(jsim3.to_se3(s_j), 1.3)), atol=1e-5)
    pts = np.random.default_rng(seed + 10).normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(n(sim3.apply(s_t, t(pts))),
                               n(jsim3.apply(s_j, jnp.asarray(pts))), atol=1e-5)
    # the round trip through log
    np.testing.assert_allclose(n(sim3.exp(sim3.log(s_t))), n(s_t), atol=1e-5)


def test_sim3_np_matches_jax():
    s = np.asarray(jsim3.exp(jnp.asarray(_xis(3))))
    pts = np.random.default_rng(4).normal(size=(16, 3)).astype(np.float32)
    for name in ("inverse", "to_se3", "from_se3", "se3_inverse"):
        arg = s if name != "se3_inverse" else np.asarray(jsim3.to_se3(jnp.asarray(s)))
        np.testing.assert_allclose(getattr(sim3_np, name)(arg),
                                   getattr(jsim3_np, name)(arg), atol=1e-6, err_msg=name)
    np.testing.assert_allclose(sim3_np.apply(s, pts), jsim3_np.apply(s, pts), atol=1e-6)
    np.testing.assert_allclose(sim3_np.split(s)[0], jsim3_np.split(s)[0], atol=1e-6)
    assert sim3_np.inverse(s).dtype == np.float32
    assert sim3_np.inverse(s.astype(np.float64)).dtype == np.float64


@pytest.mark.parametrize("with_scale,weighted", [(True, False), (False, False), (True, True)])
def test_umeyama_matches_jax(with_scale, weighted):
    rng = np.random.default_rng(5)
    src = rng.normal(size=(4, 30, 3)).astype(np.float32)
    r = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32))))
    dst = (1.7 * src @ r.transpose(0, 2, 1) + [1.0, -2.0, 0.5]
           + rng.normal(size=src.shape) * 0.01).astype(np.float32)
    w = rng.uniform(0, 1, (4, 30)).astype(np.float32) if weighted else None
    out_j = jhorn.umeyama(jnp.asarray(src), jnp.asarray(dst),
                          None if w is None else jnp.asarray(w), with_scale=with_scale)
    out_t = horn.umeyama(t(src), t(dst), None if w is None else t(w), with_scale=with_scale)
    for a, b, name in zip(out_t, out_j, "srt"):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5, err_msg=name)


def _jax_sets(key, valid, iters, size):
    """The index sets jax.random draws inside the JAX RANSACs (split +
    choice with probabilities proportional to `valid`)."""
    probs = jnp.asarray(valid, jnp.float32) / max(int(np.sum(valid)), 1)
    keys = jax.random.split(key, iters)
    return np.asarray(jax.vmap(lambda k_: jax.random.choice(
        k_, len(valid), (size,), replace=False, p=probs))(keys))


def _sim3_pairs(seed, n_pts=120, n_out=25, with_scale=True):
    """Matched camera-frame points of two keyframes related by a Sim3, with
    pixel noise and outliers, padded as loop closing pads them."""
    rng = np.random.default_rng(seed)
    pts1 = (rng.uniform(-2, 2, (n_pts, 3)) + [0, 0, 6]).astype(np.float32)
    s_true = 1.1 if with_scale else 1.0
    r_true = np.asarray(jse3.so3_exp(jnp.asarray(np.array([0.1, 0.2, -0.1], np.float32))))
    t_true = np.array([0.4, -0.2, 0.3], np.float32)
    pts2 = ((pts1 - t_true) @ r_true / s_true).astype(np.float32)
    pts2 += rng.normal(size=pts2.shape).astype(np.float32) * 0.005
    pts2[:n_out] += rng.uniform(0.5, 2, (n_out, 3)).astype(np.float32)
    valid = np.ones(n_pts, bool)
    valid[-10:] = False
    s1 = (1.2 ** (2.0 * rng.integers(0, 4, n_pts))).astype(np.float32)
    s2 = (1.2 ** (2.0 * rng.integers(0, 4, n_pts))).astype(np.float32)
    return pts1, pts2, valid, s1, s2


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_on_the_sets_jax_drew(fix_scale):
    pts1, pts2, valid, s1, s2 = _sim3_pairs(6, with_scale=not fix_scale)
    key = jax.random.PRNGKey(7 * 131 + 3)
    res_j = jhorn.sim3_ransac(jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(valid),
                              jnp.asarray(s1), jnp.asarray(s2), JCAM, key,
                              fix_scale=fix_scale)
    sets = t(_jax_sets(key, valid, 300, 3)).long()
    res_t = horn.sim3_ransac(t(pts1), t(pts2), t(valid), t(s1), t(s2), TCAM, sets,
                             fix_scale=fix_scale)
    assert bool(res_j.success) and bool(res_t.success)
    np.testing.assert_array_equal(n(res_t.inliers), n(res_j.inliers))
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    np.testing.assert_allclose(n(res_t.s12), n(res_j.s12), atol=1e-4)


def test_draw_sample_sets():
    valid = np.zeros(50, bool)
    valid[::3] = True
    a = horn.draw_sample_sets(valid, 300, 4, seed=11)
    b = horn.draw_sample_sets(valid, 300, 4, seed=11)
    assert a.shape == (300, 4) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert not torch.equal(a, horn.draw_sample_sets(valid, 300, 4, seed=12))
    assert valid[a.numpy()].all()
    srt = torch.sort(a, dim=1).values
    assert (srt[:, 1:] != srt[:, :-1]).all()


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(fix_scale):
    rng = np.random.default_rng(8)
    pts1, pts2, valid, s1, s2 = _sim3_pairs(9, with_scale=not fix_scale)
    uv1 = n(JCAM.project(jnp.asarray(pts1))[0]) + rng.normal(size=(len(pts1), 2)) * 0.5
    uv2 = n(JCAM.project(jnp.asarray(pts2))[0]) + rng.normal(size=(len(pts2), 2)) * 0.5
    uv1, uv2 = uv1.astype(np.float32), uv2.astype(np.float32)
    # start away from the optimum: a perturbed version of the true Sim3
    s_true = n(jsim3.from_srt(jnp.float32(1.0 if fix_scale else 1.1), jse3.so3_exp(
        jnp.asarray(np.array([0.1, 0.2, -0.1], np.float32))), jnp.asarray([0.4, -0.2, 0.3])))
    s0 = (n(jsim3.exp(jnp.asarray(np.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.01,
                                            0.0 if fix_scale else 0.02], np.float32))))
          @ s_true).astype(np.float32)
    args = (pts1, pts2, uv1, uv2, 1.0 / s1, 1.0 / s2, valid)
    s_j, inl_j, n_j = jsim3_opt.optimize_sim3(jnp.asarray(s0), *map(jnp.asarray, args), JCAM,
                                             fix_scale=fix_scale)
    s_t, inl_t, n_t = sim3_opt.optimize_sim3(t(s0), *map(t, args), TCAM, fix_scale=fix_scale)
    assert int(n_t) == int(n_j) > 60
    np.testing.assert_array_equal(n(inl_t), n(inl_j))
    np.testing.assert_allclose(n(s_t), n(s_j), atol=1e-4)


# ----------------------------------------------------------------------
# SearchBySim3, one direction
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_by_sim3_dir_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_pts = 300
    pos = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(2, 8, n_pts)], -1).astype(np.float32)
    t_src = n(jse3.exp(j(np.array([0.1, -0.05, 0.2, 0.02, 0.05, -0.01], np.float32))))
    s_dst_src = n(jsim3.exp(j(np.array([0.05, 0.02, -0.1, 0.01, -0.03, 0.02, 0.0],
                                       np.float32))))
    # the destination keypoints: projections of most points, with pixel
    # noise, their descriptors with a few flipped bits, plus distractors
    p_dst = n(jsim3.apply(j(s_dst_src), jse3.apply(j(t_src), j(pos))))
    uv = n(JCAM.project(j(p_dst))[0])
    kp = random_keypoints(rng, 400, n_levels=4)
    take = rng.choice(n_pts, 250, replace=False)
    kp["xy"][:250] = uv[take] + rng.normal(size=(250, 2)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    flips = (rng.uniform(size=(250, 8, 32)) < 0.04)
    flip_words = np.packbits(flips, axis=-1, bitorder="little").view("<u4")[..., 0]
    kp["desc"][:250] = desc[take] ^ flip_words
    dist = np.linalg.norm(p_dst, axis=-1)
    max_d = (dist * rng.uniform(0.9, 2.0, n_pts)).astype(np.float32)
    min_d = (max_d / 1.2 ** 3 * 0.5).astype(np.float32)
    valid = rng.uniform(size=n_pts) < 0.9
    got = kernels.search_by_sim3_dir(
        t(s_dst_src), t(t_src), t(pos), convert.desc_from_numpy(desc), t(valid),
        t(min_d), t(max_d), torch_keypoints(kp), 7.5, TCAM, 1.2, 4)
    want = jkernels.search_by_sim3_dir(
        j(s_dst_src), j(t_src), j(pos), j(desc), j(valid), j(min_d), j(max_d),
        jax_keypoints(kp), 7.5, JCAM, 1.2, 4)
    np.testing.assert_array_equal(n(got), n(want))
    assert (n(got) >= 0).sum() > 40


# ----------------------------------------------------------------------
# Essential graph
# ----------------------------------------------------------------------
def ring_problem(seed, n_kf=12, drift=0.02, scale_drift=1.01):
    """Keyframes around a ring: exact odometry edges plus one loop edge, and
    initial Sim3 estimates that drift in pose and scale (the kind of
    tests/test_pose_graph.py)."""
    rng = np.random.default_rng(seed)
    true = []
    for i in range(n_kf):
        ang = 2 * np.pi * i / n_kf
        twc = np.eye(4, dtype=np.float32)
        twc[:3, :3] = n(jse3.so3_exp(j(np.array([0, ang, 0], np.float32))))
        twc[:3, 3] = [np.sin(ang) * 2, 0.0, 2 - np.cos(ang) * 2]
        true.append(np.linalg.inv(twc).astype(np.float32))
    true = np.stack(true)
    edges = [(i, i + 1) for i in range(n_kf - 1)] + [(0, n_kf - 1)]
    meas = np.stack([true[b] @ np.linalg.inv(true[a]) for a, b in edges]).astype(np.float32)
    est = [true[0]]
    for i in range(1, n_kf):
        err = n(jse3.exp(j((rng.normal(size=6) * drift).astype(np.float32))))
        drifted = err @ (true[i] @ np.linalg.inv(true[i - 1])) @ est[i - 1]
        est.append(n(jsim3.from_se3(j(drifted), scale_drift ** i)))
    k_cap = 16   # padded, as the map's keyframe capacity pads it
    poses = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
    poses[:n_kf] = np.stack(est)
    valid = np.zeros(k_cap, bool)
    valid[:n_kf] = True
    fixed = np.zeros(k_cap, bool)
    fixed[0] = True
    e = np.array(edges, np.int32)
    return true, poses, valid, fixed, e[:, 0], e[:, 1], meas


def test_essential_graph_corrects_ring_drift():
    """The port alone on a ring whose estimates drift in pose and scale
    (compared with the JAX package on the loop's own graph below)."""
    true, poses, valid, fixed, e_i, e_j, meas = ring_problem(0)
    ok = np.ones(len(e_i), bool)
    p_t, c_t = pose_graph.optimize_essential_graph(
        *map(t, (poses, valid, fixed, e_i, e_j, meas, ok)), fix_scale=False)
    r0 = n(pose_graph._edge_residuals(t(poses), t(e_i).long(), t(e_j).long(), t(meas)))
    assert float(c_t) < 0.05 * float((r0 ** 2).sum())
    np.testing.assert_array_equal(n(p_t)[0], poses[0])     # the fixed keyframe
    np.testing.assert_array_equal(n(p_t)[12:], poses[12:])  # invalid slots


def test_essential_graph_solves_in_the_problems_dtype():
    _, poses, valid, fixed, e_i, e_j, meas = ring_problem(1)
    ok = np.ones(len(e_i), bool)
    p32, _ = pose_graph.optimize_essential_graph(*map(t, (poses, valid, fixed, e_i, e_j,
                                                          meas, ok)), fix_scale=True)
    p64, _ = pose_graph.optimize_essential_graph(
        t(poses.astype(np.float64)), t(valid), t(fixed), t(e_i), t(e_j),
        t(meas.astype(np.float64)), t(ok), fix_scale=True)
    assert p64.dtype == torch.float64
    assert np.abs(camera_centres(n(p64)[:12]) - camera_centres(n(p32)[:12])).max() < 1e-3


def ring_problem64(seed):
    """ring_problem in float64, as the loop closer stages it (torch)."""
    _, poses, valid, fixed, e_i, e_j, meas = ring_problem(seed)
    return [t(x) for x in (poses.astype(np.float64), valid, fixed, e_i.astype(np.int64),
                           e_j.astype(np.int64), meas.astype(np.float64))]


def test_essential_graph_parts_read_nothing_on_the_host():
    """The setup and the LM step its program captures, run eagerly in the
    program's order under the host-read guard, give the eager solve bit for
    bit."""
    poses, valid, fixed, e_i, e_j, meas = ring_problem64(2)
    ok = torch.ones(len(e_i), dtype=torch.bool)
    graph = pose_graph._EssentialGraph(poses, valid, fixed, e_i, e_j, meas, ok, True)
    with no_host_reads():
        graph.setup()
        for _ in range(20):
            graph.step()
    p, c = pose_graph.optimize_essential_graph(poses, valid, fixed, e_i, e_j, meas, ok,
                                               fix_scale=True)
    assert torch.equal(graph.p, p) and torch.equal(graph.c, c)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_padded_edges_solve_as_the_unpadded_graph(fix_scale):
    """Edges padded as the loop closer pads them (the fixed keyframe joined
    to itself, identity measurement, invalid) change nothing: poses within
    1e-10 in float64 (the module's docstring says why not bit for bit), the
    fixed keyframe and the invalid slots unmoved."""
    poses, valid, fixed, e_i, e_j, meas = ring_problem64(3)
    ok = torch.ones(len(e_i), dtype=torch.bool)
    padded = [t(x) for x in pose_graph.pad_edges(n(e_i), n(e_j), n(meas), 0, 256)]
    assert padded[0].shape[0] == 256 and int(padded[3].sum()) == len(e_i)
    p, c = pose_graph.optimize_essential_graph(poses, valid, fixed, e_i, e_j, meas, ok,
                                               fix_scale=fix_scale)
    pp, cp = pose_graph.optimize_essential_graph(poses, valid, fixed, *padded,
                                                 fix_scale=fix_scale)
    np.testing.assert_allclose(n(pp), n(p), rtol=0, atol=1e-10)
    assert float(cp) == pytest.approx(float(c), rel=1e-10)
    assert float(c) < float(pose_graph._EssentialGraph(
        poses, valid, fixed, e_i, e_j, meas, ok, fix_scale).cost(poses))
    np.testing.assert_array_equal(n(pp)[0], n(poses)[0])
    np.testing.assert_array_equal(n(pp)[12:], n(poses)[12:])


def test_essential_graph_program_on_the_cpu_is_the_eager_solve():
    """On the CPU the program is the eager solve; its key follows the edge
    bucket: two edge counts in one bucket give one key, the next bucket
    another, as does the scale switch."""
    poses, valid, fixed, e_i, e_j, meas = ring_problem64(4)
    ok = torch.ones(len(e_i), dtype=torch.bool)
    program = solve_program.EssentialGraphProgram("cpu")
    got = program(poses, valid, fixed, e_i, e_j, meas, ok, fix_scale=True)
    want = pose_graph.optimize_essential_graph(poses, valid, fixed, e_i, e_j, meas, ok,
                                               fix_scale=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (program.captures, program.replays) == (0, 0)

    def key(n_edges, **kw):
        cut = [x[:n_edges] for x in (e_i, e_j, meas)]
        size = size_bucket(n_edges, 4, 2)
        args = [t(x) for x in pose_graph.pad_edges(*map(n, cut), 0, size)]
        return program.key(poses, valid, fixed, *args, **kw)

    assert key(5, fix_scale=True) == key(7, fix_scale=True) != key(9, fix_scale=True)
    assert key(5, fix_scale=True) != key(5, fix_scale=False)


@pytest.mark.parametrize("case", ["noisy_outliers", "stereo_rows"])
def test_padded_gba_solves_as_the_unpadded_problem(case):
    """Global-BA observations padded as the loop closer pads them (rows of
    camera 0 and point 0, invalid) change nothing: poses, points, cost and
    the inliers over the real rows bit for bit in float64."""
    problem, fixed = float64_problem(case)
    o = int(np.nonzero(n(problem.obs_valid))[0].max()) + 1
    bare = problem._replace(**{f: getattr(problem, f)[:o] for f in FIELDS[3:]})
    padded = pad_observations(bare, 4096)
    kw = dict(phase_iters=(5, 5), point_fixed=fixed)
    want = tba.bundle_adjust_pcg(bare, BA_TCAM, **kw)
    got = tba.bundle_adjust_pcg(padded, BA_TCAM, **kw)
    assert torch.equal(got.poses, want.poses) and torch.equal(got.points, want.points)
    assert torch.equal(got.cost, want.cost)
    assert torch.equal(got.inlier[:o], want.inlier)
    assert not n(got.inlier)[o:].any()


# ----------------------------------------------------------------------
# Global BA (PCG Schur)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_bundle_adjust_pcg():
    return jax.jit(jba.bundle_adjust_pcg, static_argnames=("cam", "phase_iters",
                                                           "pcg_iters"))


@pytest.mark.parametrize("case", ["clean", "noisy_outliers", "stereo_rows",
                                  "fixed_points", "under_constrained_point"])
def test_bundle_adjust_pcg_matches_jax(case, jax_bundle_adjust_pcg):
    f = make_problem(sorted(CASES).index(case), **CASES[case])
    jres = jax_bundle_adjust_pcg(jba.BAProblem(*(j(f[k]) for k in FIELDS)), BA_JCAM,
                                 phase_iters=(5, 5), point_fixed=j(f["point_fixed"]))
    tres = tba.bundle_adjust_pcg(tba.BAProblem(*(t(f[k]) for k in FIELDS)), BA_TCAM,
                                 phase_iters=(5, 5), point_fixed=t(f["point_fixed"]))
    diff = np.linalg.norm(camera_centres(n(tres.poses)) - camera_centres(n(jres.poses)), axis=-1)
    assert diff.max() < 1e-3, diff
    # points lie 8-16 m away and take every camera's error along: the
    # truncated conjugate gradients (stopped at a 1e-3 relative residual)
    # sum in another order than the JAX package's, and ten LM steps compound
    # that to up to 3 mm (2.4e-4 relative) on a point
    np.testing.assert_allclose(n(tres.points), n(jres.points), rtol=5e-4, atol=1e-3)
    assert float(tres.cost) == pytest.approx(float(jres.cost), rel=1e-2, abs=1e-4)
    fixed = f["cam_fixed"]
    np.testing.assert_array_equal(n(tres.poses)[fixed], f["poses"][fixed])
    np.testing.assert_array_equal(n(tres.points)[f["point_fixed"]],
                                  f["points"][f["point_fixed"]])
    # against the dense solve of local BA: both reach the same minimum
    dense = tba.bundle_adjust(tba.BAProblem(*(t(f[k]) for k in FIELDS)), BA_TCAM,
                              phase_iters=(5, 5), point_fixed=t(f["point_fixed"]))
    assert np.abs(camera_centres(n(dense.poses)) - camera_centres(n(tres.poses))).max() < 1e-2
