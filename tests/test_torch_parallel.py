"""The port's parallel paths against the JAX package's, on the CPU.

- ``parallel/dist_ba.py::distributed_bundle_adjust`` on ``test_ba.py``'s
  problems, padded as ``test_dist_ba.py`` pads them: groups of 1, 2 and 4
  ranks of one gloo spawn of four processes (subgroups of one world), held
  to the JAX ``distributed_bundle_adjust`` on its 8-device virtual mesh, to
  the port's single-device ``bundle_adjust_pcg``, to the truth, and to each
  other (``test_dist_ba.py``'s mesh invariance);
- ``parallel/multi_session.py::make_multi_camera_step`` at
  ``test_multi_session.py``'s 160x120, 300 features, 2 levels, B = 8, held
  to the JAX step on the same numpy inputs and, exactly, to the port's
  single-session step; its parts on the session axis (frustum check,
  windowed match and conflict resolution, pose LM) each held, exactly, to
  the same part for one session, and ``utils/fixed_order.py`` to the
  library's arithmetic.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as h
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.parallel import dist_ba as jdist_ba
from orbslam2_tpu.parallel.mesh import make_mesh
from orbslam2_tpu.parallel.multi_session import make_multi_camera_step as jmake_step
from orbslam2_tpu_torch.backend import ba, pose_opt
from orbslam2_tpu_torch.frontend import kernels
from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops import match
from orbslam2_tpu_torch.ops.orb import ORBConfig, ORBExtractor, Keypoints
from orbslam2_tpu_torch.parallel import dryrun, mesh
from orbslam2_tpu_torch.parallel.multi_session import (MAX_HAMMING, make_multi_camera_step,
                                                       make_single_camera_step)
from orbslam2_tpu_torch.utils import fixed_order
from test_ba import make_ba_problem, pose_errors
from test_dist_ba import pad_obs_to

CAM = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0)
SIZES = (1, 2, 4)
# (problem, dtype, group size) solved by the spawn: problem 0 clean, 1 with
# outliers. Every CG step makes two all-reduces, so a solve by four ranks
# takes seconds here; the float64 and outlier checks take the sizes below.
F64_SIZES = (1, 2)
OUTLIER_SIZES = (2,)
JOBS = ([(0, "float32", s) for s in SIZES] + [(0, "float64", s) for s in F64_SIZES]
        + [(1, "float32", s) for s in OUTLIER_SIZES])
PCG_ITERS = 40                 # test_dist_ba.py's
# port against JAX, both float32: the sums run in other orders (rank slices,
# index_add_ against segment sums), so poses differ by float32 rounding
# carried through 15 LM steps
JAX_POSE_ATOL = 1e-4
MESH_POSE_ATOL = 1e-4          # test_dist_ba.py's mesh invariance
F64_CENTRE_TOL_M = 1e-6        # chip_smoke.py phases 6 and 11
POSE_ERR_MAX = 0.02            # test_dist_ba.py's
OUTLIER_KEPT_MAX = 0.1         # test_dist_ba.py's


def _fields(problem) -> dict:
    return {name: np.asarray(getattr(problem, name)) for name in problem._fields}


@pytest.fixture(scope="module")
def problems():
    """test_dist_ba.py's two problems: clean, and with 10 % outliers."""
    clean, truth, _, _ = make_ba_problem(np.random.default_rng(42), noise=0.3)
    noisy, truth_o, _, out_mask = make_ba_problem(np.random.default_rng(42), noise=0.3,
                                                  outlier_frac=0.1)
    return dict(clean=(pad_obs_to(clean, 8), truth), outliers=(pad_obs_to(noisy, 8), truth_o),
                out_mask=out_mask)


@pytest.fixture(scope="module")
def solved(problems, tmp_path_factory):
    """One gloo spawn of four ranks solving ``JOBS``, and beside it the JAX
    package's distributed solve of the clean problem on its 8-device mesh."""
    d = tmp_path_factory.mktemp("dist_ba")
    paths = []
    for name in ("clean", "outliers"):
        path = str(d / f"{name}.npz")
        dryrun.save_problem(path, _fields(problems[name][0]), CAM)
        paths.append(path)
    out = str(d / "results.npz")
    from test_ba import CAM as JCAM
    _, res = h.beside(
        lambda: mesh.spawn(dryrun.solve_in_groups, 4, "gloo",
                           (paths, JOBS, out, "cpu", (5, 10), PCG_ITERS)),
        lambda: jdist_ba.distributed_bundle_adjust(problems["clean"][0], JCAM, make_mesh(8),
                                                   pcg_iters=PCG_ITERS))
    with np.load(out) as f:
        sweep = {k: f[k] for k in f.files}
    return sweep, {name: np.asarray(getattr(res, name)) for name in res._fields}


@pytest.fixture(scope="module")
def sweep(solved):
    return solved[0]


@pytest.fixture(scope="module")
def jax_clean(solved):
    return solved[1]


@pytest.mark.parametrize("size", SIZES)
def test_matches_jax_distributed(sweep, jax_clean, problems, size):
    poses = sweep[f"0/float32/{size}/poses"]
    np.testing.assert_allclose(poses, jax_clean["poses"], atol=JAX_POSE_ATOL)
    np.testing.assert_array_equal(sweep[f"0/float32/{size}/inlier"], jax_clean["inlier"])
    np.testing.assert_allclose(sweep[f"0/float32/{size}/cost"], jax_clean["cost"], rtol=1e-4)
    assert pose_errors(poses, problems["clean"][1]).max() < POSE_ERR_MAX


@pytest.fixture(scope="module")
def single(problems):
    """The port's single-device bundle_adjust_pcg on the clean problem."""
    fields = _fields(problems["clean"][0])
    return {dtype: ba.bundle_adjust_pcg(dryrun.problem_from_numpy(
        fields, "cpu", getattr(torch, dtype)), CAM, pcg_iters=PCG_ITERS)
        for dtype in ("float32", "float64")}


@pytest.mark.parametrize("size", SIZES)
def test_matches_single_device_pcg(sweep, single, size):
    """float64: the group's solve is the single-device solve up to the order
    of the sums (camera centres within phase 11's 1e-6 m); float32 within
    the mesh tolerance."""
    for dtype in ("float64", "float32"):
        if f"0/{dtype}/{size}/poses" not in sweep:
            continue
        poses = sweep[f"0/{dtype}/{size}/poses"]
        if dtype == "float64":
            diff = np.abs(h.camera_centres(poses) - h.camera_centres(single[dtype].poses)).max()
            assert diff < F64_CENTRE_TOL_M, diff
        else:
            np.testing.assert_allclose(poses, single[dtype].poses.numpy(), atol=MESH_POSE_ATOL)
        np.testing.assert_array_equal(sweep[f"0/{dtype}/{size}/inlier"],
                                      single[dtype].inlier.numpy())


@pytest.mark.parametrize("dtype,sizes", [("float32", SIZES), ("float64", F64_SIZES)])
def test_group_size_invariance(sweep, dtype, sizes):
    ref = sweep[f"0/{dtype}/1/poses"]
    for size in sizes[1:]:
        np.testing.assert_allclose(sweep[f"0/{dtype}/{size}/poses"], ref, atol=MESH_POSE_ATOL)


@pytest.mark.parametrize("size", OUTLIER_SIZES)
def test_outlier_rejection(sweep, problems, size):
    n_obs = len(problems["out_mask"])
    inl = sweep[f"1/float32/{size}/inlier"][:n_obs]
    assert inl[problems["out_mask"]].mean() < OUTLIER_KEPT_MAX
    assert pose_errors(sweep[f"1/float32/{size}/poses"], problems["outliers"][1]).max() \
        < POSE_ERR_MAX


def test_group_errors():
    """No backend is picked for the caller: NCCL on the CPU raises."""
    mesh.init(0, 1, "gloo", mesh.free_port())
    try:
        with pytest.raises(ValueError, match="NCCL"):
            mesh.make_group(backend="nccl", device="cpu")
        group = mesh.make_group(backend="gloo", device="cpu")
        assert group.size == 1 and not group.staged
        assert group.obs_slice(10) == slice(0, 10)
        t = torch.arange(3.0)
        assert group.all_reduce(t) is t and torch.equal(t, torch.arange(3.0))
        with pytest.raises(ValueError, match="tensor on"):
            group.all_reduce(torch.zeros(2, device="meta"))
        # the path through host memory (taken where gloo refuses CUDA tensors)
        staged = mesh.ObsGroup(group.group, "gloo", torch.device("cpu"), staged=True)
        t = torch.arange(6.0).reshape(2, 3)
        assert staged.all_reduce(t) is t and torch.equal(t, torch.arange(6.0).reshape(2, 3))
    finally:
        torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------
# multi-session tracking
# --------------------------------------------------------------------------
SESSION_CAM = PinholeCamera(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120,
                            bf=13.0)
SESSION_ORB = ORBConfig(n_features=300, n_levels=2)
KP_FIELDS = tuple(f.name for f in dataclasses.fields(Keypoints))
LOCAL_CAP = 512
B = 8
SESSION_POSE_ERR_MAX = 0.05    # test_multi_session.py's
SESSION_INLIERS_MIN = 30       # test_multi_session.py's
# port against JAX poses: the two extract the same keypoints (test_torch_orb.py), and the
# pose LMs differ by float32 rounding
JAX_SESSION_ATOL = 1e-3


@pytest.fixture(scope="module")
def sessions():
    inputs, gts = dryrun.session_worlds(SESSION_CAM, SESSION_ORB, B, LOCAL_CAP, "cpu")
    step = make_multi_camera_step(SESSION_CAM, SESSION_ORB, LOCAL_CAP, "cpu")
    return inputs, gts, step(*inputs)


def test_batched_step_tracks_every_session(sessions):
    inputs, gts, (tcw, n_in) = sessions
    assert tcw.shape == (B, 4, 4) and n_in.shape == (B,)
    assert (n_in > SESSION_INLIERS_MIN).all(), n_in
    for s in range(B):
        err = float(torch.linalg.norm(se3.log(se3.compose(
            tcw[s], se3.inverse(torch.from_numpy(gts[s]).float())))))
        assert err < SESSION_POSE_ERR_MAX, (s, err)


def test_batched_step_equals_single_sessions(sessions):
    inputs, _, (tcw, n_in) = sessions
    single = make_single_camera_step(SESSION_CAM, SESSION_ORB, LOCAL_CAP, "cpu")
    for s in range(B):
        tcw_s, n_s = single(*(x[s] for x in inputs))
        assert torch.equal(tcw_s, tcw[s]) and int(n_s) == int(n_in[s]), s


def test_batched_step_matches_jax(sessions):
    inputs, _, (tcw, n_in) = sessions
    jcam = JCamera(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120, bf=13.0)
    # one device: the sessions vmapped there (the JAX step's result does not
    # depend on the mesh; its compile is shorter)
    jstep = jmake_step(jcam, JORBConfig(n_features=300, n_levels=2), LOCAL_CAP, make_mesh(1))
    np_in = [h.n(x) for x in inputs]
    np_in[3] = np_in[3].view(np.uint32)
    jtcw, jn_in = jstep(*(jnp.asarray(x) for x in np_in))
    np.testing.assert_allclose(tcw.numpy(), np.asarray(jtcw), atol=JAX_SESSION_ATOL)
    np.testing.assert_array_equal(n_in.numpy(), np.asarray(jn_in))


# --------------------------------------------------------------------------
# the batched step's parts on a session axis
# --------------------------------------------------------------------------
def _session(x, s):
    """Session s of a batched Keypoints, PoseObs or tensor, without the axis."""
    if isinstance(x, Keypoints):
        return Keypoints(**{f: getattr(x, f)[s] for f in KP_FIELDS})
    if isinstance(x, pose_opt.PoseObs):
        return pose_opt.PoseObs(*(f[s] for f in x))
    return x[s]


def _sessions_at(x, idx):
    """Sessions ``idx`` (a list) of a batched Keypoints, PoseObs or tensor."""
    if isinstance(x, Keypoints):
        return Keypoints(**{f: getattr(x, f)[idx] for f in KP_FIELDS})
    if isinstance(x, pose_opt.PoseObs):
        return pose_opt.PoseObs(*(f[idx] for f in x))
    return x[idx]


@pytest.fixture(scope="module")
def session_parts(sessions):
    """The batched step's intermediate values on the fixture's worlds: the
    sessions' keypoints, frustum infos, the search's arguments and the pose
    LM's observations, as ``MultiSessionProgram.run`` makes them."""
    inputs, _, _ = sessions
    images, tcw0, pt_pos, pt_desc, pt_valid, pt_normal, pt_min, pt_max = inputs
    ex = ORBExtractor(SESSION_ORB, (SESSION_CAM.height, SESSION_CAM.width), "cpu")
    kp = Keypoints.stack([k for k, _ in ex.extract_batch_with_pyramid(images)])
    sf, nl = SESSION_ORB.scale_factor, SESSION_ORB.n_levels
    info = kernels.frustum_check(tcw0, pt_pos, pt_valid, pt_normal, pt_min, pt_max,
                                 SESSION_CAM, sf, nl)
    radius = torch.where(info.view_cos > 0.998, 2.5, 4.0) * sf ** info.pred_level.float()
    search = (info.uv, pt_desc, info.visible, radius,
              torch.clamp(info.pred_level - 1, min=0), info.pred_level, kp)
    res = match.windowed_match(*search, max_dist=MAX_HAMMING, ratio=0.8)
    pos = torch.take_along_dim(pt_pos, res.assoc.clamp(0, LOCAL_CAP - 1)[..., None], dim=-2)
    obs = kernels.build_pose_obs_from_frame(kp, torch.full(kp.valid.shape, -1.0), pos,
                                            res.assoc >= 0, sf)
    return dict(inputs=inputs, kp=kp, info=info, search=search, res=res, obs=obs)


def test_batched_frustum_check_equals_each_session_alone(session_parts):
    """frustum_check on the session axis: each session's values are its own
    at B = 1 bit for bit (fixed-order sums), within float32 rounding of the
    one-pose form (the library's sums), with the same visible points."""
    p = session_parts
    tcw0, pt_pos, pt_valid, pt_normal, pt_min, pt_max = (p["inputs"][i] for i in (1, 2, 4, 5, 6, 7))
    sf, nl = SESSION_ORB.scale_factor, SESSION_ORB.n_levels
    for s in range(B):
        one = kernels.frustum_check(*(x[s:s + 1] for x in (tcw0, pt_pos, pt_valid, pt_normal,
                                                           pt_min, pt_max)), SESSION_CAM, sf, nl)
        for name, a, b in zip(one._fields, one, p["info"]):
            assert torch.equal(a[0], b[s]), (s, name)
        alone = kernels.frustum_check(*(x[s] for x in (tcw0, pt_pos, pt_valid, pt_normal,
                                                       pt_min, pt_max)), SESSION_CAM, sf, nl)
        np.testing.assert_allclose(alone.uv.numpy(), p["info"].uv[s].numpy(), atol=1e-3)
        assert torch.equal(alone.visible, p["info"].visible[s]), s


@pytest.mark.parametrize("order", ["fixture", "collide"])
def test_batched_windowed_match_equals_each_session_alone(session_parts, order):
    """windowed_match (with resolve_conflicts) on the session axis gives
    each session's matches as the one-session call does, integer for
    integer. "collide" stacks session 0 twice before the rest, so every
    keypoint index of the first two sessions is claimed in both: a table
    shared across sessions would hand each keypoint to one session only."""
    p = session_parts
    idx = list(range(B)) if order == "fixture" else [0, 0] + list(range(1, B))
    search = [_sessions_at(x, idx) for x in p["search"]]
    res = match.windowed_match(*search, max_dist=MAX_HAMMING, ratio=0.8)
    if order == "collide":
        both = (res.best_kp[0] >= 0) & (res.best_kp[0] == res.best_kp[1])
        assert int(both.sum()) > SESSION_INLIERS_MIN
    for s, src in enumerate(idx):
        alone = match.windowed_match(*(_session(x, src) for x in p["search"]),
                                     max_dist=MAX_HAMMING, ratio=0.8)
        for name, a, b in zip(alone._fields, alone, res):
            assert torch.equal(a, b[s]), (order, s, name)
    assigned = match.resolve_conflicts(res.best_kp, res.best_dist, search[-1].n)
    for s, src in enumerate(idx):
        assert torch.equal(assigned[s], match.resolve_conflicts(
            res.best_kp[s], res.best_dist[s], search[-1].n)), (order, s)


def test_batched_pose_lm_equals_each_session_alone(session_parts):
    """The pose LM on the session axis: each session's pose, inliers and
    count are its own at B = 1 bit for bit, with its own damping and
    convergence flag; against the one-pose form (the library's sums and
    solve) within float32 rounding and with the same inlier count."""
    p = session_parts
    tcw0, obs = p["inputs"][1], p["obs"]
    tcw, inlier, n_in = pose_opt.pose_optimization(tcw0, obs, SESSION_CAM)
    assert tcw.shape == (B, 4, 4) and inlier.shape == obs.valid.shape and n_in.shape == (B,)
    for s in range(B):
        one = pose_opt.pose_optimization(tcw0[s:s + 1], _sessions_at(obs, [s]), SESSION_CAM)
        assert torch.equal(one[0][0], tcw[s]) and torch.equal(one[1][0], inlier[s]), s
        assert int(one[2][0]) == int(n_in[s]), s
        alone = pose_opt.pose_optimization(tcw0[s], _session(obs, s), SESSION_CAM)
        np.testing.assert_allclose(alone[0].numpy(), tcw[s].numpy(), atol=JAX_SESSION_ATOL)
        assert int(alone[2]) == int(n_in[s]), s
    with pytest.raises(ValueError, match="session axis"):
        pose_opt.pose_optimization(tcw0, obs, SESSION_CAM, stop_early=True)


def test_batched_step_reads_nothing_on_the_host(sessions):
    """The program's step under a guard that refuses every host read of a
    tensor (a CUDA graph's capture refuses them): it passes and gives the
    fixture's outputs; on the CPU a call of the program is that step, with
    no graph captured."""
    inputs, _, (tcw, n_in) = sessions
    step = make_multi_camera_step(SESSION_CAM, SESSION_ORB, LOCAL_CAP, "cpu")
    with h.no_host_reads():
        out = step.run(*inputs)
    assert torch.equal(out[0], tcw) and torch.equal(out[1], n_in)
    again = step(*inputs)
    assert torch.equal(again[0], tcw) and torch.equal(again[1], n_in)
    assert step.captures == 0 and step.replays == 0


FIXED_ORDER_CASES = {
    "dot": (lambda r: (r(5, 7, 3), r(5, 7, 3)), fixed_order.dot,
            lambda a, b: torch.sum(a * b, dim=-1)),
    "tree_sum": (lambda r: (r(5, 300, 6),), lambda x: fixed_order.tree_sum(x, -2),
                 lambda x: torch.sum(x, dim=-2)),
    "matmul": (lambda r: (r(5, 6, 3), r(5, 3, 6)), fixed_order.matmul, torch.matmul),
    "apply": (lambda r: (se3.exp(0.3 * r(5, 6)), r(5, 40, 3)), fixed_order.apply,
              lambda t, p: torch.stack([se3.apply(t[i], p[i]) for i in range(len(t))])),
    "camera_center": (lambda r: (se3.exp(0.3 * r(5, 6)),), fixed_order.camera_center,
                      se3.camera_center),
    "exp": (lambda r: (0.3 * r(5, 6),), fixed_order.exp, se3.exp),
    "solve": (lambda r: (_spd(r(5, 6, 9)), r(5, 6)), fixed_order.solve,
              lambda a, b: torch.linalg.solve(a, b)),
}


def _spd(m):
    return m @ m.transpose(-1, -2) + 0.1 * torch.eye(m.shape[-2])


@pytest.mark.parametrize("name", sorted(FIXED_ORDER_CASES))
def test_fixed_order_is_the_same_at_any_batch(name):
    """Each fixed_order function: a batch element's result is its own at
    B = 1 bit for bit, and within float32 rounding of the library's."""
    make, fn, library = FIXED_ORDER_CASES[name]
    gen = torch.Generator().manual_seed(7)
    args = make(lambda *shape: torch.randn(*shape, generator=gen))
    out = fn(*args)
    np.testing.assert_allclose(out.numpy(), library(*args).numpy(), rtol=1e-4, atol=1e-4)
    for i in range(len(args[0])):
        assert torch.equal(fn(*(a[i:i + 1] for a in args))[0], out[i]), (name, i)
