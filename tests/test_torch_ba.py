"""Local bundle adjustment of the port (dense Schur LM) against the JAX
package's, on the CPU.

Seeded problems of tests/test_ba.py's kind (cameras on an arc looking at a
point cloud) go through both packages' ``bundle_adjust``: clean, noisy with
outliers, mixed stereo rows, extra fixed cameras, fixed points, a point
with one observation, masked observations. Every case has the same padded
shape (8 cameras, 128 points, 1024 observations, as the mapper pads
problems) and passes ``point_fixed``, so JAX compiles one program.

The solve's parts (reset, prologue, LM step, epilogue), which the solve
programs capture as CUDA graphs, read no tensor on the host and, run in a
program's order on the CPU, give the eager solve bit for bit; a program on
the CPU is the eager solve, and its key follows the padded sizes.

Tolerances: poses within 1e-4 and points within 1e-4 + 1e-5 of their value
(they lie 8-16 m away; float32 sums run in another order and LM steps
compound the difference);
inlier masks equal wherever an observation's final chi-square lies outside
+-1 % of its limit; the final cost within 1e-3 relative (1e-5 absolute for
the clean case, whose cost is float32 round-off).
"""
import jax
import numpy as np
import pytest
import torch

from orbslam2_tpu.backend import ba as jba
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu_torch.backend import ba as tba
from orbslam2_tpu_torch.backend import solve_program
from orbslam2_tpu_torch.frontend.local_mapping import size_bucket
from orbslam2_tpu_torch.geometry import se3 as tse3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera

from torch_port_helpers import j, n, no_host_reads, t

CAM_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0)
JCAM, TCAM = JCamera(**CAM_KW), TCamera(**CAM_KW)
K_CAP, P_CAP, O_CAP = 8, 128, 1024
N_CAMS, N_PTS = 6, 120


def make_problem(seed, noise=0.3, outlier_frac=0.0, stereo_frac=0.0,
                 extra_fixed=0, n_fixed_pts=0, lone_point=False, n_masked=0):
    """-> dict of numpy BAProblem fields (padded) + point_fixed."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(N_PTS, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(8.0, 16.0, size=N_PTS)
    xi = np.array([[0.4 * i, 0.02 * i, 0.0, 0.0, 0.03 * i, 0.0] for i in range(N_CAMS)],
                  np.float32)
    poses_true = n(tse3.exp(t(xi)))
    cam_fixed = np.zeros(K_CAP, bool)
    cam_fixed[[0, 1]] = True
    cam_fixed[2:2 + extra_fixed] = True
    cam_fixed[N_CAMS:] = True                      # padding
    poses0 = np.tile(np.eye(4, dtype=np.float32), (K_CAP, 1, 1))
    poses0[:N_CAMS] = poses_true
    pert = (rng.normal(size=(N_CAMS, 6)) * 0.02).astype(np.float32)
    moved = n(tse3.retract(t(poses_true), t(pert)))
    poses0[:N_CAMS][~cam_fixed[:N_CAMS]] = moved[~cam_fixed[:N_CAMS]]

    cams, pids = np.meshgrid(np.arange(N_CAMS), np.arange(N_PTS), indexing="ij")
    cams, pids = cams.reshape(-1), pids.reshape(-1)
    pc = np.einsum("oij,oj->oi", poses_true[cams, :3, :3], pts[pids]) + poses_true[cams, :3, 3]
    u = CAM_KW["fx"] * pc[:, 0] / pc[:, 2] + CAM_KW["cx"]
    v = CAM_KW["fy"] * pc[:, 1] / pc[:, 2] + CAM_KW["cy"]
    uv = np.stack([u, v, u - CAM_KW["bf"] / pc[:, 2]], -1).astype(np.float32)
    uv[:, :2] += (rng.normal(size=(len(cams), 2)) * noise).astype(np.float32)
    n_out = int(len(cams) * outlier_frac)
    if n_out:
        idx = rng.choice(len(cams), n_out, replace=False)
        uv[idx, :2] += rng.uniform(25, 60, size=(n_out, 2)).astype(np.float32)
    stereo = rng.uniform(size=len(cams)) < stereo_frac
    valid = np.ones(len(cams), bool)
    if lone_point:                                  # point 0: one mono observation
        valid[(pids == 0) & (cams > 0)] = False
        stereo[pids == 0] = False
    if n_masked:
        valid[rng.choice(len(cams), n_masked, replace=False)] = False
    uv[~stereo, 2] = -1.0

    o = len(cams)
    pad = lambda a, fill: np.concatenate([a, np.full((O_CAP - o,) + a.shape[1:], fill, a.dtype)])
    points0 = np.zeros((P_CAP, 3), np.float32)
    points0[:N_PTS] = pts + (rng.normal(size=pts.shape) * 0.05).astype(np.float32)
    pt_fixed = np.zeros(P_CAP, bool)
    pt_fixed[N_PTS:] = True
    pt_fixed[1:1 + n_fixed_pts] = True
    octave = rng.integers(0, 4, o)
    return dict(poses=poses0, points=points0, cam_fixed=cam_fixed,
                obs_cam=pad(cams.astype(np.int32), 0), obs_pt=pad(pids.astype(np.int32), 0),
                obs_uv=pad(uv, 0.0),
                obs_inv_sigma2=pad((1.0 / 1.2 ** (2 * octave)).astype(np.float32), 1.0),
                obs_stereo=pad(stereo, False), obs_valid=pad(valid, False),
                point_fixed=pt_fixed)


CASES = {
    "clean": dict(noise=0.0),
    "noisy_outliers": dict(noise=0.5, outlier_frac=0.1),
    "stereo_rows": dict(noise=0.3, stereo_frac=0.5, outlier_frac=0.05),
    "fixed_cameras": dict(noise=0.3, extra_fixed=2),
    "fixed_points": dict(noise=0.3, n_fixed_pts=10),
    "under_constrained_point": dict(noise=0.3, lone_point=True),
    "masked_observations": dict(noise=0.3, n_masked=100),
}
FIELDS = ("poses", "points", "cam_fixed", "obs_cam", "obs_pt", "obs_uv",
          "obs_inv_sigma2", "obs_stereo", "obs_valid")


@pytest.fixture(scope="module")
def jax_bundle_adjust():
    return jax.jit(jba.bundle_adjust, static_argnames=("cam", "phase_iters"))


def _chi2(fields, poses, points):
    """Final chi-square of every observation, numpy."""
    cams, pids = fields["obs_cam"], fields["obs_pt"]
    pc = np.einsum("oij,oj->oi", poses[cams, :3, :3], points[pids]) + poses[cams, :3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    u = CAM_KW["fx"] * pc[:, 0] / z + CAM_KW["cx"]
    v = CAM_KW["fy"] * pc[:, 1] / z + CAM_KW["cy"]
    e = np.stack([fields["obs_uv"][:, 0] - u, fields["obs_uv"][:, 1] - v,
                  np.where(fields["obs_stereo"], fields["obs_uv"][:, 2] - (u - CAM_KW["bf"] / z),
                           0.0)], -1)
    return (e * e).sum(-1) * fields["obs_inv_sigma2"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bundle_adjust_matches_jax(case, jax_bundle_adjust):
    f = make_problem(sorted(CASES).index(case), **CASES[case])
    jres = jax_bundle_adjust(jba.BAProblem(*(j(f[k]) for k in FIELDS)), JCAM,
                             point_fixed=j(f["point_fixed"]))
    tres = tba.bundle_adjust(tba.BAProblem(*(t(f[k]) for k in FIELDS)), TCAM,
                             point_fixed=t(f["point_fixed"]))
    np.testing.assert_allclose(n(tres.poses), n(jres.poses), atol=1e-4)
    np.testing.assert_allclose(n(tres.points), n(jres.points), rtol=1e-5, atol=1e-4)
    assert float(tres.cost) == pytest.approx(float(jres.cost), rel=1e-3, abs=1e-5)
    valid = f["obs_valid"]
    chi2 = _chi2(f, n(jres.poses), n(jres.points))
    th = np.where(f["obs_stereo"], jba.CHI2_STEREO, jba.CHI2_MONO)
    clear = valid & (np.abs(chi2 - th) > 0.01 * th)
    np.testing.assert_array_equal(n(tres.inlier)[clear], n(jres.inlier)[clear])
    assert not n(tres.inlier)[~valid].any()
    # the gauge and the fixed points do not move
    fixed = f["cam_fixed"]
    np.testing.assert_array_equal(n(tres.poses)[fixed], f["poses"][fixed])
    np.testing.assert_array_equal(n(tres.points)[f["point_fixed"]],
                                  f["points"][f["point_fixed"]])
    if case == "clean":
        assert n(tres.inlier)[valid].all()
    if case == "under_constrained_point":
        # its lone observation keeps its status (unjudged), the point stays
        lone = valid & (f["obs_pt"] == 0)
        assert lone.sum() == 1 and n(tres.inlier)[lone].all()
        np.testing.assert_array_equal(n(tres.points)[0], f["points"][0])


@pytest.mark.parametrize("seed", [0, 1])
def test_closed_form_inverses_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(64, 6, 6)).astype(np.float32)
    spd = (a @ a.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)).astype(np.float32)
    np.testing.assert_allclose(n(tba._inv6x6_spd(t(spd))), n(jba._inv6x6_spd(j(spd))),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(n(tba._inv6x6_spd(t(spd))) @ spd,
                               np.broadcast_to(np.eye(6), spd.shape), atol=1e-4)
    m3 = spd[:, :3, :3]
    np.testing.assert_allclose(n(tba._inv3x3(t(m3))), n(jba._inv3x3(j(m3))),
                               rtol=1e-5, atol=1e-7)



# ----------------------------------------------------------------------
# The solve programs' parts (CUDA graphs on a card) on the CPU
# ----------------------------------------------------------------------
SOLVES = {"local_ba": (False, tba.bundle_adjust, dict(phase_iters=(5, 10))),
          "gba": (True, tba.bundle_adjust_pcg, dict(phase_iters=(5, 5)))}


def float64_problem(case="noisy_outliers"):
    """-> (the case's problem in float64, its point_fixed), torch."""
    f = make_problem(sorted(CASES).index(case), **CASES[case])
    as64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in f.items()}
    return tba.BAProblem(*(t(as64[k]) for k in FIELDS)), t(f["point_fixed"])


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_solve_program_parts_read_nothing_on_the_host(solve):
    """The parts a program captures, run eagerly in its replay order under
    the host-read guard (no `if` on a tensor, no `item`), give the eager
    solve bit for bit."""
    pcg, eager, kw = SOLVES[solve]
    problem, fixed = float64_problem()
    program = solve_program.BundleAdjustProgram("cpu", pcg=pcg)
    a = solve_program._bind(solve_program._BA_SIGNATURES[pcg], (problem, TCAM),
                            dict(point_fixed=fixed, **kw))
    parts, schedule, outputs = program._build([x.clone() for x in program._flat(a)], a)
    iters = kw["phase_iters"]
    assert schedule.count("step_huber") == iters[0] and schedule.count("step_plain") == iters[1]
    assert len(parts) == 6 and schedule[0] == "reset"
    with no_host_reads():
        for name in schedule:
            parts[name]()
    want = eager(problem, TCAM, point_fixed=fixed, **kw)
    for got, ref in zip(outputs, want):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_bundle_adjust_program_on_the_cpu_is_the_eager_solve(solve):
    pcg, eager, kw = SOLVES[solve]
    problem, fixed = float64_problem("stereo_rows")
    program = solve_program.BundleAdjustProgram("cpu", pcg=pcg)
    got = program(problem, TCAM, point_fixed=fixed, **kw)
    want = eager(problem, TCAM, point_fixed=fixed, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (program.captures, program.replays, program.graph_launches) == (0, 0, 0)


def pad_observations(problem, size):
    """The observation rows padded to `size` as the loop closer pads a
    global BA (camera 0, point 0, invalid)."""
    o = problem.obs_cam.shape[0]

    def pad(x, fill):
        return torch.cat([x, torch.full((size - o,) + x.shape[1:], fill, dtype=x.dtype)])

    return problem._replace(obs_cam=pad(problem.obs_cam, 0), obs_pt=pad(problem.obs_pt, 0),
                            obs_uv=pad(problem.obs_uv, 0.0),
                            obs_inv_sigma2=pad(problem.obs_inv_sigma2, 1.0),
                            obs_stereo=pad(problem.obs_stereo, False),
                            obs_valid=pad(problem.obs_valid, False))


def test_program_keys_follow_the_size_buckets():
    """Two observation counts in one bucket stage one shape and give one
    key, so the second solve replays the first one's graphs; a count in the
    next bucket gives another key; so do other settings."""
    problem, fixed = float64_problem()
    o = problem.obs_cam.shape[0]
    sized = [pad_observations(problem, size_bucket(o + extra, 2048, 4))
             for extra in (100, 1000, 1100)]
    assert [p.obs_cam.shape[0] for p in sized] == [2048, 2048, 8192]
    for pcg in (False, True):
        program = solve_program.BundleAdjustProgram("cpu", pcg=pcg)
        keys = [program.key(p, TCAM, point_fixed=fixed) for p in sized]
        assert keys[0] == keys[1] != keys[2]
        assert program.key(sized[0], TCAM, point_fixed=None) == keys[0]
        assert program.key(sized[0], TCAM, phase_iters=(5, 5), point_fixed=fixed) != keys[0]
        as32 = sized[0]._replace(poses=sized[0].poses.float(), points=sized[0].points.float())
        assert program.key(as32, TCAM, point_fixed=fixed) != keys[0]
