"""The multi-rank dry run at production scale: the port's twin of
``__graft_entry__.make_gba_problem`` and ``dryrun_multichip`` (a copy, since
that module imports jax).

1. distributed global BA: 256 keyframes, 16 384 points, 65 536 observations
   split over the ranks' observation axis (the reference's GBA at KITTI 00
   scale), 5 robust and 10 plain LM steps with 30 PCG iterations, held to
   the JAX dry run's gates: finite, inliers >= 95 %, cost at most twice the
   single-device solver's plus 1e-3;
2. the multi-session step: B sessions of 640x480, 2000 features, 4 levels
   on rank 0's card, through the step's program (on a card its first call
   captures the CUDA graph, the second replays it). The JAX step shards
   the sessions of one step over a mesh; the port runs a step on one card,
   and ranks are its sharding.

    python -m orbslam2_tpu_torch.parallel.dryrun --ranks 2 --backend gloo --device cpu
    python -m orbslam2_tpu_torch.parallel.dryrun --ranks 1 --backend nccl

(NCCL takes one GPU per rank; gloo puts several ranks on one card or on the
CPU.)
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from orbslam2_tpu_torch.backend import ba
from orbslam2_tpu_torch.backend.ba import BAProblem
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.parallel import mesh
from orbslam2_tpu_torch.parallel.dist_ba import distributed_bundle_adjust
from orbslam2_tpu_torch.parallel.multi_session import make_multi_camera_step

GBA_SIZE = (256, 16384, 65536)     # keyframes, points, observations
GBA_PHASES = (5, 10)
GBA_PCG_ITERS = 30
INLIER_MIN = 0.95
SESSION_CAM = PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                            width=640, height=480, bf=40.0)
SESSION_ORB = ORBConfig(n_features=2000, n_levels=4)
SESSION_CAP = 2048


def make_gba_problem_np(n_cams: int, n_pts: int, n_obs: int, seed: int = 0):
    """The synthetic global-BA problem (circular trajectory, banded
    visibility like a real sequence) as numpy arrays, drawn in the JAX
    dry run's order. -> (dict of BAProblem fields, cam)."""
    rng = np.random.default_rng(seed)
    cam = PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                        width=640, height=480, bf=40.0)
    pts = rng.uniform(-30, 30, (n_pts, 3)).astype(np.float32)
    pts[:, 1] = rng.uniform(-2, 2, n_pts)
    pts[:, 2] = rng.uniform(4, 40, n_pts)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    poses[:, 0, 3] = np.linspace(-5, 5, n_cams) + rng.uniform(-0.05, 0.05, n_cams)
    # banded incidence: each observation pairs a camera with a point of its
    # own depth-ordered window (KITTI-like visibility)
    obs_cam = rng.integers(0, n_cams, n_obs).astype(np.int32)
    band = max(n_pts // n_cams, 1)
    obs_pt = ((obs_cam.astype(np.int64) * band
               + rng.integers(0, 4 * band, n_obs)) % n_pts).astype(np.int32)
    pc = pts[obs_pt] + poses[obs_cam][:, :3, 3]
    z = np.maximum(pc[:, 2], 1.0)
    stereo = rng.random(n_obs) < 0.5
    ur = np.where(stereo, 520.0 * pc[:, 0] / z + 320.0 - cam.bf / z, -1.0)
    uv = np.stack([520.0 * pc[:, 0] / z + 320.0 + rng.normal(0, 0.5, n_obs),
                   520.0 * pc[:, 1] / z + 240.0 + rng.normal(0, 0.5, n_obs),
                   ur], axis=1).astype(np.float32)
    return dict(poses=poses, points=pts, cam_fixed=np.arange(n_cams) == 0,
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv,
                obs_inv_sigma2=np.ones((n_obs,), np.float32), obs_stereo=stereo,
                obs_valid=np.ones((n_obs,), bool)), cam


def problem_from_numpy(fields: dict, device, dtype=torch.float32) -> BAProblem:
    """numpy BAProblem fields -> tensors on ``device``, floating point in
    ``dtype`` (the solve's)."""
    def conv(name):
        a = np.asarray(fields[name])
        if a.dtype == bool:
            return torch.from_numpy(a.copy()).to(device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.astype(np.int64)).to(device)
        return torch.from_numpy(a.astype(np.float64)).to(device=device, dtype=dtype)
    return BAProblem(*(conv(f) for f in BAProblem._fields))


def make_gba_problem(n_cams: int, n_pts: int, n_obs: int, seed: int = 0,
                     device="cuda", dtype=torch.float32):
    """-> (BAProblem on ``device`` in ``dtype``, cam)."""
    fields, cam = make_gba_problem_np(n_cams, n_pts, n_obs, seed)
    return problem_from_numpy(fields, device, dtype), cam


def gba_gates(res, cost_single: float) -> dict:
    """The JAX dry run's gates on a distributed solve (a BAResult of tensors
    or of numpy arrays); raises on a miss. -> the numbers gated."""
    poses, points, inlier = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                             for x in (res.poses, res.points, res.inlier))
    finite = bool(np.isfinite(poses).all() and np.isfinite(points).all())
    inliers = float(inlier.astype(np.float64).mean())
    cost = float(res.cost)
    out = dict(finite=finite, inlier_share=inliers, cost=cost, cost_single=cost_single)
    if not finite:
        raise AssertionError(f"distributed GBA produced non-finite poses or points: {out}")
    if inliers < INLIER_MIN:
        raise AssertionError(f"distributed GBA kept {inliers:.4f} of the observations "
                             f"(< {INLIER_MIN}): {out}")
    if not (np.isfinite(cost) and cost <= 2.0 * cost_single + 1e-3):
        raise AssertionError(f"distributed cost {cost} against single-device {cost_single}")
    return out


def session_inputs(b: int, device, seed: int = 1, cap: int = SESSION_CAP):
    """Random images and local maps for ``b`` sessions at the dry run's
    640x480, as the JAX dry run draws them."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (b, 480, 640)).astype(np.float32)
    pt_pos = rng.uniform(-2, 2, (b, cap, 3)).astype(np.float32) + np.float32([0, 0, 5])
    pt_desc = rng.integers(0, 2 ** 32, (b, cap, 8), dtype=np.uint32).view(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(images), t(np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))), t(pt_pos),
            t(pt_desc), t(np.ones((b, cap), bool)),
            t(np.tile(np.float32([0.0, 0.0, -1.0]), (b, cap, 1))),
            t(np.full((b, cap), 0.5, np.float32)), t(np.full((b, cap), 50.0, np.float32)))


def save_problem(path: str, fields: dict, cam: PinholeCamera) -> None:
    """numpy BAProblem fields and their camera -> one npz file."""
    np.savez(path, **fields, **{f"camera_{k}": v for k, v in dataclasses.asdict(cam).items()})


def load_problem(path: str):
    """-> (numpy BAProblem fields, cam) of ``save_problem``'s file."""
    with np.load(path) as f:
        fields = {k: f[k] for k in f.files}
    cam = PinholeCamera(**{k[7:]: fields.pop(k).item() for k in list(fields)
                           if k.startswith("camera_")})
    return fields, cam


def solve_in_groups(rank: int, world_size: int, problem_paths, jobs, out_path: str,
                    device: str = "cpu", phase_iters=GBA_PHASES,
                    pcg_iters: int = GBA_PCG_ITERS, warm: bool = False) -> None:
    """One rank of a sweep over group sizes (run it through ``mesh.spawn``
    with gloo). ``jobs``: (problem index, dtype name, size) triples; for
    each, the first ``size`` ranks solve that problem (an npz of
    ``save_problem``) in that dtype as one group. Rank 0 writes every
    result into ``out_path`` (npz) under ``{problem}/{dtype}/{size}/{field}``,
    with the solve's seconds and whether the group staged its all-reduces
    through host memory. ``warm``: one LM step of each job before the timed
    solve (a group's first collectives and a dtype's first kernels set
    themselves up)."""
    problems = [load_problem(path) for path in problem_paths]
    groups, out = {}, {}
    for pi, dtype, size in jobs:
        if size not in groups:          # every rank makes every group, in one order
            groups[size] = mesh.make_group(range(size), backend="gloo", device=device)
        group = groups[size]
        if group is None:
            continue
        fields, cam = problems[pi]
        problem = problem_from_numpy(fields, device, getattr(torch, dtype))
        if warm:
            distributed_bundle_adjust(problem, cam, group, phase_iters=(1,), pcg_iters=1)
        t0 = time.perf_counter()
        res = distributed_bundle_adjust(problem, cam, group, phase_iters=phase_iters,
                                        pcg_iters=pcg_iters)
        res = [x.cpu().numpy() for x in res]
        seconds = time.perf_counter() - t0
        if rank == 0:
            key = f"{pi}/{dtype}/{size}"
            out.update({f"{key}/{name}": x for name, x in zip(ba.BAResult._fields, res)})
            out[f"{key}/seconds"] = np.float64(seconds)
            out[f"{key}/staged"] = np.bool_(group.staged)
    if rank == 0:
        np.savez(out_path, **out)


def session_worlds(cam: PinholeCamera, orb_cfg: ORBConfig, b: int, local_cap: int,
                   device="cuda"):
    """``b`` sessions with known geometry, as ``tests/test_multi_session.py``
    builds them: session s renders two frames of a lateral drive (seed s + 1);
    its local map is frame 0's keypoints back-projected with the rendered
    depth (frame 0's camera is the world), and the step tracks frame 1 from
    the identity. -> (the step's eight inputs on ``device``, [b, 4, 4] true
    Tcw of frame 1)."""
    from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam2_tpu_torch.ops.orb import get_extractor

    ex = get_extractor(orb_cfg, (cam.height, cam.width), device)
    pt_pos = np.zeros((b, local_cap, 3), np.float32)
    pt_desc = np.zeros((b, local_cap, 8), np.int32)
    pt_valid = np.zeros((b, local_cap), bool)
    pt_normal = np.zeros((b, local_cap, 3), np.float32)
    pt_min = np.zeros((b, local_cap), np.float32)
    pt_max = np.ones((b, local_cap), np.float32)
    images, gts = [], []
    for s in range(b):
        seq = SyntheticSequence(cam, n_frames=2, trajectory="lateral", seed=s + 1)
        g0, d0 = seq.render(0)
        g1, _ = seq.render(1)
        kp = ex(torch.from_numpy(np.ascontiguousarray(g0, np.float32)).to(ex.device))
        xy, v = kp.xy.cpu().numpy(), kp.valid.cpu().numpy()
        xi = np.clip(np.round(xy[:, 0]).astype(int), 0, cam.width - 1)
        yi = np.clip(np.round(xy[:, 1]).astype(int), 0, cam.height - 1)
        d = d0[yi, xi]
        good = np.where(v & (d > 0))[0][:local_cap]
        pc = np.stack([(xy[good, 0] - cam.cx) / cam.fx * d[good],
                       (xy[good, 1] - cam.cy) / cam.fy * d[good], d[good]], 1)
        n = len(good)
        pt_pos[s, :n] = pc
        pt_desc[s, :n] = kp.desc.cpu().numpy()[good]
        pt_valid[s, :n] = True
        pt_normal[s, :n] = pc / np.linalg.norm(pc, axis=1, keepdims=True)
        dist = np.linalg.norm(pc, axis=1)
        pt_min[s, :n] = dist * 0.2
        pt_max[s, :n] = dist * 3.0
        images.append(g1)
        gts.append(seq.poses[1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(ex.device)
    inputs = (t(np.stack(images).astype(np.float32)),
              t(np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))), t(pt_pos), t(pt_desc),
              t(pt_valid), t(pt_normal), t(pt_min), t(pt_max))
    return inputs, np.stack(gts)


def _dryrun_rank(rank: int, world_size: int, backend: str, device: str,
                 n_sessions: int) -> None:
    dev = torch.device(f"cuda:{rank}" if backend == "nccl" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = mesh.make_group(backend=backend, device=dev)
    n_cams, n_pts, n_obs = GBA_SIZE
    n_obs = n_obs // world_size * world_size
    problem, cam = make_gba_problem(n_cams, n_pts, n_obs, device=dev)
    t0 = time.perf_counter()
    res = distributed_bundle_adjust(problem, cam, group, phase_iters=GBA_PHASES,
                                    pcg_iters=GBA_PCG_ITERS)
    poses = res.poses.cpu()
    dist_s = time.perf_counter() - t0
    if rank:
        return
    t0 = time.perf_counter()
    single = ba.bundle_adjust_pcg(problem, cam, phase_iters=GBA_PHASES,
                                  pcg_iters=GBA_PCG_ITERS)
    single_cost = float(single.cost)
    single_s = time.perf_counter() - t0
    gates = gba_gates(res, single_cost)
    print(f"dryrun_multichip({world_size}, {backend}, {dev}): distributed GBA ok at "
          f"{n_cams} KF / {n_pts} pts / {n_obs} obs, cost {gates['cost']:.3f} "
          f"(single-device {single_cost:.3f}), inliers {gates['inlier_share']:.4f}, "
          f"{dist_s:.1f} s distributed, {single_s:.1f} s single; largest pose difference "
          f"{float((poses - single.poses.cpu()).abs().max()):.2e}", flush=True)
    step = make_multi_camera_step(SESSION_CAM, SESSION_ORB, SESSION_CAP, dev)
    inputs = session_inputs(n_sessions, dev)
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        tcw, n_in = step(*inputs)
        tcw = tcw.cpu()
        seconds.append(time.perf_counter() - t0)
    print(f"dryrun_multichip: {n_sessions} batched 640x480/{SESSION_ORB.n_features}-feature "
          f"sessions ok, tcw batch {tuple(tcw.shape)}, finite {bool(torch.isfinite(tcw).all())}, "
          f"{seconds[0]:.1f} s the first step, {seconds[1]:.3f} s the second; the program "
          f"captured {step.captures} graph(s), replayed {step.replays}", flush=True)


def dryrun_multichip(n_ranks: int, backend: str = "nccl", device: str = "cuda",
                     n_sessions: int = 8) -> None:
    """Spawn ``n_ranks`` processes and run both paths (see the module
    docstring); raises if a gate fails."""
    mesh.spawn(_dryrun_rank, n_ranks, backend, (backend, device, n_sessions))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=1)
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--sessions", type=int, default=8)
    a = p.parse_args()
    dryrun_multichip(a.ranks, a.backend, a.device, a.sessions)
