"""Distributed bundle adjustment over a process group.

Counterpart of ``orbslam2_tpu/parallel/dist_ba.py`` (``shard_map`` with
``psum`` over a device mesh). Decomposition as there:

- the observations (the O(10^5..10^6) axis) are split across the ranks,
  each rank solving on its contiguous slice (``mesh.ObsGroup.obs_slice``);
- camera poses and points are replicated (K x 6 and P x 3 numbers);
- every sum over observations — the Hessian blocks and gradients, the two
  segment sums of each Schur matvec in the conjugate gradient, the costs and
  the per-point counts of the ray-unconstrained freeze — is the rank's
  partial sum followed by ``all_reduce(SUM)``. Every rank then holds the same
  reduced system and runs the same steps on it, so nothing is broadcast.

The solve is the port's own ``backend/ba.py::bundle_adjust_pcg`` with that
reduction: the same robust LM schedule and the same float32 guards (the
freeze of points with fewer than two active observations and no stereo one,
the conjugate gradient's stopping rule on replicated state, the rejection of
non-finite steps, the retention of unjudged observations between phases). Its
conjugate gradient runs every step and masks those after convergence with
``torch.where``, so every rank makes the same collectives in the same order
and no step waits for the host, but for a gloo all-reduce of CUDA tensors
staged through host memory (``mesh.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from orbslam2_tpu_torch.backend import ba
from orbslam2_tpu_torch.backend.ba import BAProblem, BAResult
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.parallel.mesh import ObsGroup


def _local_slice(problem: BAProblem, group: ObsGroup) -> BAProblem:
    """The rank's share of the observation axis; poses and points whole."""
    sl = group.obs_slice(problem.obs_cam.shape[0])
    return problem._replace(
        obs_cam=problem.obs_cam[sl], obs_pt=problem.obs_pt[sl], obs_uv=problem.obs_uv[sl],
        obs_inv_sigma2=problem.obs_inv_sigma2[sl], obs_stereo=problem.obs_stereo[sl],
        obs_valid=problem.obs_valid[sl])


def distributed_bundle_adjust(
    problem: BAProblem,
    cam: PinholeCamera,
    group: ObsGroup,
    phase_iters: Tuple[int, ...] = (5, 10),
    point_fixed: Optional[torch.Tensor] = None,
    pcg_iters: int = 30,
    lam0: float = 1e-4,
) -> BAResult:
    """Robust-LM bundle adjustment with the observations split over
    ``group``; every rank of the group calls it with the same whole
    ``problem`` (on ``group.device``, its dtype the solve's) and solves on
    its slice. The number of observations must be a multiple of the group's
    size (pad with ``obs_valid=False`` rows).

    -> BAResult as ``ba.bundle_adjust_pcg`` gives it, the same on every
    rank: ``inlier`` over all the observations (gathered by one all-reduce),
    ``cost`` the group's total."""
    local = _local_slice(problem, group)
    res = ba.bundle_adjust_pcg(local, cam, phase_iters=phase_iters, point_fixed=point_fixed,
                               lam0=lam0, pcg_iters=pcg_iters, reduce=group.all_reduce)
    inlier = torch.zeros(problem.obs_cam.shape[0], dtype=torch.int32, device=group.device)
    inlier[group.obs_slice(inlier.shape[0])] = res.inlier.to(torch.int32)
    return res._replace(inlier=group.all_reduce(inlier) > 0)
