"""Pose-only optimization: robust Levenberg-Marquardt on one SE(3).

Counterpart of ``orbslam2_tpu/backend/pose_opt.py`` (which replaces the
reference's Optimizer::PoseOptimization): residuals and analytic Jacobians
for all N observations at once, a 6x6 normal-equation solve, 4 rounds x up to
10 LM iterations with chi-square inlier reclassification between rounds, the
Huber kernel dropped after the second round.

Conventions:
- residual e = observed - projected (2D mono, 3D stereo with virtual right u)
- information = invSigma2(octave) * I
- chi2 thresholds 5.991 (mono) / 7.815 (stereo)
- left-multiplicative twist update exp(xi) * Tcw

The LM round stops early where reading its convergence flag from the host is
free (CPU tensors, or a card's stream that is not capturing a CUDA graph);
otherwise it runs all its steps with the flag carried on the device and the
pose, damping and cost frozen once it is set, as the JAX package's
``lax.while_loop`` computes them. Both forms give the same result bit for
bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObs(NamedTuple):
    """Batched unary observations of one frame (fixed capacity, masked)."""
    pts_w: torch.Tensor       # [N, 3] world points
    uv: torch.Tensor          # [N, 3] observed (u, v, uR); uR < 0 => mono
    inv_sigma2: torch.Tensor  # [N] per-octave information scale
    is_stereo: torch.Tensor   # [N] bool
    valid: torch.Tensor       # [N] bool


def host_may_read(t: torch.Tensor) -> bool:
    """Whether a step on ``t``'s device may read a value back to the host:
    always on the CPU; on a card unless its current stream is capturing a
    CUDA graph, which no host read may enter."""
    return t.device.type != "cuda" or not torch.cuda.is_current_stream_capturing()


def _project(tcw: torch.Tensor, obs: PoseObs, cam: PinholeCamera):
    pc = se3.apply(tcw, obs.pts_w)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    e = torch.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                     torch.where(obs.is_stereo, obs.uv[:, 2] - ur,
                                 torch.zeros_like(ur))], dim=-1)
    return e, x, y, z, inv_z


def _residual_only(tcw: torch.Tensor, obs: PoseObs, cam: PinholeCamera):
    """-> (e [N,3], depth [N]) without the Jacobian (cost evaluations)."""
    e, _, _, z, _ = _project(tcw, obs, cam)
    return e, z


def _residual_jacobian_flat(tcw: torch.Tensor, obs: PoseObs, cam: PinholeCamera):
    """-> (e [N,3], j [N,18] row-major [3,6], depth [N]); the third row is
    zero for mono observations. J = -d(proj)/d(xi) with d(pc)/d(xi) =
    [I | -hat(pc)] for the left-multiplicative twist."""
    e, x, y, z, inv_z = _project(tcw, obs, cam)
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(x)
    stf = obs.is_stereo.to(x.dtype)
    d_rows = (
        (cam.fx * inv_z, zeros, -cam.fx * x * inv_z2),
        (zeros, cam.fy * inv_z, -cam.fy * y * inv_z2),
        (cam.fx * inv_z * stf, zeros,
         (-cam.fx * x * inv_z2 + cam.bf * inv_z2) * stf),
    )
    j_cols = []
    for d0, d1, d2 in d_rows:
        j_cols += [-d0, -d1, -d2,
                   -(-d1 * z + d2 * y),
                   -(d0 * z - d2 * x),
                   -(-d0 * y + d1 * x)]
    return e, torch.stack(j_cols, dim=-1), z


def _chi2(e: torch.Tensor, obs: PoseObs) -> torch.Tensor:
    """Per-observation chi-square with octave information scaling."""
    return torch.sum(e * e, dim=-1) * obs.inv_sigma2


def _compact_obs(obs: PoseObs, cap: int) -> PoseObs:
    """Gather the valid rows of a mostly-masked PoseObs into a [cap] set
    (order-preserving; valid rows beyond cap are dropped). The LM chain then
    runs on the compacted set and the final inlier classification on the
    full set. Rows that do not fit are written to an explicit overflow slot
    ``cap`` (an out-of-range scatter is an error in PyTorch)."""
    n = obs.valid.shape[0]
    dev = obs.valid.device
    pos = torch.cumsum(obs.valid.to(torch.int64), dim=0) - 1
    slot = torch.where(obs.valid & (pos < cap), pos, cap)
    gather = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
    gather[slot] = torch.arange(n, dtype=torch.int64, device=dev)
    gather = gather[:cap]
    occupied = gather < n
    take = torch.clamp(gather, max=n - 1)
    return PoseObs(
        pts_w=obs.pts_w[take],
        uv=obs.uv[take],
        inv_sigma2=obs.inv_sigma2[take],
        is_stereo=obs.is_stereo[take],
        valid=occupied,
    )


def pose_optimization(
    tcw0: torch.Tensor,
    obs: PoseObs,
    cam: PinholeCamera,
    rounds: int = 4,
    iters: int = 10,
    compact_cap: Optional[int] = 1024,
    stop_early: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (tcw, inlier_mask [N] bool, n_inliers int32 scalar tensor).

    Each round runs up to `iters` LM steps on the current inlier set, then
    reclassifies inliers by chi2 against 5.991/7.815; the Huber kernel is
    active for the first two rounds only.

    ``stop_early``: end a round at its first converged step, reading the
    flag on the host (one synchronisation a step); False runs every step
    with the flag on the device and no host read, the form a CUDA graph
    captures. None takes ``host_may_read(tcw0)``. The result is the same.

    When the observation capacity exceeds ``compact_cap``, the LM rounds
    run on a compacted copy of the valid rows (see _compact_obs); the
    returned inlier mask is always the full-capacity chi2 classification
    at the final pose.
    """
    if stop_early is None:
        stop_early = host_may_read(tcw0)
    obs_full = obs
    if compact_cap is not None and obs.valid.shape[0] > compact_cap:
        obs = _compact_obs(obs, compact_cap)
    dev = tcw0.device
    st = obs.is_stereo
    chi2_th = torch.where(st, CHI2_STEREO, CHI2_MONO).to(torch.float32)
    delta = torch.where(st, math.sqrt(CHI2_STEREO), math.sqrt(CHI2_MONO)).to(torch.float32)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def cost_from_chi2(c, z, inlier, use_huber: bool):
        if use_huber:
            s = torch.sqrt(torch.clamp(c, min=1e-12))
            cost = torch.where(s <= delta, c, 2.0 * delta * s - delta * delta)
        else:
            cost = c
        w = inlier & obs.valid & (z > 1e-6)
        return torch.sum(torch.where(w, cost, torch.zeros_like(cost)))

    def total_cost(tcw, inlier, use_huber: bool):
        e, z = _residual_only(tcw, obs, cam)
        return cost_from_chi2(_chi2(e, obs), z, inlier, use_huber)

    def lm_round(tcw, inlier, use_huber: bool, cost):
        # Early-exit LM: once a proposed step is below numerical noise
        # (|xi|^2 < 1e-10) or damping is maxed out, every further iteration
        # is a no-op. Eagerly, reading `done` costs one host synchronisation
        # per step, and a step is a few hundred small launches, so stopping
        # at convergence (typically well under `iters` steps) is the cheaper
        # side; without host reads the steps after `done` change nothing.
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(iters):
            e, j, z = _residual_jacobian_flat(tcw, obs, cam)
            c = _chi2(e, obs)
            w = obs.inv_sigma2
            if use_huber:
                s = torch.sqrt(torch.clamp(c, min=1e-12))
                w = w * torch.where(s > delta, delta / s, torch.ones_like(s))
            w = torch.where(inlier & obs.valid & (z > 1e-6), w, torch.zeros_like(w))
            j3 = j.reshape(-1, 3, 6)
            jw = j3 * w[:, None, None]
            # H = sum_i Jw_i^T J_i, b = -sum_i Jw_i^T e_i over the 3 rows
            h = torch.einsum("nri,nrj->ij", jw, j3)
            b = -torch.einsum("nri,nr->i", jw, e)
            h_damped = h + lam * torch.diag(torch.diagonal(h)) + 1e-9 * eye6
            # solve_ex: no error check (a host synchronisation) and no raise
            # on a singular system, which the 1e-9 ridge keeps away anyway
            xi = torch.linalg.solve_ex(h_damped, b)[0]
            tcw_new = se3.retract(tcw, xi)
            cost_new = total_cost(tcw_new, inlier, use_huber)
            accept = cost_new < cost
            tcw_step = torch.where(accept, tcw_new, tcw)
            lam_step = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                                   torch.clamp(lam * 4.0, max=1e6))
            cost_step = torch.where(accept, cost_new, cost)
            # the test is on the PROPOSED step, not gated on acceptance: at a
            # stationary point LM keeps proposing and rejecting such steps
            converged = (torch.sum(xi * xi) < 1e-10) | (lam_step >= 1e6)
            if stop_early:
                tcw, lam, cost = tcw_step, lam_step, cost_step
                if bool(converged):
                    break
            else:
                tcw = torch.where(done, tcw, tcw_step)
                lam = torch.where(done, lam, lam_step)
                cost = torch.where(done, cost, cost_step)
                done = done | converged
        return tcw

    # Each round boundary runs ONE residual pass that yields both the chi2
    # reclassification and the next round's starting cost.
    inlier = obs.valid
    tcw = tcw0
    cost0 = total_cost(tcw0, inlier, True)
    for r in range(rounds):
        tcw = lm_round(tcw, inlier, r < 2, cost0)
        e, z = _residual_only(tcw, obs, cam)
        c = _chi2(e, obs)
        inlier = obs.valid & (c <= chi2_th) & (z > 1e-6)
        if r + 1 < rounds:
            cost0 = cost_from_chi2(c, z, inlier, r + 1 < 2)
    # final inlier classification on the FULL observation set (identical to
    # the in-loop one when nothing was compacted away)
    if obs_full is not obs:
        chi2_th_full = torch.where(obs_full.is_stereo, CHI2_STEREO, CHI2_MONO)
        e, z = _residual_only(tcw, obs_full, cam)
        c = _chi2(e, obs_full)
        inlier = obs_full.valid & (c <= chi2_th_full) & (z > 1e-6)
    return tcw, inlier, torch.sum(inlier.to(torch.int32)).to(torch.int32)


def make_pose_obs(
    pts_w: torch.Tensor,
    uv: torch.Tensor,
    octave: torch.Tensor,
    is_stereo: torch.Tensor,
    valid: torch.Tensor,
    scale_factor: float = 1.2,
) -> PoseObs:
    """Convenience: information from octave as 1/scale^(2*octave)."""
    inv_sigma2 = (1.0 / scale_factor ** 2) ** octave.to(torch.float32)
    if uv.shape[-1] != 3:
        uv = torch.cat([uv, -torch.ones_like(uv[..., :1])], dim=-1)
    return PoseObs(pts_w=pts_w, uv=uv, inv_sigma2=inv_sigma2,
                   is_stereo=is_stereo, valid=valid)
