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

``pose_optimization`` also takes B poses on a leading session axis, as
``jax.vmap`` gives the JAX function one (``parallel/multi_session.py``):
each session keeps its own damping, cost and convergence flag ([B]) and
its own compacted observations, every step runs (no host read), and the
sums, products and the 6x6 solve run in ``utils/fixed_order.py``'s fixed
order, so a session's result does not depend on B. One pose without the
axis runs the library's sums and solve, as it always has.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.utils import fixed_order

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObs(NamedTuple):
    """Batched unary observations of one frame (fixed capacity, masked);
    [B, N, ...] with a session axis."""
    pts_w: torch.Tensor       # [N, 3] world points
    uv: torch.Tensor          # [N, 3] observed (u, v, uR); uR < 0 => mono
    inv_sigma2: torch.Tensor  # [N] per-octave information scale
    is_stereo: torch.Tensor   # [N] bool
    valid: torch.Tensor       # [N] bool


class _Arithmetic(NamedTuple):
    """The LM's float reductions, products and solve."""
    apply: Callable           # (tcw, pts_w) -> camera-frame points
    retract: Callable         # (tcw, xi) -> exp(xi) tcw
    row_sq: Callable          # e [..., N, 3] -> sum of squares per row [..., N]
    total: Callable           # [..., N] -> sum over N
    normal_equations: Callable  # (jw, j3 [..., N, 3, 6], e [..., N, 3]) -> (H, b)
    solve: Callable           # (H [..., 6, 6], b [..., 6]) -> xi


def _library_normal_equations(jw, j3, e):
    # H = sum_i Jw_i^T J_i, b = -sum_i Jw_i^T e_i over the 3 rows
    return torch.einsum("nri,nrj->ij", jw, j3), -torch.einsum("nri,nr->i", jw, e)


def _fixed_normal_equations(jw, j3, e):
    h = fixed_order.matmul(jw.transpose(-1, -2), j3)          # [..., N, 6, 6]
    b = fixed_order.matvec(jw.transpose(-1, -2), e)           # [..., N, 6]
    return fixed_order.tree_sum(h, -3), -fixed_order.tree_sum(b, -2)


# one pose: the library's arithmetic (se3's functions looked up at each call)
_ONE_POSE = _Arithmetic(
    apply=lambda tcw, pts: se3.apply(tcw, pts),
    retract=lambda tcw, xi: se3.retract(tcw, xi),
    row_sq=lambda e: torch.sum(e * e, dim=-1), total=torch.sum,
    normal_equations=_library_normal_equations,
    # solve_ex: no error check (a host synchronisation) and no raise on a
    # singular system, which the 1e-9 ridge keeps away anyway
    solve=lambda h, b: torch.linalg.solve_ex(h, b)[0])
# poses on a session axis: fixed order, a session's bits the same at any B
_SESSIONS = _Arithmetic(
    apply=fixed_order.apply, retract=fixed_order.retract,
    row_sq=lambda e: fixed_order.dot(e, e),
    total=lambda x: fixed_order.tree_sum(x, -1),
    normal_equations=_fixed_normal_equations, solve=fixed_order.solve)


def host_may_read(t: torch.Tensor) -> bool:
    """Whether a step on ``t``'s device may read a value back to the host:
    always on the CPU; on a card unless its current stream is capturing a
    CUDA graph, which no host read may enter."""
    return t.device.type != "cuda" or not torch.cuda.is_current_stream_capturing()


def _project(tcw: torch.Tensor, obs: PoseObs, cam: PinholeCamera,
             ar: _Arithmetic = _ONE_POSE):
    pc = ar.apply(tcw, obs.pts_w)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    e = torch.stack([obs.uv[..., 0] - u, obs.uv[..., 1] - v,
                     torch.where(obs.is_stereo, obs.uv[..., 2] - ur,
                                 torch.zeros_like(ur))], dim=-1)
    return e, x, y, z, inv_z


def _residual_only(tcw: torch.Tensor, obs: PoseObs, cam: PinholeCamera,
                   ar: _Arithmetic = _ONE_POSE):
    """-> (e [N,3], depth [N]) without the Jacobian (cost evaluations)."""
    e, _, _, z, _ = _project(tcw, obs, cam, ar)
    return e, z


def _residual_jacobian_flat(tcw: torch.Tensor, obs: PoseObs, cam: PinholeCamera,
                            ar: _Arithmetic = _ONE_POSE):
    """-> (e [N,3], j [N,18] row-major [3,6], depth [N]); the third row is
    zero for mono observations. J = -d(proj)/d(xi) with d(pc)/d(xi) =
    [I | -hat(pc)] for the left-multiplicative twist."""
    e, x, y, z, inv_z = _project(tcw, obs, cam, ar)
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


def _chi2(e: torch.Tensor, obs: PoseObs, ar: _Arithmetic = _ONE_POSE) -> torch.Tensor:
    """Per-observation chi-square with octave information scaling."""
    return ar.row_sq(e) * obs.inv_sigma2


def _compact_obs(obs: PoseObs, cap: int) -> PoseObs:
    """Gather the valid rows of a mostly-masked PoseObs into a [cap] set
    (order-preserving; valid rows beyond cap are dropped), each session's
    on its own with a session axis. The LM chain then runs on the compacted
    set and the final inlier classification on the full set. Rows that do
    not fit are written to an explicit overflow slot ``cap`` (an
    out-of-range scatter is an error in PyTorch), which is dropped."""
    n = obs.valid.shape[-1]
    dev = obs.valid.device
    pos = torch.cumsum(obs.valid.to(torch.int64), dim=-1) - 1
    slot = torch.where(obs.valid & (pos < cap), pos, cap)
    gather = torch.full(slot.shape[:-1] + (cap + 1,), n, dtype=torch.int64, device=dev)
    gather.scatter_(-1, slot, torch.arange(n, dtype=torch.int64, device=dev).expand(slot.shape))
    gather = gather[..., :cap]
    occupied = gather < n
    take = torch.clamp(gather, max=n - 1)
    rows = take[..., None]
    return PoseObs(
        pts_w=torch.take_along_dim(obs.pts_w, rows, dim=-2),
        uv=torch.take_along_dim(obs.uv, rows, dim=-2),
        inv_sigma2=torch.take_along_dim(obs.inv_sigma2, take, dim=-1),
        is_stereo=torch.take_along_dim(obs.is_stereo, take, dim=-1),
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
    """-> (tcw, inlier_mask [N] bool, n_inliers int32 scalar tensor); with
    a session axis (tcw0 [B, 4, 4], obs [B, N, ...]) -> ([B, 4, 4], [B, N],
    [B]).

    Each round runs up to `iters` LM steps on the current inlier set, then
    reclassifies inliers by chi2 against 5.991/7.815; the Huber kernel is
    active for the first two rounds only.

    ``stop_early``: end a round at its first converged step, reading the
    flag on the host (one synchronisation a step); False runs every step
    with the flag on the device and no host read, the form a CUDA graph
    captures. None takes ``host_may_read(tcw0)`` for one pose and False on
    a session axis, whose sessions converge at steps of their own. The
    result is the same.

    When the observation capacity exceeds ``compact_cap``, the LM rounds
    run on a compacted copy of the valid rows (see _compact_obs); the
    returned inlier mask is always the full-capacity chi2 classification
    at the final pose.
    """
    sessions = tcw0.dim() == 3
    if stop_early is None:
        stop_early = not sessions and host_may_read(tcw0)
    if stop_early and sessions:
        raise ValueError("a session axis runs every LM step (stop_early=False)")
    ar = _SESSIONS if sessions else _ONE_POSE
    obs_full = obs
    if compact_cap is not None and obs.valid.shape[-1] > compact_cap:
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
        return ar.total(torch.where(w, cost, torch.zeros_like(cost)))

    def total_cost(tcw, inlier, use_huber: bool):
        e, z = _residual_only(tcw, obs, cam, ar)
        return cost_from_chi2(_chi2(e, obs, ar), z, inlier, use_huber)

    def lm_round(tcw, inlier, use_huber: bool, cost):
        # Early-exit LM: once a proposed step is below numerical noise
        # (|xi|^2 < 1e-10) or damping is maxed out, every further iteration
        # is a no-op. Eagerly, reading `done` costs one host synchronisation
        # per step, and a step is a few hundred small launches, so stopping
        # at convergence (typically well under `iters` steps) is the cheaper
        # side; without host reads the steps after `done` change nothing.
        lam = torch.full(tcw.shape[:-2], 1e-3, dtype=torch.float32, device=dev)
        done = torch.zeros(tcw.shape[:-2], dtype=torch.bool, device=dev)
        for _ in range(iters):
            e, j, z = _residual_jacobian_flat(tcw, obs, cam, ar)
            c = _chi2(e, obs, ar)
            w = obs.inv_sigma2
            if use_huber:
                s = torch.sqrt(torch.clamp(c, min=1e-12))
                w = w * torch.where(s > delta, delta / s, torch.ones_like(s))
            w = torch.where(inlier & obs.valid & (z > 1e-6), w, torch.zeros_like(w))
            j3 = j.reshape(j.shape[:-1] + (3, 6))
            jw = j3 * w[..., None, None]
            h, b = ar.normal_equations(jw, j3, e)
            h_damped = h + lam[..., None, None] * torch.diag_embed(
                torch.diagonal(h, dim1=-2, dim2=-1)) + 1e-9 * eye6
            xi = ar.solve(h_damped, b)
            tcw_new = ar.retract(tcw, xi)
            cost_new = total_cost(tcw_new, inlier, use_huber)
            accept = cost_new < cost
            tcw_step = torch.where(accept[..., None, None], tcw_new, tcw)
            lam_step = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                                   torch.clamp(lam * 4.0, max=1e6))
            cost_step = torch.where(accept, cost_new, cost)
            # the test is on the PROPOSED step, not gated on acceptance: at a
            # stationary point LM keeps proposing and rejecting such steps
            converged = (ar.total(xi * xi) < 1e-10) | (lam_step >= 1e6)
            if stop_early:
                tcw, lam, cost = tcw_step, lam_step, cost_step
                if bool(converged):
                    break
            else:
                tcw = torch.where(done[..., None, None], tcw, tcw_step)
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
        e, z = _residual_only(tcw, obs, cam, ar)
        c = _chi2(e, obs, ar)
        inlier = obs.valid & (c <= chi2_th) & (z > 1e-6)
        if r + 1 < rounds:
            cost0 = cost_from_chi2(c, z, inlier, r + 1 < 2)
    # final inlier classification on the FULL observation set (identical to
    # the in-loop one when nothing was compacted away)
    if obs_full is not obs:
        chi2_th_full = torch.where(obs_full.is_stereo, CHI2_STEREO, CHI2_MONO)
        e, z = _residual_only(tcw, obs_full, cam, ar)
        c = _chi2(e, obs_full, ar)
        inlier = obs_full.valid & (c <= chi2_th_full) & (z > 1e-6)
    return tcw, inlier, torch.sum(inlier.to(torch.int32), dim=-1).to(torch.int32)


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
