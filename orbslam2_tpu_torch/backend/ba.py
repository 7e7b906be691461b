"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Counterpart of ``orbslam2_tpu/backend/ba.py``: ``bundle_adjust`` (the dense
reduced camera system, for local BA) and ``bundle_adjust_pcg`` (the
matrix-free PCG Schur solve, for global BA). The problem is flat tensors
(poses, points, observations, masks) and every step is batched:

- residuals + analytic Jacobians for all observations at once, as rank-3
  per-observation blocks ([O, 3, 6], [O, 3, 3])
- the 6x6 / 3x3 Hessian blocks, gradients and the [K, P, 6, 3] camera-point
  coupling summed over observations with ``index_add_``
- point marginalization (the Schur trick) as batched 3x3 inverses and one
  [6K, 3P] x [3P, 6K] product; the reduced [6K, 6K] system is solved densely

Semantics kept from the JAX package, which mirrors the reference's local BA:
Huber delta sqrt(5.991) mono / sqrt(7.815) stereo; 5 robust steps, outlier
exclusion, 10 plain steps, final classification; fixed cameras as the gauge.
The LM loop is a fixed number of steps with ``torch.where`` accept/reject
and no early exit, as ``lax.scan`` in the JAX package: nothing in a solve
waits for the host. A solve is a reset, then per phase a prologue, its LM
steps and an epilogue, each updating a fixed set of state tensors in place
(``_RobustLM``): the eager solve calls them in turn, and
``backend/solve_program.py`` captures each once as a CUDA graph and replays
the step once per LM step, as ``lax.scan`` runs its jitted step.

The solve runs in the dtype of the problem's floating-point tensors. The JAX
package solves in float32; the port's local mapper stages its problems in
float64 (frontend/local_mapping.py says why).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment problem (SoA, masked)."""
    poses: torch.Tensor          # [K, 4, 4] Tcw
    points: torch.Tensor         # [P, 3] world points
    cam_fixed: torch.Tensor      # [K] bool (gauge / out-of-window cameras)
    obs_cam: torch.Tensor        # [O] int camera index per observation
    obs_pt: torch.Tensor         # [O] int point index
    obs_uv: torch.Tensor         # [O, 3] observed (u, v, uR); uR ignored for mono
    obs_inv_sigma2: torch.Tensor  # [O] information scale (per octave)
    obs_stereo: torch.Tensor     # [O] bool
    obs_valid: torch.Tensor      # [O] bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    inlier: torch.Tensor         # [O] bool final inlier classification
    cost: torch.Tensor           # final robust cost


def _camera_points(problem: BAProblem):
    """-> (R [O,3,3], camera-frame points [O,3]) of every observation."""
    tcw = problem.poses[problem.obs_cam]
    r = tcw[:, :3, :3]
    pc = torch.einsum("oij,oj->oi", r, problem.points[problem.obs_pt]) + tcw[:, :3, 3]
    return r, pc


def _residuals(problem: BAProblem, cam: PinholeCamera, pc: torch.Tensor):
    """-> (e [O,3], z [O], 1/z [O]) for camera-frame points."""
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    inv_z = 1.0 / torch.where(z > 1e-6, z, 1e-6)
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    e = torch.stack([
        problem.obs_uv[:, 0] - u,
        problem.obs_uv[:, 1] - v,
        torch.where(problem.obs_stereo, problem.obs_uv[:, 2] - ur, 0.0),
    ], dim=-1)
    return e, z, inv_z


def _residuals_jacobians(problem: BAProblem, cam: PinholeCamera):
    """-> e [O,3], Jc [O,3,6], Jp [O,3,3], z [O]."""
    r, pc = _camera_points(problem)
    e, z, inv_z = _residuals(problem, cam, pc)
    x, y = pc[:, 0], pc[:, 1]
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(x)
    du = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], dim=-1)
    dv = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dr = du + torch.stack([zeros, zeros, cam.bf * inv_z2], dim=-1)
    dr = torch.where(problem.obs_stereo[:, None], dr, 0.0)
    d_proj = torch.stack([du, dv, dr], dim=-2)             # [O, 3, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    j_pc_cam = torch.cat([eye, -se3.hat(pc)], dim=-1)      # [O, 3, 6]
    return e, -(d_proj @ j_pc_cam), -(d_proj @ r), z


def _residual_only_ba(problem: BAProblem, cam: PinholeCamera):
    """-> (e [O,3], z [O]) without Jacobians (cost evaluations)."""
    _, pc = _camera_points(problem)
    e, z, _ = _residuals(problem, cam, pc)
    return e, z


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of `like`'s dtype and device, filled on the device (a
    Python number copied from the host is a copy no CUDA graph may hold)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _robust_weights(e: torch.Tensor, problem: BAProblem, use_huber: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (per-obs IRLS weight incl. information, per-obs robust cost)."""
    chi2 = torch.sum(e * e, dim=-1) * problem.obs_inv_sigma2
    if not use_huber:
        return problem.obs_inv_sigma2, chi2
    delta = torch.where(problem.obs_stereo, torch.sqrt(_scalar(CHI2_STEREO, e)),
                        torch.sqrt(_scalar(CHI2_MONO, e)))
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    robust = s > delta
    w_huber = torch.where(robust, delta / s, 1.0)
    cost = torch.where(robust, 2.0 * delta * s - delta * delta, chi2)
    return problem.obs_inv_sigma2 * w_huber, cost


def _build_blocks(problem: BAProblem, cam: PinholeCamera, active: torch.Tensor,
                  use_huber: bool):
    """Assemble all Hessian blocks and gradients.

    -> h_cc [K,6,6], h_pp [P,3,3], b_c [K,6], b_p [P,3],
       w_cp [K,P,6,3] (dense camera-point coupling), cost (scalar).
    """
    k, p = problem.poses.shape[0], problem.points.shape[0]
    e, jc, jp, z = _residuals_jacobians(problem, cam)
    w, cost_o = _robust_weights(e, problem, use_huber)
    on = active & (z > 1e-6)
    w = torch.where(on, w, 0.0)
    jc_wt = (jc * w[:, None, None]).transpose(1, 2)        # [O, 6, 3]
    jp_wt = (jp * w[:, None, None]).transpose(1, 2)        # [O, 3, 3]
    cost = torch.sum(torch.where(on, cost_o, 0.0))
    cams, pts = problem.obs_cam, problem.obs_pt
    like = dict(dtype=e.dtype, device=e.device)
    h_cc = torch.zeros((k, 6, 6), **like).index_add_(0, cams, jc_wt @ jc)
    h_pp = torch.zeros((p, 3, 3), **like).index_add_(0, pts, jp_wt @ jp)
    b_c = torch.zeros((k, 6), **like).index_add_(0, cams, -(jc_wt @ e[:, :, None])[..., 0])
    b_p = torch.zeros((p, 3), **like).index_add_(0, pts, -(jp_wt @ e[:, :, None])[..., 0])
    w_cp = torch.zeros((k * p, 6, 3), **like).index_add_(
        0, cams * p + pts, jc_wt @ jp).reshape(k, p, 6, 3)
    return h_cc, h_pp, b_c, b_p, w_cp, cost


def _local(t: torch.Tensor) -> torch.Tensor:
    """The sum over observations of a solve on one device: the partial sum
    is the whole (``parallel/dist_ba.py`` passes an all-reduce instead)."""
    return t


def _total_cost(problem: BAProblem, cam: PinholeCamera, active: torch.Tensor,
                use_huber: bool, reduce=_local) -> torch.Tensor:
    e, z = _residual_only_ba(problem, cam)
    _, cost_o = _robust_weights(e, problem, use_huber)
    return reduce(torch.sum(torch.where(active & (z > 1e-6), cost_o, 0.0)))


def _inv3x3(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse; the damped point Hessians
    it inverts are SPD and far from singular."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c10 + a[..., 0, 2] * c20
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj / torch.where(torch.abs(det) > 1e-20, det, 1e-20)[..., None, None]


def _inv6x6_spd(a: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 SPD inverse via the 3x3 block Schur complement (two
    closed-form 3x3 inverses)."""
    a11, a12 = a[..., :3, :3], a[..., :3, 3:]
    a21, a22 = a[..., 3:, :3], a[..., 3:, 3:]
    a11i = _inv3x3(a11)
    a11i_a12 = a11i @ a12
    si = _inv3x3(a22 - a21 @ a11i_a12)
    b12 = -(a11i_a12 @ si)
    b21 = -(si @ (a21 @ a11i))
    b11 = a11i - a11i_a12 @ b21
    return torch.cat([torch.cat([b11, b12], dim=-1),
                      torch.cat([b21, si], dim=-1)], dim=-2)


def _diag_only(blocks: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(torch.diagonal(blocks, dim1=-2, dim2=-1))


def _solve_schur_dense(h_cc, h_pp, b_c, b_p, w_cp, cam_fixed, lam):
    """Point marginalization + dense reduced-camera solve.

    -> (delta_c [K,6], delta_p [P,3]).
    """
    k, p = h_cc.shape[0], h_pp.shape[0]
    eye6 = torch.eye(6, dtype=h_cc.dtype, device=h_cc.device)
    eye3 = torch.eye(3, dtype=h_cc.dtype, device=h_cc.device)
    h_cc_d = h_cc + lam * _diag_only(h_cc) + 1e-8 * eye6
    h_pp_d = h_pp + lam * _diag_only(h_pp) + 1e-8 * eye3
    h_pp_inv = _inv3x3(h_pp_d)

    # S = Hcc - W Hpp^-1 W^T with the point sum as one product over (p, l):
    # rows and columns of both factors are (camera, axis) = 6K, (point,
    # axis) = 3P
    wy = w_cp @ h_pp_inv[None]                                 # [K,P,6,3]
    wy_rows = wy.permute(0, 2, 1, 3).reshape(k * 6, p * 3)
    w_rows = w_cp.permute(0, 2, 1, 3).reshape(k * 6, p * 3)
    s = -(wy_rows @ w_rows.T)                                  # [6K, 6K]
    torch.diagonal(s.view(k, 6, k, 6), dim1=0, dim2=2).add_(h_cc_d.permute(1, 2, 0))
    b_red = b_c.reshape(-1) - wy_rows @ b_p.reshape(-1)

    # gauge: fixed cameras get identity rows/cols and zero rhs (expand, not
    # repeat_interleave, which may read its output size on the host)
    free6 = (~cam_fixed)[:, None].expand(k, 6).reshape(-1)
    s = torch.where(free6[:, None] & free6[None, :], s, 0.0) \
        + torch.diag((~free6).to(s.dtype))
    b_red = torch.where(free6, b_red, 0.0)

    delta = torch.linalg.solve_ex(s, b_red[:, None]).result[:, 0]
    delta = torch.where(free6, delta, 0.0)

    # back-substitute points: dp = Hpp^-1 (b_p - W^T dc)
    wt_dc = (w_rows.T @ delta).reshape(p, 3)
    delta_p = (h_pp_inv @ (b_p - wt_dc)[:, :, None])[..., 0]
    return delta.reshape(k, 6), delta_p


def _classify_inliers(problem: BAProblem, cam: PinholeCamera) -> torch.Tensor:
    e, z = _residual_only_ba(problem, cam)
    chi2 = torch.sum(e * e, dim=-1) * problem.obs_inv_sigma2
    th = torch.where(problem.obs_stereo, CHI2_STEREO, CHI2_MONO)
    return problem.obs_valid & (chi2 <= th) & (z > 1e-6)


def _under_constrained(problem: BAProblem, active: torch.Tensor,
                       pt_fixed: torch.Tensor, reduce=_local) -> torch.Tensor:
    """[P] points with < 2 active observations and no active stereo one:
    unconstrained along their viewing ray."""
    p = problem.points.shape[0]
    counts = torch.zeros((p, 2), dtype=torch.float32, device=active.device).index_add_(
        0, problem.obs_pt, torch.stack([active, active & problem.obs_stereo], 1).to(
            torch.float32))
    counts = reduce(counts)
    return (counts[:, 0] < 2) & (counts[:, 1] < 1) & ~pt_fixed


def _solve_schur_pcg(e, jc, jp, w, obs_cam, obs_pt, n_cams, n_pts, cam_fixed,
                     pt_fixed, lam, pcg_iters: int = 30, reduce=_local):
    """Matrix-free Schur solve: preconditioned conjugate gradients on the
    reduced camera system, with S v computed through the observation lists,
    never forming S or the camera-point coupling (the path of global BA).

    e [O,3], jc [O,3,6], jp [O,3,3], w [O] (robust weight and information,
    zero for inactive observations). The conjugate gradient stops once
    ||r||^2 <= 1e-6 ||b||^2 (at most `pcg_iters` steps): every step runs,
    and a step after that changes nothing (``torch.where`` carries), where
    the JAX package leaves a ``lax.while_loop``; no step waits for the host.
    Every sum over observations goes through `reduce` (the identity on one
    device; an all-reduce over the ranks that each hold a slice of the
    observations), so all the state of the conjugate gradient is the same
    on every rank, and so is its stopping rule.
    -> (delta_c [K,6], delta_p [P,3]).
    """
    like = dict(dtype=e.dtype, device=e.device)
    eye6 = torch.eye(6, **like)
    eye3 = torch.eye(3, **like)
    jc_w = jc * w[:, None, None]
    jc_wt = jc_w.transpose(1, 2)                                   # [O, 6, 3]
    jp_t = jp.transpose(1, 2)

    def seg_cam(v):
        return reduce(torch.zeros((n_cams,) + v.shape[1:], **like).index_add_(0, obs_cam, v))

    def seg_pt(v):
        return reduce(torch.zeros((n_pts,) + v.shape[1:], **like).index_add_(0, obs_pt, v))

    def rows(m, v):   # per-observation matrix-vector product
        return (m @ v[..., None])[..., 0]

    h_cc = seg_cam(jc_wt @ jc)
    h_pp = seg_pt((jp_t * w[:, None, None]) @ jp)
    b_c = seg_cam(-rows(jc_wt, e))
    b_p = torch.where(pt_fixed[:, None], 0.0, seg_pt(-rows(jp_t * w[:, None, None], e)))
    h_cc_d = h_cc + lam * _diag_only(h_cc) + 1e-8 * eye6
    h_pp_d = torch.where(pt_fixed[:, None, None], eye3,
                         h_pp + lam * _diag_only(h_pp) + 1e-8 * eye3)
    h_pp_inv = torch.where(pt_fixed[:, None, None], 0.0, _inv3x3(h_pp_d))
    free = ~cam_fixed[:, None]

    def to_points(v):      # y = Hpp^-1 W^T v, W^T v summed per point
        return rows(h_pp_inv, seg_pt(rows(jp_t, rows(jc_w, v[obs_cam]))))

    def to_cams(y):        # W y summed per camera
        return seg_cam(rows(jc_wt, rows(jp, y[obs_pt])))

    def schur_matvec(v):   # v [K, 6]
        v = torch.where(free, v, 0.0)
        return torch.where(free, rows(h_cc_d, v) - to_cams(to_points(v)), v)

    # reduced right-hand side b~ = b_c - W Hpp^-1 b_p
    b_red = torch.where(free, b_c - to_cams(rows(h_pp_inv, b_p)), 0.0)
    # block-Jacobi preconditioner from the damped H_cc (a fixed camera has
    # h_cc = 0: the ridge keeps it invertible and the preconditioner passes
    # it by)
    m_inv = _inv6x6_spd(h_cc_d + 1e-6 * eye6)

    def precond(r):
        return torch.where(free, rows(m_inv, r), r)

    def dot(a, b):
        return torch.sum(a * b)

    x = torch.zeros_like(b_red)
    r = b_red
    z = precond(r)
    p = z
    rz = dot(r, z)
    rr_stop = 1e-6 * dot(b_red, b_red)
    for _ in range(pcg_iters):
        run = dot(r, r) > rr_stop
        ap = schur_matvec(p)
        alpha = rz / torch.clamp(dot(p, ap), min=1e-20)
        r_n = r - alpha * ap
        z_n = precond(r_n)
        rz_n = dot(r_n, z_n)
        beta = rz_n / torch.clamp(rz, min=1e-20)
        x = torch.where(run, x + alpha * p, x)
        r = torch.where(run, r_n, r)
        p = torch.where(run, z_n + beta * p, p)
        rz = torch.where(run, rz_n, rz)
    delta_c = torch.where(free, x, 0.0)
    # back-substitute points
    delta_p = rows(h_pp_inv, b_p - seg_pt(rows(jp_t, rows(jc_w, delta_c[obs_cam]))))
    return delta_c, torch.where(pt_fixed[:, None], 0.0, delta_p)


class _RobustLM:
    """The two-phase robust LM schedule shared by both solvers: phase 0 with
    Huber, chi2 outlier exclusion between phases, later phases on inliers
    without Huber; a fixed number of steps with ``torch.where``
    accept/reject.

    The solve's state (poses, points, the active observations, the phase's
    frozen points and active set, damping and cost) lives in tensors made
    once, which each part updates in place: ``reset`` (the state from the
    problem), per phase ``prologue`` (the phase's guard, damping and cost),
    ``step`` once per LM step, and ``epilogue`` (the classification). No
    part reads a tensor on the host, so each can be captured as a CUDA graph
    and replayed on new values of the problem's tensors (`solve_program`).
    `solve(prob, active, use_huber, pt_fixed, lam)` -> (delta_c, delta_p).
    `reduce` sums the costs and per-point counts over the ranks of a
    distributed solve (`_solve_schur_pcg`)."""

    def __init__(self, problem: BAProblem, cam: PinholeCamera, point_fixed,
                 lam0: float, solve, reduce=_local):
        self.problem = problem._replace(obs_cam=problem.obs_cam.long(),
                                        obs_pt=problem.obs_pt.long())
        self.cam, self.lam0, self.solve, self.reduce = cam, lam0, solve, reduce
        points = problem.points
        p = points.shape[0]
        self.pt_fixed = point_fixed if point_fixed is not None \
            else torch.zeros(p, dtype=torch.bool, device=points.device)
        self.poses = torch.empty_like(problem.poses)
        self.points = torch.empty_like(points)
        self.active = torch.empty_like(problem.obs_valid)
        self.pt_fixed_ph = torch.empty_like(self.pt_fixed)
        self.active_ph = torch.empty_like(problem.obs_valid)
        self.lam = torch.empty((), dtype=points.dtype, device=points.device)
        self.cost = torch.empty((), dtype=points.dtype, device=points.device)

    def _at(self, poses, points) -> BAProblem:
        return self.problem._replace(poses=poses, points=points)

    def reset(self) -> None:
        self.poses.copy_(self.problem.poses)
        self.points.copy_(self.problem.points)
        self.active.copy_(self.problem.obs_valid)
        self.cost.zero_()

    def prologue(self, use_huber: bool) -> None:
        # guard: a point with <2 active mono observations and no stereo
        # one is unconstrained along its viewing ray; a linear step can slide
        # it far enough that the next damped point Hessian overflows float32.
        # Such points are frozen for the phase and their lone observation
        # leaves the problem (against a frozen point it would wrongly drag
        # the camera). A stereo observation constrains depth: one suffices.
        prob = self.problem
        under = _under_constrained(prob, self.active, self.pt_fixed, self.reduce)
        self.pt_fixed_ph.copy_(self.pt_fixed | under)
        self.active_ph.copy_(self.active & ~under[prob.obs_pt])
        self.lam.fill_(self.lam0)
        self.cost.copy_(_total_cost(self._at(self.poses, self.points), self.cam,
                                    self.active_ph, use_huber, self.reduce))

    def step(self, use_huber: bool) -> None:
        poses, points, lam, cost = self.poses, self.points, self.lam, self.cost
        delta_c, delta_p = self.solve(self._at(poses, points), self.active_ph, use_huber,
                                      self.pt_fixed_ph, lam)
        poses_new = se3.retract(poses, delta_c)
        points_new = points + torch.where(self.pt_fixed_ph[:, None], 0.0, delta_p)
        cost_new = _total_cost(self._at(poses_new, points_new), self.cam, self.active_ph,
                               use_huber, self.reduce)
        # a non-finite step is never accepted: NaN poses turn z NaN, the
        # z-gate then masks every residual out and the collapsed cost
        # would pass the plain < test
        finite = (torch.isfinite(cost_new) & torch.isfinite(delta_c.sum())
                  & torch.isfinite(delta_p.sum()))
        accept = (cost_new < cost) & finite
        poses.copy_(torch.where(accept, poses_new, poses))
        points.copy_(torch.where(accept, points_new, points))
        lam.copy_(torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                              torch.clamp(lam * 5.0, max=1e8)))
        cost.copy_(torch.where(accept, cost_new, cost))

    def epilogue(self) -> None:
        inlier = _classify_inliers(self._at(self.poses, self.points), self.cam)
        # observations of under-constrained (phase-frozen) points were never
        # optimized: judged against the unmoved point they would read as
        # outliers and callers would erase the point's only observation; they
        # keep their prior status instead
        unjudged = _under_constrained(self.problem, self.active, self.pt_fixed,
                                      self.reduce)[self.problem.obs_pt]
        self.active.copy_(self.active & (inlier | unjudged))

    def result(self) -> BAResult:
        return BAResult(poses=self.poses, points=self.points, inlier=self.active,
                        cost=self.cost)


def _robust_lm(problem: BAProblem, cam: PinholeCamera, phase_iters, point_fixed,
               lam0: float, solve, reduce=_local) -> BAResult:
    """The eager solve: `_RobustLM`'s parts in turn."""
    lm = _RobustLM(problem, cam, point_fixed, lam0, solve, reduce)
    lm.reset()
    for phase, iters in enumerate(phase_iters):
        lm.prologue(phase == 0)
        for _ in range(iters):
            lm.step(phase == 0)
        lm.epilogue()
    return lm.result()


def _dense_solve(cam: PinholeCamera):
    """-> the local BA's `solve` for `_RobustLM`: the dense Schur solve."""
    def solve(prob, active, use_huber, pt_fixed, lam):
        eye3 = torch.eye(3, dtype=prob.points.dtype, device=prob.points.device)
        h_cc, h_pp, b_c, b_p, w_cp, _ = _build_blocks(prob, cam, active, use_huber)
        # freeze fixed points by zeroing their gradient and coupling
        b_p = torch.where(pt_fixed[:, None], 0.0, b_p)
        w_cp = torch.where(pt_fixed[None, :, None, None], 0.0, w_cp)
        h_pp = torch.where(pt_fixed[:, None, None], eye3, h_pp)
        return _solve_schur_dense(h_cc, h_pp, b_c, b_p, w_cp, prob.cam_fixed, lam)
    return solve


def _pcg_solve(cam: PinholeCamera, n_cams: int, n_pts: int, pcg_iters: int,
               reduce=_local):
    """-> the global BA's `solve` for `_RobustLM`: the matrix-free PCG."""
    def solve(prob, active, use_huber, pt_fixed, lam):
        e, jc, jp, z = _residuals_jacobians(prob, cam)
        w, _ = _robust_weights(e, prob, use_huber)
        w = torch.where(active & (z > 1e-6), w, 0.0)
        return _solve_schur_pcg(e, jc, jp, w, prob.obs_cam, prob.obs_pt, n_cams, n_pts,
                                prob.cam_fixed, pt_fixed, lam, pcg_iters, reduce)
    return solve


def bundle_adjust(
    problem: BAProblem,
    cam: PinholeCamera,
    phase_iters: Tuple[int, ...] = (5, 10),
    point_fixed: Optional[torch.Tensor] = None,
    lam0: float = 1e-4,
) -> BAResult:
    """Robust LM bundle adjustment with the dense Schur solve (local BA):
    the reference's two-phase local-BA schedule (`_robust_lm`).

    `point_fixed`: optional [P] bool, points kept constant.
    """
    return _robust_lm(problem, cam, phase_iters, point_fixed, lam0, _dense_solve(cam))


def bundle_adjust_pcg(
    problem: BAProblem,
    cam: PinholeCamera,
    phase_iters: Tuple[int, ...] = (5, 10),
    point_fixed: Optional[torch.Tensor] = None,
    lam0: float = 1e-4,
    pcg_iters: int = 30,
    reduce=_local,
) -> BAResult:
    """Large-scale BA (global BA after a loop closure): the same robust LM
    schedule as `bundle_adjust` with the matrix-free PCG Schur solve, memory
    O(observations). `reduce`: see `_solve_schur_pcg`; the observations of
    `problem` are then this rank's slice and `inlier` covers only them."""
    solve = _pcg_solve(cam, problem.poses.shape[0], problem.points.shape[0], pcg_iters,
                       reduce)
    return _robust_lm(problem, cam, phase_iters, point_fixed, lam0, solve, reduce)
