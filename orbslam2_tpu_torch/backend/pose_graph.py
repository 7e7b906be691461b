"""Essential-graph (Sim3 pose graph) optimization.

Counterpart of ``orbslam2_tpu/backend/pose_graph.py`` (the reference's
Optimizer::OptimizeEssentialGraph): every keyframe is a 7-DoF Sim3 vertex
(scale frozen for stereo and RGB-D); the edges are the new loop connections,
the spanning tree, past loop edges and the strong covisibility pairs, each a
relative-Sim3 measurement with identity information; 20 Levenberg-Marquardt
steps, the loop keyframe held fixed.

The residuals r_e = log(S_meas_e S_i S_j^-1) of all edges are evaluated at
once, and their Jacobians with respect to left perturbations of both ends by
central differences (g2o also differentiates these edges numerically), as
[E, 7, 7] blocks. The damped normal system is solved without forming it: a
Jacobi-preconditioned conjugate gradient whose product runs through the edge
lists, with the fixed and invalid keyframes clamped out of the gauge.

The JAX package stops the conjugate gradient with ``lax.while_loop`` once
the residual has fallen by 1e-4 (at most 48 steps). Here every step runs,
and a step after convergence changes nothing (``torch.where`` carries), so
the solve never waits for the host. The solve runs in the poses' dtype.

A solve is ``_EssentialGraph.setup`` and then ``step`` once per LM step (the
JAX ``lm_step`` under ``lax.scan``), each updating the solve's state tensors
in place: ``backend/solve_program.py`` captures both as CUDA graphs and
replays the step. Padded edges (``edges_valid`` False, both ends at one
valid keyframe, an identity measurement: ``pad_edges``) add exact zeros.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from orbslam2_tpu_torch.geometry import sim3

_FD_EPS = 1e-4
_PCG_ITERS = 48


def _edge_residuals(poses, edges_i, edges_j, edges_meas, xi_i=None, xi_j=None):
    """r = log(S_meas S_i S_j^-1) for every edge -> [..., E, 7]; optional
    left perturbations xi_i, xi_j [..., E, 7] of the two ends."""
    s_i, s_j = poses[edges_i], poses[edges_j]
    if xi_i is not None:
        s_i = sim3.exp(xi_i) @ s_i
        s_j = sim3.exp(xi_j) @ s_j
    return sim3.log(edges_meas @ s_i @ sim3.inverse(s_j))


def _jacobians(poses, edges_i, edges_j, edges_meas):
    """Central differences with respect to both ends' perturbations.
    -> (J_i, J_j), each [E, 7 residuals, 7 dofs]."""
    e = edges_i.shape[0]
    dof = torch.eye(7, dtype=poses.dtype, device=poses.device) * _FD_EPS   # [7, 7]
    h = dof[:, None, :].expand(7, e, 7)
    zero = torch.zeros_like(h)
    # one batched evaluation: (+i, -i, +j, -j) x 7 dofs x E edges
    xi_i = torch.stack([h, -h, zero, zero])
    xi_j = torch.stack([zero, zero, h, -h])
    r = _edge_residuals(poses, edges_i, edges_j, edges_meas, xi_i, xi_j)  # [4,7,E,7]
    j_i = (r[0] - r[1]) / (2 * _FD_EPS)       # [dof, E, res]
    j_j = (r[2] - r[3]) / (2 * _FD_EPS)
    return j_i.permute(1, 2, 0), j_j.permute(1, 2, 0)


def pad_edges(edges_i: np.ndarray, edges_j: np.ndarray, edges_meas: np.ndarray,
              anchor: int, size: int):
    """The edge lists padded to `size` rows: each padded edge joins keyframe
    `anchor` (a valid one) to itself with an identity measurement, so that
    its residual is finite, and is invalid, so that its weight is 0 and it
    adds exact zeros. -> (edges_i, edges_j, edges_meas, edges_valid)."""
    n = len(edges_i)
    pad = size - n
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    fill = np.full(pad, anchor, np.int64)
    eye = np.broadcast_to(np.eye(4, dtype=edges_meas.dtype), (pad, 4, 4))
    return (np.concatenate([np.asarray(edges_i, np.int64), fill]),
            np.concatenate([np.asarray(edges_j, np.int64), fill]),
            np.concatenate([edges_meas, eye]), valid)


class _EssentialGraph:
    """One essential-graph solve as state tensors (poses, damping, cost, the
    edge weights and the free-keyframe mask) that `setup` and `step` update
    in place; neither reads a tensor on the host."""

    def __init__(self, poses, kf_valid, kf_fixed, edges_i, edges_j, edges_meas,
                 edges_valid, fix_scale: bool):
        like = dict(dtype=poses.dtype, device=poses.device)
        self.poses, self.kf_valid, self.kf_fixed = poses, kf_valid, kf_fixed
        self.edges_i, self.edges_j = edges_i.long(), edges_j.long()
        self.edges_meas = edges_meas.to(poses.dtype)
        self.edges_valid = edges_valid
        self.fix_scale = fix_scale
        self.k = poses.shape[0]
        self.p = torch.empty_like(poses)
        self.lam = torch.empty((), **like)
        self.c = torch.empty((), **like)
        self.w = torch.empty(edges_i.shape[0], **like)
        self.freef = torch.empty((self.k, 1), **like)

    def cost(self, p):
        r = _edge_residuals(p, self.edges_i, self.edges_j, self.edges_meas)
        return torch.sum(torch.where(self.edges_valid[:, None], r * r, 0.0))

    def per_kf(self, v_i, v_j):
        """Sum edge rows [E, 7] into their keyframes -> [K, 7]."""
        return (torch.zeros((self.k, 7), dtype=v_i.dtype, device=v_i.device)
                .index_add_(0, self.edges_i, v_i).index_add_(0, self.edges_j, v_j))

    def setup(self) -> None:
        self.p.copy_(self.poses)
        self.w.copy_(self.edges_valid.to(self.w.dtype))
        self.freef.copy_((self.kf_valid & ~self.kf_fixed).to(self.freef.dtype)[:, None])
        self.lam.fill_(1e-6)
        self.c.copy_(self.cost(self.p))

    def step(self) -> None:
        """One LM step: the central-difference Jacobians, the damped normal
        system by 48 PCG steps, retract, accept."""
        p, lam, c, w, freef = self.p, self.lam, self.c, self.w, self.freef
        edges_i, edges_j, edges_meas = self.edges_i, self.edges_j, self.edges_meas
        per_kf = self.per_kf

        def dot(a, b):
            return torch.sum(a * b)

        r = _edge_residuals(p, edges_i, edges_j, edges_meas) * w[:, None]
        j_i, j_j = _jacobians(p, edges_i, edges_j, edges_meas)
        j_i, j_j = j_i * w[:, None, None], j_j * w[:, None, None]
        j_it, j_jt = j_i.transpose(1, 2), j_j.transpose(1, 2)
        b = -per_kf((j_it @ r[..., None])[..., 0], (j_jt @ r[..., None])[..., 0]) * freef
        # Jacobi preconditioner from the diagonal of the block diagonal
        h_diag = per_kf(torch.sum(j_i * j_i, dim=1), torch.sum(j_j * j_j, dim=1))
        damp = lam + 1e-6
        m_inv = freef / (h_diag + damp)

        def matvec(v):   # (J^T J + damp I) v, gauge-clamped
            vf = v * freef
            jv = (j_i @ vf[edges_i][..., None] + j_j @ vf[edges_j][..., None])
            out = per_kf((j_it @ jv)[..., 0], (j_jt @ jv)[..., 0])
            return (out + damp * vf) * freef + v * (1.0 - freef)

        x = torch.zeros_like(b)
        rr = b
        z = m_inv * rr
        pd = z
        rz = dot(rr, z)
        rr_stop = 1e-8 * dot(b, b)
        for _ in range(_PCG_ITERS):
            run = dot(rr, rr) > rr_stop     # lax.while_loop's condition
            ap = matvec(pd)
            alpha = rz / torch.clamp(dot(pd, ap), min=1e-20)
            x_n = x + alpha * pd
            rr_n = rr - alpha * ap
            z_n = m_inv * rr_n
            rz_n = dot(rr_n, z_n)
            beta = rz_n / torch.clamp(rz, min=1e-20)
            x = torch.where(run, x_n, x)
            rr = torch.where(run, rr_n, rr)
            pd = torch.where(run, z_n + beta * pd, pd)
            rz = torch.where(run, rz_n, rz)
        delta = x
        if self.fix_scale:
            delta = torch.cat([delta[:, :6], torch.zeros_like(delta[:, 6:])], dim=1)
        delta = delta * freef
        p_new = sim3.exp(delta) @ p
        c_new = self.cost(p_new)
        accept = c_new < c
        p.copy_(torch.where(accept, p_new, p))
        lam.copy_(torch.where(accept, torch.clamp(lam * 0.5, min=1e-10),
                              torch.clamp(lam * 4.0, max=1e6)))
        c.copy_(torch.where(accept, c_new, c))


def optimize_essential_graph(
    poses: torch.Tensor,       # [K, 4, 4] initial Sim3 (Tcw-style, world->kf)
    kf_valid: torch.Tensor,    # [K]
    kf_fixed: torch.Tensor,    # [K] (the loop keyframe)
    edges_i: torch.Tensor,     # [E] int
    edges_j: torch.Tensor,     # [E] int
    edges_meas: torch.Tensor,  # [E, 4, 4] measured S_j S_i^-1
    edges_valid: torch.Tensor,  # [E]
    fix_scale: bool = False,
    iters: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (optimized Sim3 poses [K, 4, 4], final cost)."""
    graph = _EssentialGraph(poses, kf_valid, kf_fixed, edges_i, edges_j, edges_meas,
                            edges_valid, fix_scale)
    graph.setup()
    for _ in range(iters):
        graph.step()
    return graph.p, graph.c
