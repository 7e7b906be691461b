"""Windowed descriptor matching primitives (dense, masked).

Counterpart of ``orbslam2_tpu/ops/match.py``: the whole candidate relation
is one dense [P, N] Hamming matrix AND-ed with spatial / pyramid / validity
masks. Every function also takes a leading session axis on each of its
tensors ([B, P, ...] queries against [B, N, ...] keypoints), as ``jax.vmap``
gives the JAX functions one; a session never matches another's keypoints,
and its integers are the ones it gets alone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.ops import hamming
from orbslam2_tpu_torch.ops.hamming import INVALID_DIST
from orbslam2_tpu_torch.ops.orb import Keypoints


class WindowedMatches(NamedTuple):
    """Result of a query-set -> keypoint-set windowed match."""
    best_kp: torch.Tensor     # [P] int64 best keypoint per query, -1 if none
    best_dist: torch.Tensor   # [P] int32
    assoc: torch.Tensor       # [N] int64 winning query per keypoint, -1 if none


def windowed_match(
    query_uv: torch.Tensor,        # [P, 2] projected pixel positions
    query_desc: torch.Tensor,      # [P, 8] int32
    query_valid: torch.Tensor,     # [P] bool
    query_radius: torch.Tensor,    # [P] search radius in level-0 pixels
    query_level_lo: torch.Tensor,  # [P] admissible octave range (inclusive)
    query_level_hi: torch.Tensor,  # [P]
    kp: Keypoints,
    max_dist: int = hamming.TH_HIGH,
    ratio: Optional[float] = None,
    kp_free: Optional[torch.Tensor] = None,  # [N] bool: keypoint not yet taken
) -> WindowedMatches:
    """Dense windowed search: each query finds its best keypoint within a
    spatial radius and octave band; conflicts (two queries -> one keypoint)
    resolve to the smaller Hamming distance.

    `ratio`: optional Lowe-style test — best must beat the second-best
    *admissible* candidate by the given factor.
    """
    dist = hamming.distance_matrix(query_desc, kp.desc, query_valid, kp.valid)  # [P, N]

    du = query_uv[..., :, 0:1] - kp.xy[..., None, :, 0]
    dv = query_uv[..., :, 1:2] - kp.xy[..., None, :, 1]
    radius = query_radius[..., :, None]
    in_window = (torch.abs(du) <= radius) & (torch.abs(dv) <= radius)
    octave = kp.octave[..., None, :]
    in_level = (octave >= query_level_lo[..., :, None]) & (
        octave <= query_level_hi[..., :, None])
    mask = in_window & in_level & kp.valid[..., None, :] & query_valid[..., :, None]
    if kp_free is not None:
        mask = mask & kp_free[..., None, :]

    best_j, best_d, second_d = hamming.best_and_second(dist, mask)
    ok = best_d <= max_dist
    if ratio is not None:
        ok = ok & (best_d.to(torch.float32) <= ratio * second_d.to(torch.float32))
    best_kp = torch.where(ok, best_j, -1)
    best_dist = torch.where(ok, best_d, INVALID_DIST)
    assoc = resolve_conflicts(best_kp, best_dist, kp.n)
    # drop queries that lost their keypoint to a closer query
    p = query_uv.shape[-2]
    won = (best_kp >= 0) & (torch.gather(assoc, -1, best_kp.clamp(0, kp.n - 1))
                            == torch.arange(p, device=best_kp.device))
    return WindowedMatches(
        best_kp=torch.where(won, best_kp, -1),
        best_dist=torch.where(won, best_dist, INVALID_DIST),
        assoc=assoc,
    )


def resolve_conflicts(best_kp: torch.Tensor, best_dist: torch.Tensor, n_kp: int) -> torch.Tensor:
    """Scatter-min conflict resolution: for each keypoint, the query with the
    smallest distance wins (ties -> lowest query index). -> [N] int64.
    Queries without a keypoint are dumped in an overflow slot ``n_kp``.
    With a session axis ([B, P] -> [B, N]) each session scatters into its
    own row of the table, so no session's query wins another's keypoint."""
    p = best_kp.shape[-1]
    dev = best_kp.device
    best_kp = best_kp.long()
    valid = best_kp >= 0
    tgt = torch.where(valid, best_kp, n_kp)
    d = torch.where(valid, best_dist, INVALID_DIST).to(torch.int64)
    table = best_kp.shape[:-1] + (n_kp + 1,)
    per_kp_best = torch.full(table, INVALID_DIST, dtype=torch.int64, device=dev)
    per_kp_best = per_kp_best.scatter_reduce(-1, tgt, d, reduce="amin")
    is_winner = valid & (d == torch.gather(per_kp_best, -1, tgt))
    qidx = torch.arange(p, dtype=torch.int64, device=dev).expand(best_kp.shape)
    per_kp_query = torch.full(table, p, dtype=torch.int64, device=dev)
    per_kp_query = per_kp_query.scatter_reduce(
        -1, torch.where(is_winner, tgt, n_kp), qidx, reduce="amin")
    assoc = per_kp_query[..., :n_kp]
    return torch.where(assoc < p, assoc, -1)


def predict_scale_level(
    dist: torch.Tensor, max_dist: torch.Tensor, scale_factor: float, n_levels: int
) -> torch.Tensor:
    """Predicted pyramid level from viewing distance (MapPoint::PredictScale):
    level = ceil(log(max_dist / dist) / log(scale_factor))."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    # float32 log of the float32 factor, as the JAX package evaluates it
    lvl = torch.ceil(torch.log(ratio) / float(np.log(np.float32(scale_factor))))
    return torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)
