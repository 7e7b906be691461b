"""Batched 256-bit Hamming distance.

Counterpart of ``orbslam2_tpu/ops/hamming.py``. The dense distance *matrix*
is kept (one product yields all N*M distances): each descriptor is mapped to
a {-1,+1}^256 float32 vector, so that

    dot(a, b) = 256 - 2 * hamming(a, b)

and the float32 product is exact for sums up to 256. Row-aligned distances
use xor + bit counting.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from orbslam2_tpu_torch.ops.orb import unpack_bits, DESC_BITS

# reference matcher thresholds
TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

# distance assigned to invalid rows/cols; larger than any real distance
INVALID_DIST = DESC_BITS + 1


def to_pm1(desc_packed: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 bit-views -> [..., 256] float32 in {-1, +1}."""
    return unpack_bits(desc_packed).to(torch.float32) * 2.0 - 1.0


def distance_matrix(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: Optional[torch.Tensor] = None,
    valid_b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All-pairs Hamming distance.

    desc_a: [N, 8], desc_b: [M, 8] int32 -> [N, M] int32 in [0, 256];
    invalid rows/cols get INVALID_DIST. Leading (session) axes batch: the
    product's sums are integers below 2^24, exact in any order.
    """
    dot = to_pm1(desc_a) @ to_pm1(desc_b).transpose(-1, -2)
    dist = ((DESC_BITS - dot) * 0.5).to(torch.int32)
    if valid_a is not None:
        dist = torch.where(valid_a[..., :, None], dist, INVALID_DIST)
    if valid_b is not None:
        dist = torch.where(valid_b[..., None, :], dist, INVALID_DIST)
    return dist


def pairwise_distance(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Row-aligned Hamming distance: [..., 8] x [..., 8] -> [...] int32."""
    return torch.sum(unpack_bits(desc_a ^ desc_b).to(torch.int32), dim=-1)


def best_and_second(
    dist: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row best match with second-best distance for the ratio test.

    dist: [N, M]; mask: [N, M] bool of admissible pairs (leading axes
    batch). -> (best_idx [N] int64, best_dist [N] int32, second_dist [N]
    int32). Rows with no admissible pair get best_dist = INVALID_DIST. Ties
    go to the lowest column (``torch.min`` over a dim returns the first
    minimum).
    """
    if mask is not None:
        dist = torch.where(mask, dist, INVALID_DIST)
    best, best_idx = torch.min(dist, dim=-1)
    second = torch.min(
        dist.scatter(-1, best_idx[..., None],
                     torch.full_like(best_idx[..., None], INVALID_DIST, dtype=dist.dtype)),
        dim=-1).values
    return best_idx, best, second


def mutual_best(dist: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, M] -> [N] index of col-best that also row-bests back, else -1."""
    if mask is not None:
        dist = torch.where(mask, dist, INVALID_DIST)
    best_d, best_j = torch.min(dist, dim=1)
    best_i = torch.min(dist, dim=0).indices
    rows = torch.arange(dist.shape[0], device=dist.device)
    ok = (best_i[best_j] == rows) & (best_d < INVALID_DIST)
    return torch.where(ok, best_j, -1).to(torch.int32)


def rotation_consistency_mask(
    angle_a: torch.Tensor, angle_b: torch.Tensor, match_valid: torch.Tensor
) -> torch.Tensor:
    """Keep only matches whose orientation difference falls in the 3 dominant
    histogram bins (the reference's ComputeThreeMaxima filter).

    angle_a/angle_b: radians per match pair [N]; match_valid: [N] bool.
    """
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_a - angle_b, two_pi)  # [0, 2pi)
    bins = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int64),
                       0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int64, device=bins.device)
    hist.index_add_(0, bins, match_valid.to(torch.int64))
    # top three bins, ties toward the lower bin: a stable descending sort
    # (the integer histogram ties often and torch.topk promises no order)
    top3_vals, top3_idx = torch.sort(hist, descending=True, stable=True)
    max1 = top3_vals[0].to(torch.float32)
    # drop 2nd/3rd bins when much weaker than the best
    keep2 = top3_vals[1].to(torch.float32) >= 0.1 * max1
    keep3 = top3_vals[2].to(torch.float32) >= 0.1 * max1
    in1 = bins == top3_idx[0]
    in2 = (bins == top3_idx[1]) & keep2
    in3 = (bins == top3_idx[2]) & keep3
    return match_valid & (in1 | in2 | in3)
