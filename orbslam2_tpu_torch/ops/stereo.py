"""Stereo left-right keypoint matching.

Counterpart of ``orbslam2_tpu/ops/stereo.py`` (the reference's
Frame::ComputeStereoMatches): the left-right relation is one dense Hamming
matrix masked by the epipolar-row window, the disparity range (0, fx] and
octave agreement within one level; the best right keypoint's x is refined by
the 11x11 SAD search over +-5 columns on the keypoint's own blurred pyramid
level with a parabola through the SAD minimum, and a median-distance sweep
drops outliers.

Torch ops on the extractor's device. The refinement runs once per pyramid
level on that level's contiguous keypoint block (the extractor's
``level_budgets``), gathering each keypoint's [11, 11] left patch and
[11, 21] right strip with the window start clamped into the image exactly
as ``jax.lax.dynamic_slice`` clamps it.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.ops import hamming
from orbslam2_tpu_torch.ops.orb import Keypoints

SAD_W = 5       # half window: 11x11
SAD_SLIDE = 5   # +-5 columns searched
_WIN = 2 * SAD_W + 1
_STRIP = _WIN + 2 * SAD_SLIDE


def match_stereo(
    kp_l: Keypoints,
    kp_r: Keypoints,
    pyr_l: Sequence[torch.Tensor],
    pyr_r: Sequence[torch.Tensor],
    cam: PinholeCamera,
    scale_factor: float = 1.2,
    *,
    level_budgets: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (uR [N] right-image u per left keypoint (-1 if unmatched),
           depth [N] (-1 if unmatched)).

    ``kp_l``/``kp_r``: both images' keypoints with their raw (distorted)
    level-0 xy, levels one after another as ``level_budgets`` (the
    extractor's per-level slot counts, one per level, which must sum to N)
    lay them out. ``pyr_l``/``pyr_r``: the extractor's blurred pyramids.

    Masks: row window 2 * scale_factor**octave_L, disparity in (0, fx]
    (depth at least the baseline), octave difference at most 1, Hamming at
    most TH_HIGH; SAD sub-pixel refinement; disparity > 0.01 after it;
    matches beyond 1.5 * 1.4 * the median matched distance dropped.
    """
    n = kp_l.n
    if sum(level_budgets) != n:
        raise ValueError(f"level_budgets {list(level_budgets)} must sum to the {n} "
                         f"keypoint slots")
    dist = hamming.distance_matrix(kp_l.desc, kp_r.desc, kp_l.valid, kp_r.valid)
    row_win = 2.0 * scale_factor ** kp_l.octave.to(torch.float32)
    dv = torch.abs(kp_l.xy[:, 1:2] - kp_r.xy[None, :, 1])
    row_ok = dv <= row_win[:, None]
    disp = kp_l.xy[:, 0:1] - kp_r.xy[None, :, 0]
    max_d = cam.fx   # maxD = bf / baseline = fx
    disp_ok = (disp > 0.0) & (disp <= max_d)
    oct_ok = torch.abs(kp_l.octave[:, None] - kp_r.octave[None, :]) <= 1
    mask = row_ok & disp_ok & oct_ok

    best_j, best_d, _ = hamming.best_and_second(dist, mask)
    matched = best_d <= hamming.TH_HIGH
    ur0 = kp_r.xy[best_j.clamp(0, kp_r.n - 1), 0]

    ur = _sad_subpixel(pyr_l, pyr_r, kp_l.xy, ur0, scale_factor, level_budgets)
    disparity = kp_l.xy[:, 0] - ur
    matched = matched & (disparity > 0.01) & (disparity <= max_d)
    depth = cam.bf / torch.clamp(disparity, min=0.01)

    # median-consistency sweep: drop matches whose distance exceeds
    # 1.5 * 1.4 * the median matched distance
    d_sorted = torch.sort(torch.where(matched, best_d, hamming.INVALID_DIST)).values
    n_m = matched.sum()
    # a gather, not an index by a 0-d tensor, which reads the index on the
    # host (and so cannot enter a CUDA graph)
    median = d_sorted.gather(0, torch.clamp(n_m // 2, min=0).reshape(1))[0].to(torch.float32)
    keep = matched & (best_d.to(torch.float32) <= 1.5 * 1.4 * median)
    neg = torch.full_like(ur, -1.0)
    return torch.where(keep, ur, neg), torch.where(keep, depth, neg)


def _patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
             height: int, width: int) -> torch.Tensor:
    """[K] window corners (already inside the image) -> [K, height, width]."""
    w = img.shape[1]
    rows = y0[:, None] + torch.arange(height, device=img.device)
    cols = x0[:, None] + torch.arange(width, device=img.device)
    return img.reshape(-1)[rows[:, :, None] * w + cols[:, None, :]]


def _sad_level(bl: torch.Tensor, br: torch.Tensor, xy: torch.Tensor,
               ur0: torch.Tensor, s: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level's SAD refinement over a keypoint block.

    bl/br: [lh, lw] blurred left/right level images; xy: [K, 2] level-0 left
    keypoints; ur0: [K] level-0 right x of the Hamming match; s: the level's
    scale. -> (refined uR [K] in level-0 coords, safe [K]: the windows lie
    inside the image without clamping)."""
    lh, lw = bl.shape
    xl = torch.round(xy[:, 0] / s).to(torch.int64)
    yl = torch.round(xy[:, 1] / s).to(torch.int64)
    xr0 = torch.round(ur0 / s).to(torch.int64)
    safe = ((yl >= SAD_W) & (yl < lh - SAD_W) & (xl >= SAD_W) & (xl < lw - SAD_W)
            & (xr0 >= SAD_W + SAD_SLIDE) & (xr0 < lw - SAD_W - SAD_SLIDE))
    # window starts clamped into the image, as jax.lax.dynamic_slice does
    y0 = torch.clamp(yl - SAD_W, 0, lh - _WIN)
    pl = _patches(bl, y0, torch.clamp(xl - SAD_W, 0, lw - _WIN), _WIN, _WIN)
    pr = _patches(br, y0, torch.clamp(xr0 - SAD_W - SAD_SLIDE, 0, lw - _STRIP),
                  _WIN, _STRIP)
    # centre-normalised, like the reference (IL - IL.center)
    pl = pl - pl[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    wins = pr.unfold(2, _WIN, 1)                               # [K, 11, 11 offsets, 11]
    wins = wins - pr[:, SAD_W, SAD_W:SAD_W + 2 * SAD_SLIDE + 1][:, None, :, None]
    sad = torch.abs(pl[:, :, None, :] - wins).sum(dim=(1, 3))  # [K, 11]
    best = torch.argmin(sad, dim=1)                           # first minimum
    interior = (best > 0) & (best < 2 * SAD_SLIDE)
    bm1 = sad.gather(1, torch.clamp(best - 1, min=0)[:, None])[:, 0]
    b0 = sad.gather(1, best[:, None])[:, 0]
    bp1 = sad.gather(1, torch.clamp(best + 1, max=2 * SAD_SLIDE)[:, None])[:, 0]
    denom = torch.clamp(2.0 * (bm1 + bp1 - 2.0 * b0), min=1e-6)
    delta = torch.clamp((bm1 - bp1) / denom, -1.0, 1.0)
    delta = torch.where(interior, delta, torch.zeros_like(delta))
    ur_lvl = (xr0.to(torch.float32) + (best - SAD_SLIDE).to(torch.float32) + delta) * s
    return ur_lvl, safe


def _sad_subpixel(pyr_l: Sequence[torch.Tensor], pyr_r: Sequence[torch.Tensor],
                  xy: torch.Tensor, ur0: torch.Tensor, scale_factor: float,
                  level_budgets: Sequence[int]) -> torch.Tensor:
    """SAD refinement of every keypoint on its own level's blurred images,
    each level on its contiguous block of ``level_budgets[level]`` slots.
    A keypoint whose windows would leave the image keeps ``ur0``.
    -> refined uR [N] in level-0 coords."""
    outs = []
    start = 0
    for level, b in enumerate(level_budgets):
        if b == 0:
            continue
        blk = slice(start, start + b)
        ur_lvl, safe = _sad_level(pyr_l[level], pyr_r[level], xy[blk], ur0[blk],
                                  scale_factor ** level)
        outs.append(torch.where(safe, ur_lvl, ur0[blk]))
        start += b
    return torch.cat(outs)
