#!/usr/bin/env python3
"""Which slots the describe kernel and its plain version disagree on, and why.

Builds the stereo pair's 16-level describe table of chip_smoke.py phase 13
(frame 0 of circuit2, room world, seed 9, at KITTI 00 geometry 1241x376 with
2000 features and 8 levels) and the 8-level table of phase 3 (frame 0 of the
640x480 shuttle drive), runs the CUDA kernel and the plain PyTorch version on
the card, and prints for every slot whose descriptor or angle differs: the
image, level, keypoint position, distance to the nearest border, both angles
and the moments m10/m01 in each order below.

It then recomputes every slot's moments in three summation orders and says
which one gives the kernel's angles bit for bit:

- ``torch_sum``: torch's own reductions on the card (column sums, then a
  sum over columns; the m01 products summed over the whole patch), which
  the plain version once used and which rounds otherwise on non-integer
  pixels;
- ``rows``: the kernel's order with every product and sum rounded on its
  own: each column summed over its rows in row order, then a 5-step halving
  tree over the 32 lanes (lane 31 empty), on the host;
- ``rows_fma``: the same order with ``m01 = fma(dy, v, m01)``, the order the
  kernel states and the plain version (``cuda_orb._moments_plain``)
  repeats, on the host.

    python3 orbslam2_tpu_torch/tools/describe_diff.py

Needs a GPU; no CPU fallback. The last line is one JSON object.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))  # the repository root

from orbslam2_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402
from orbslam2_tpu_torch.ops import cuda_orb, orb  # noqa: E402

KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241,
                 height=376, bf=386.1448)
VGA_CAM = dict(fx=520.0, fy=520.0, cx=320.0, cy=240.0, width=640, height=480, bf=40.0)
H = cuda_orb.HALF_PATCH


def host_moments(raw: np.ndarray, ys: np.ndarray, xs: np.ndarray, fma: bool):
    """m10, m01 per keypoint in the kernel's order, float32 throughout."""
    h, w = raw.shape
    y = np.clip(ys, H, h - 1 - H)
    x = np.clip(xs, H, w - 1 - H)
    off = np.arange(-H, H + 1)
    col_sum = np.zeros((len(y), 32), np.float32)
    m01 = np.zeros((len(y), 32), np.float32)
    dx = np.zeros(32, np.float32)
    dx[:31] = off
    dx[31] = 16.0
    for r, dy in enumerate(off):
        inside = np.zeros(32, bool)
        inside[:31] = off * off + dy * dy <= H * H
        v = np.zeros((len(y), 32), np.float32)
        v[:, :31] = raw[(y + dy)[:, None], x[:, None] + off[None, :]]
        col_sum = np.where(inside, col_sum + v, col_sum).astype(np.float32)
        if fma:   # one rounding of dy * v + m01
            nxt = (np.float64(dy) * v.astype(np.float64) + m01.astype(np.float64)
                   ).astype(np.float32)
        else:
            nxt = (m01 + np.float32(dy) * v).astype(np.float32)
        m01 = np.where(inside, nxt, m01).astype(np.float32)
    m10 = (dx * col_sum).astype(np.float32)
    for half in (16, 8, 4, 2, 1):
        m10 = (m10[:, :half] + m10[:, half:2 * half]).astype(np.float32)
        m01 = (m01[:, :half] + m01[:, half:2 * half]).astype(np.float32)
    return m10[:, 0], m01[:, 0]


def torch_sum_moments(raw: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """The moments through torch's own reductions, in no stated order."""
    h, w = raw.shape
    y = ys.long().clamp(H, h - 1 - H)
    x = xs.long().clamp(H, w - 1 - H)
    off = torch.arange(-H, H + 1, device=raw.device)
    dyy, dxx = torch.meshgrid(off, off, indexing="ij")
    disc = (dxx * dxx + dyy * dyy) <= H * H
    idx = (y[:, None, None] + dyy) * w + (x[:, None, None] + dxx)
    patches = raw.reshape(-1)[idx] * disc.to(raw.dtype)
    m10 = (patches.sum(dim=1) * off.to(raw.dtype)).sum(dim=1)
    m01 = (patches * dyy.to(raw.dtype)).sum(dim=(1, 2))
    return m10, m01


def examine(name, ex, images) -> dict:
    per_image = [ex._levels(img) for img in images]
    raws, blurs, ys, xs = ([v for lv in per_image for v in lv[i]] for i in range(4))
    budgets = list(ex.level_budgets) * len(images)
    args = (raws, blurs, ys, xs, ex.pattern_t, budgets)
    ang_k, desc_k = cuda_orb.fused_orient_describe_levels(*args)
    ang_p, desc_p = cuda_orb.fused_orient_describe_levels_plain(*args)
    torch.cuda.synchronize()
    ham = np.unpackbits((desc_k ^ desc_p).cpu().numpy().view(np.uint8), axis=1).sum(1)
    ang_k, ang_p = ang_k.cpu().numpy(), ang_p.cpu().numpy()
    n_levels = ex.config.n_levels
    order_hits = {"torch_sum": 0, "rows": 0, "rows_fma": 0}
    n_kp = 0
    non_integer = 0
    rows = []
    offset = 0
    for lv_i, (raw, y, x, budget) in enumerate(zip(raws, ys, xs, budgets)):
        k = y.shape[0]
        sl = slice(offset, offset + k)
        raw_h = raw.cpu().numpy()
        non_integer += int((raw_h != np.round(raw_h)).sum())
        y_h, x_h = y.cpu().numpy(), x.cpu().numpy()
        pm10, pm01 = torch_sum_moments(raw, y, x)
        cand = {"torch_sum": (pm10, pm01)}
        for key, fma in (("rows", False), ("rows_fma", True)):
            m10, m01 = host_moments(raw_h, y_h, x_h, fma)
            cand[key] = (torch.as_tensor(m10).cuda(), torch.as_tensor(m01).cuda())
        for key, (m10, m01) in cand.items():
            order_hits[key] += int((torch.atan2(m01, m10).cpu().numpy() == ang_k[sl]).sum())
        n_kp += k
        hh, ww = raw_h.shape
        for j in np.flatnonzero((ham[sl] > 0) | (ang_k[sl] != ang_p[sl])):
            if ham[offset + j] == 0 and abs(ang_k[offset + j] - ang_p[offset + j]) < 1e-5:
                continue     # print the descriptor flips and the larger angle gaps
            yy, xx = int(y_h[j]), int(x_h[j])
            rows.append(dict(image=lv_i // n_levels, level=lv_i % n_levels, y=yy, x=xx,
                             border=min(yy, xx, hh - 1 - yy, ww - 1 - xx),
                             bits=int(ham[offset + j]),
                             angle_kernel=float(ang_k[offset + j]),
                             angle_plain=float(ang_p[offset + j]),
                             m10_torch_sum=float(pm10[j]), m01_torch_sum=float(pm01[j]),
                             m10_rows=float(cand["rows"][0][j]),
                             m01_rows=float(cand["rows"][1][j]),
                             m01_rows_fma=float(cand["rows_fma"][1][j])))
        offset += budget
    d_ang = np.abs(np.arctan2(np.sin(ang_k - ang_p), np.cos(ang_k - ang_p)))
    print(f"[{name}] {len(images)} image(s), {len(raws)} levels, {n_kp} keypoints; "
          f"descriptors differing {int((ham > 0).sum())}, max bits {int(ham.max())}; "
          f"max angle gap {d_ang.max():.3e} rad; level pixels off the integers "
          f"{non_integer}", flush=True)
    for r in rows:
        print("  " + json.dumps(r), flush=True)
    print(f"  kernel angles reproduced bit for bit by each order: "
          + ", ".join(f"{k} {v}/{n_kp}" for k, v in order_hits.items()), flush=True)
    return dict(keypoints=n_kp, descriptors_differing=int((ham > 0).sum()),
                max_angle_gap=float(d_ang.max()), off_integer_pixels=non_integer,
                order_hits=order_hits, slots=rows)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__}", flush=True)
    cuda_orb.build_kernels(force=True)
    cfg = orb.ORBConfig(n_features=2000, n_levels=8)
    out = {}
    kcam = PinholeCamera(**KITTI_CAM)
    left, right, _ = SyntheticSequence(kcam, n_frames=420, trajectory="circuit2", seed=9,
                                       world="room").render_stereo(0)
    ex = orb.ORBExtractor(cfg, (kcam.height, kcam.width))
    out["kitti_16_levels"] = examine(
        "kitti 16 levels", ex, [torch.as_tensor(a, dtype=torch.float32).cuda()
                                for a in (left, right)])
    vcam = PinholeCamera(**VGA_CAM)
    gray, _ = SyntheticSequence(vcam, n_frames=60, trajectory="shuttle", seed=3,
                                world="cluttered").render(0)
    ex = orb.ORBExtractor(cfg, (vcam.height, vcam.width))
    out["vga_8_levels"] = examine("640x480 8 levels", ex,
                                  [torch.as_tensor(gray, dtype=torch.float32).cuda()])
    print(smi, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
