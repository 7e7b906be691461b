#!/usr/bin/env python3
"""The spread of chip_smoke.py phase 14's defaults drive over repeated drives
on one card.

    python3 orbslam2_tpu_torch/tools/defaults_drive_spread.py [RUNS] [--root DIR]

Phase 14's first drive (phase 5's 60 frames at 640x480 / 2000 / 8 with every
``SLAMConfig`` default: the pipelined fetch, the mapping worker) is driven
RUNS times (default 6) in this process, each with a new SLAMSystem, through
the script's own ``drive_defaults_rgbd`` with its ATE gate switched off, so
that a drive that ends far off is counted instead of ending the run. The
drive depends on the order in which the worker and the tracker meet, so its
ATE spreads. ``--root`` imports ``chip_smoke.py`` and the port from another
tree (an unpacked ``git archive`` of a parent commit), to compare two trees
on one card. Each drive prints one line; the last line is one JSON object.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("runs", type=int, nargs="?", default=6)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the tree to import (default: this repository)")
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("defaults_drive_spread.py measures phase 14 on a GPU only")
    sys.path.insert(0, os.path.abspath(a.root))
    import chip_smoke
    from orbslam2_tpu_torch.ops import cuda_orb
    from orbslam2_tpu_torch.slammap import native

    cuda_orb.build_kernels(force=True)
    native.build(force=True)
    chip_smoke.ATE_MAX_M = float("inf")
    cam = chip_smoke.PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                                   width=640, height=480, bf=40.0)
    orb_cfg = chip_smoke.orb.ORBConfig(n_features=2000, n_levels=8)
    seq = chip_smoke.SyntheticSequence(cam, n_frames=chip_smoke.N_FRAMES,
                                       trajectory="shuttle", seed=3, world="cluttered")
    frames = [seq.render(i) for i in range(chip_smoke.N_FRAMES)]
    runs = []
    for k in range(a.runs):
        out, _ = chip_smoke.drive_defaults_rgbd(
            "defaults", chip_smoke.defaults_config(cam, orb_cfg), frames, seq)
        runs.append(dict(ate_m=out["ate_m"], tracked=out["tracked"],
                         retracked_frames=out["retracked_frames"]))
        print(f"run {k}: ATE {out['ate_m']:.4f} m, {out['tracked']} tracked, "
              f"{out['retracked_frames']} frames tracked again", flush=True)
    print(json.dumps({"root": os.path.abspath(a.root), "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
