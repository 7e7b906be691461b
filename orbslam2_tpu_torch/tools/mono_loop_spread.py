#!/usr/bin/env python3
"""The spread of chip_smoke.py phase 17c over repeated drives on one card.

    python3 orbslam2_tpu_torch/tools/mono_loop_spread.py [RUNS]

Phase 17c (tests/test_mono_extra.py::test_circuit_loop_fix_scale_false at
640x480 / 2000 / 8: circuit3, 200 frames, the 10 000-word vocabulary, the
worker waited for after each frame) is driven RUNS times (default 8), each
with a new SLAMSystem, through the script's own ``drive_mono_loop``. The
drive is chaotic: atomic float sums in the card's solves and the order in
which the worker's loop stage and the tracker take the map lock differ from
run to run, and a keyframe more or less moves the frame where the loop
closes. Each run prints the keyframe frame of the loop correction, the
frames lost after initialization, the scale errors and ATE phase 17c
gates on, and which gates it would fail (a failure is recorded here instead
of ending the run). The last line is one JSON object. Needs a GPU.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))  # the repository root

import chip_smoke  # noqa: E402
from orbslam2_tpu_torch.frontend import loop_closing  # noqa: E402
from orbslam2_tpu_torch.ops import cuda_orb  # noqa: E402
from orbslam2_tpu_torch.place.pretrained import get_large_vocabulary  # noqa: E402
from orbslam2_tpu_torch.slammap import native  # noqa: E402


class GateFailed(Exception):
    pass


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mono_loop_spread.py measures phase 17c on a GPU only")
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    cuda_orb.build_kernels(force=True)
    native.build(force=True)
    cam = chip_smoke.PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                                   width=640, height=480, bf=40.0)
    orb_cfg = chip_smoke.orb.ORBConfig(n_features=2000, n_levels=8)
    voc = get_large_vocabulary()
    failed, loop_frames = [], []

    def record(msg):
        failed.append(msg)
        if "loops closed at full width" in msg or "did not become idle" in msg:
            raise GateFailed(msg)     # nothing after it can be measured

    chip_smoke.fail = record
    correct = loop_closing.LoopCloser._correct_loop

    def logged(self, kf, loop_kf, s_cw, w):
        loop_frames.append(int(self.map.kf_frame_id[kf]))
        return correct(self, kf, loop_kf, s_cw, w)

    loop_closing.LoopCloser._correct_loop = logged
    out = []
    for k in range(runs):
        failed.clear()
        loop_frames.clear()
        t0 = time.perf_counter()
        try:
            d, system, _ = chip_smoke.drive_mono_loop(cam, orb_cfg, voc)
            system.shutdown()
        except GateFailed:
            d = {}
        row = dict(run=k, loop_keyframe_frames=list(loop_frames),
                   lost_after_init=d.get("lost_after_init"), keyframes=d.get("keyframes"),
                   pre_frames=d.get("pre_frames"), pre_scale=d.get("pre_scale"),
                   window_scale=d.get("window_scale"), full_scale=d.get("full_scale"),
                   ate_sim3_m=d.get("ate_sim3_m"), gates_failed=list(failed),
                   seconds=time.perf_counter() - t0)
        out.append(row)
        print(f"[spread] run {k}: {json.dumps(row)}", flush=True)
    n_fail = sum(bool(r["gates_failed"]) for r in out)
    full = np.array([r["full_scale"] - r["pre_scale"] for r in out
                     if r["full_scale"] is not None])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "runs": runs,
                      "runs_failing_a_gate": n_fail,
                      "full_minus_pre_scale": full.tolist(), "rows": out}), flush=True)


if __name__ == "__main__":
    main()
