#!/usr/bin/env python3
"""The describe kernel of this checkout against other versions of its source,
timed in turns in one process on one card.

    python3 orbslam2_tpu_torch/tools/describe_ab.py OTHER.cu [OTHER.cu ...]

An earlier version of the kernel comes from git, into a directory that git
ignores, for example

    mkdir -p build/ab
    git show REV:orbslam2_tpu_torch/csrc/orient_describe.cu > build/ab/old.cu

Each source (``csrc/orient_describe.cu`` of this checkout first, then the
ones named) is built with the flags ``ops/cuda_orb.py`` uses into a library
of its own under ``orbslam2_tpu_torch/_build/`` and loaded with ``ctypes``;
every version must keep the level-table layout. On the tables of
``chip_smoke.py`` phases 3 (one 640x480 frame, 8 levels) and 13 (a KITTI
stereo pair, 16 levels) each version is checked against the plain version
(descriptors differing, largest angle gap) and its kernel's duration on the
card is taken by ``torch.profiler``, with L2 flushed before each launch and
with the inputs left in L2, in the order A B .. B A, twice. The last line is
one JSON object. Needs a GPU.
"""
from __future__ import annotations

import ctypes
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
from orbslam2_tpu_torch.utils.profiling import kernel_device_ms  # noqa: E402

KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241,
                 height=376, bf=386.1448)
VGA_CAM = dict(fx=520.0, fy=520.0, cx=320.0, cy=240.0, width=640, height=480, bf=40.0)
REPS = 50


def build(src: str, tag: str) -> ctypes.CDLL:
    out = os.path.join(cuda_orb._BUILD_DIR, f"libdescribe_ab_{tag}.so")
    os.makedirs(cuda_orb._BUILD_DIR, exist_ok=True)
    cmd = [cuda_orb._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.orient_describe_launch.argtypes = [ctypes.POINTER(cuda_orb.LevelTable)] + \
        [ctypes.c_void_p] * 4
    lib.orient_describe_launch.restype = ctypes.c_int
    return lib


def tables():
    cfg = orb.ORBConfig(n_features=2000, n_levels=8)
    kcam = PinholeCamera(**KITTI_CAM)
    left, right, _ = SyntheticSequence(kcam, n_frames=420, trajectory="circuit2", seed=9,
                                       world="room").render_stereo(0)
    vcam = PinholeCamera(**VGA_CAM)
    gray, _ = SyntheticSequence(vcam, n_frames=60, trajectory="shuttle", seed=3,
                                world="cluttered").render(0)
    out = {}
    for name, cam, images in (("640x480, 8 levels", vcam, [gray]),
                              ("1241x376 pair, 16 levels", kcam, [left, right])):
        ex = orb.ORBExtractor(cfg, (cam.height, cam.width))
        per_image = [ex._levels(torch.as_tensor(a, dtype=torch.float32).cuda())
                     for a in images]
        raws, blurs, ys, xs = ([v for lv in per_image for v in lv[i]] for i in range(4))
        budgets = list(ex.level_budgets) * len(images)
        args = (raws, blurs, ys, xs, ex.pattern_t, budgets)
        out[name] = (args, cuda_orb.build_level_table(raws, blurs, ys, xs, budgets),
                     cuda_orb.fused_orient_describe_levels_plain(*args))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__}", flush=True)
    sources = [os.path.join(cuda_orb._CSRC_DIR, "orient_describe.cu")] + sys.argv[1:]
    libs = [build(src, str(i)) for i, src in enumerate(sources)]
    result = {}
    for name, (args, table, (ang_p, desc_p)) in tables().items():
        pattern = args[4]
        n_total = table.n_total
        runs, checks = [], []
        for lib in libs:
            angle = torch.empty(n_total, dtype=torch.float32, device="cuda")
            desc = torch.empty((n_total, 8), dtype=torch.int32, device="cuda")

            def run(lib=lib, angle=angle, desc=desc):
                err = lib.orient_describe_launch(
                    ctypes.byref(table), pattern.data_ptr(), angle.data_ptr(),
                    desc.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            diff = np.unpackbits((desc ^ desc_p).cpu().numpy().view(np.uint8), axis=1).sum(1)
            gap = torch.atan2(torch.sin(angle - ang_p), torch.cos(angle - ang_p)).abs().max()
            checks.append(dict(descriptors_differing=int((diff > 0).sum()),
                               max_angle_gap=float(gap)))
            runs.append(run)
        order = list(range(len(libs))) + list(reversed(range(len(libs))))
        times = {i: {"flushed": [], "warm": []} for i in range(len(libs))}
        for i in order + order:
            times[i]["flushed"].append(kernel_device_ms(runs[i], REPS, "orient_describe_kernel",
                                                        flush_l2=True)[0])
            times[i]["warm"].append(kernel_device_ms(runs[i], REPS, "orient_describe_kernel")[0])
        result[name] = []
        print(f"[{name}] ({n_total} slots)", flush=True)
        for i, src in enumerate(sources):
            f, w = times[i]["flushed"], times[i]["warm"]
            entry = dict(source=src, **checks[i], device_ms_flushed=f, device_ms_warm_l2=w,
                         flushed_median=float(np.median(f)), warm_median=float(np.median(w)))
            result[name].append(entry)
            print(f"  {src}: differing {checks[i]['descriptors_differing']}, angle gap "
                  f"{checks[i]['max_angle_gap']:.2e}; device_ms flushed median "
                  f"{entry['flushed_median']:.5f} ({', '.join(f'{x:.5f}' for x in f)}), warm "
                  f"median {entry['warm_median']:.5f} ({', '.join(f'{x:.5f}' for x in w)})",
                  flush=True)
    print(smi, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
