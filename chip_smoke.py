#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

1. device   card name and power limit (nvidia-smi), torch and CUDA versions
2. build    compile the CUDA kernel library from orbslam2_tpu_torch/csrc/
3. kernel   the fused orientation+BRIEF kernel against its plain PyTorch
            version on the card: per level, all 8 pyramid levels of a rendered
            640x480 frame with the extractor's own keypoints and keypoints
            hugging every margin at widths 640, 200 and 1241; then the
            all-levels launch on the 8 levels (2000 slots) and on one table
            that mixes the three edge geometries with a level whose keypoints
            fall short of its budget; then the times: wrapper calls by CUDA
            events (host-paced), the kernel's own duration on the card, eight
            one-level calls, the plain version, the bytes bound and the
            duration of an empty kernel on the same grid
4. main     60 frames of the 640x480 / 2000-feature / 8-level RGB-D drive
            (shuttle trajectory, cluttered world) through
            SLAMSystem.track_rgbd on the card, with the kernel's launch count
            (one per frame), tracked frames, keyframes, map points, ATE, ms
            per frame and the SM clock sampled beside the drive

Then one JSON line {"kernels": [...]}, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, TrackingState
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io.evaluate import ate_rmse
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops import cuda_orb, orb
from orbslam2_tpu_torch.system import SLAMSystem, Sensor
from orbslam2_tpu_torch.utils.profiling import event_ms, kernel_device_ms, queued_ms

# angle and descriptor tolerances between the kernel and its plain version:
# both round the same float32 arithmetic, but sum the 709 disc pixels in
# another order, so an angle differs by float32 noise and a sample offset
# that lands within that noise of a half-integer may round the other way
# (a few bits of 256). These are the JAX package's own limits between its
# twin paths.
ANGLE_TOL_RAD = 1e-3
HAMMING_MEDIAN_MAX = 4
HAMMING_MAX = 40

ATE_MAX_M = 0.10
N_FRAMES = 60
WARM_FRAMES = 5           # frames before the timed steady-state window

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# operations per keypoint: 709 disc pixels x (add + multiply-add) for the two
# moments, 512 samples x (4 multiplies + 2 adds to rotate, 2 roundings,
# 1 quantisation) and 256 comparisons
OPS_PER_KEYPOINT = 709 * 3 + 512 * 9 + 256


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check_no_jax(when: str) -> None:
    if "jax" in sys.modules or "orbslam2_tpu" in sys.modules:
        fail(f"the port imported jax or the JAX package ({when})")


def hamming_rows(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Per-row bit differences of two [K, 8] int32 descriptor tensors."""
    x = (a ^ b).cpu().numpy().view(np.uint8)
    return np.unpackbits(x, axis=1).sum(axis=1)


def compare(name, kernel_out, plain_out) -> dict:
    ang_k, desc_k = kernel_out
    ang_p, desc_p = plain_out
    if ang_k.shape != ang_p.shape or desc_k.shape != desc_p.shape:
        fail(f"{name}: shape mismatch")
    if not torch.isfinite(ang_k).all():
        fail(f"{name}: non-finite angle")
    d = torch.atan2(torch.sin(ang_k - ang_p), torch.cos(ang_k - ang_p)).abs()
    max_ang = float(d.max()) if d.numel() else 0.0
    ham = hamming_rows(desc_k, desc_p)
    stats = dict(k=int(ham.size), max_angle_err=max_ang,
                 ham_median=float(np.median(ham)) if ham.size else 0.0,
                 ham_max=int(ham.max()) if ham.size else 0,
                 ham_exact_share=float((ham == 0).mean()) if ham.size else 1.0)
    print(f"  {name}: K={stats['k']} max|dangle|={max_ang:.2e} rad "
          f"hamming median={stats['ham_median']:.0f} max={stats['ham_max']} "
          f"exact={stats['ham_exact_share']:.3f}", flush=True)
    if max_ang >= ANGLE_TOL_RAD:
        fail(f"{name}: angle differs by {max_ang} rad (limit {ANGLE_TOL_RAD})")
    if stats["ham_median"] > HAMMING_MEDIAN_MAX or stats["ham_max"] > HAMMING_MAX:
        fail(f"{name}: descriptors differ (median {stats['ham_median']}, "
             f"max {stats['ham_max']})")
    return stats


class ClockSampler:
    """The card's SM clock every 250 ms, by a background nvidia-smi that is
    stopped on exit: at a few percent duty the clock is part of the result."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "250"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.mhz = []
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out = self.proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out = self.proc.communicate()[0]
        self.mhz = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]


def edge_level(ex, h, w, dev):
    """A smoothed-noise level of h x w with keypoints hugging every margin and
    two out-of-margin slots, as the extractor's invalid slots give them.
    -> (raw, blur, ys, xs) with int32 coordinates."""
    m = orb.EDGE_MARGIN
    rng = np.random.default_rng(11)
    noise = torch.as_tensor(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    raw = orb._separable_conv(noise, orb.gaussian_kernel1d(1.5, 3)).contiguous()
    blur = orb._separable_conv(raw, ex.blur_kernel).contiguous()
    xs_list = [m, m + 1, w - m - 1, w - m - 2] + list(range(m, w - m, 61))
    ys_list = [m, m + 1, h - m - 1, h - m - 2] + [h // 2] * max(0, len(xs_list) - 4)
    n = min(len(xs_list), len(ys_list))
    xs = torch.tensor(xs_list[:n] + [0, w - 1], dtype=torch.int32, device=dev)
    ys = torch.tensor(ys_list[:n] + [0, h - 1], dtype=torch.int32, device=dev)
    return raw, blur, ys, xs


def check_kernel(ex, frame0) -> dict:
    """Phase 3: the kernel against its plain version on the card, then its
    times. -> the kernel's measured entries of the `kernels` line."""
    print("[kernel] fused_orient_describe vs its plain PyTorch version", flush=True)
    dev = torch.device("cuda")
    pat = ex.pattern_t
    n_levels = ex.config.n_levels
    budgets = ex.level_budgets
    raws, blurs, ys64, xs64 = [], [], [], []   # as the main path passes them
    img = torch.as_tensor(frame0, dtype=torch.float32).to(dev)
    for level in range(n_levels):
        if level > 0:
            img = orb._resize_bilinear(img, ex.level_shapes[level])
        raws.append(img.contiguous())
        blurs.append(orb._separable_conv(img, ex.blur_kernel).contiguous())
        ys, xs, _, valid = ex._select_level(img, level)
        ys64.append(ys)
        xs64.append(xs)
        print(f"  level {level}: {tuple(img.shape)} K={ys.shape[0]} "
              f"budget={budgets[level]} valid={int(valid.sum())}", flush=True)
    ys32 = [y.to(torch.int32) for y in ys64]
    xs32 = [x.to(torch.int32) for x in xs64]
    edges = [edge_level(ex, h, w, dev) for h, w in ((480, 640), (96, 200), (120, 1241))]

    # ---- per level: a table of one entry through the kernel ----
    def both(raw, blur, ys, xs):
        return (cuda_orb.fused_orient_describe(raw, blur, ys, xs, pat),
                cuda_orb.fused_orient_describe_plain(raw, blur, ys, xs, pat))

    per_level = [both(*args) for args in zip(raws, blurs, ys32, xs32)]
    stats = [compare(f"level {level}", *pair) for level, pair in enumerate(per_level)]
    stats += [compare(f"edge {raw.shape[0]}x{raw.shape[1]}", *both(raw, blur, ys, xs))
              for raw, blur, ys, xs in edges]

    # ---- all levels in one launch ----
    frame_args = (raws, blurs, ys64, xs64, pat, budgets)
    all_k = cuda_orb.fused_orient_describe_levels(*frame_args)
    stats.append(compare(f"all {n_levels} levels, one launch", all_k,
                         cuda_orb.fused_orient_describe_levels_plain(*frame_args)))
    if all_k[0].shape[0] != ex.n_total:
        fail(f"one launch gave {all_k[0].shape[0]} slots, expected {ex.n_total}")
    if any(y.shape[0] != b for y, b in zip(ys64, budgets)):
        print("  (a level of this frame has fewer candidates than budget)", flush=True)
    else:
        # same kernel, same inputs: the frame-wide arrays must be the
        # per-level results in the extractor's slot order, bit for bit
        if not (torch.equal(all_k[0], torch.cat([k[0] for k, _ in per_level]))
                and torch.equal(all_k[1], torch.cat([k[1] for k, _ in per_level]))):
            fail("one launch differs from the eight per-level launches")

    # three widths in one table, the middle level 7 slots short of its budget
    mixed = tuple(list(v) for v in zip(*edges))
    mixed_budgets = [e[2].shape[0] for e in edges]
    mixed_budgets[1] += 7
    mixed_args = (*mixed, pat, mixed_budgets)
    mixed_k = cuda_orb.fused_orient_describe_levels(*mixed_args)
    stats.append(compare("mixed edge table (480x640, 96x200 short of budget, 120x1241)",
                         mixed_k, cuda_orb.fused_orient_describe_levels_plain(*mixed_args)))
    pad = slice(mixed_budgets[0] + mixed_budgets[1] - 7, mixed_budgets[0] + mixed_budgets[1])
    if bool((mixed_k[0][pad] != 0).any()) or bool((mixed_k[1][pad] != 0).any()):
        fail("a slot past a level's keypoints was not written as zero")
    torch.cuda.synchronize()   # a fault during a launch surfaces here

    # ---- times, all at the main path's shapes ----
    def run_levels():
        cuda_orb.fused_orient_describe_levels(*frame_args)

    def run_eight():
        for args in zip(raws, blurs, ys32, xs32):
            cuda_orb.fused_orient_describe(*args, pat)

    def run_plain():
        cuda_orb.fused_orient_describe_levels_plain(*frame_args)

    table = cuda_orb.build_level_table(*frame_args[:4], budgets)
    scratch = torch.zeros(1, dtype=torch.float32, device=dev)

    def run_empty():
        cuda_orb.launch_empty_kernel(table, scratch)

    with ClockSampler() as clocks:
        # plain, kernel, kernel, plain on the one card; the images (6.4 MB for
        # all levels) stay in the 50 MB L2 between launches, as on the main path
        plain_a = event_ms(run_plain, 10)
        kernel_a = event_ms(run_levels, 200)
        eight_a = event_ms(run_eight, 50)
        eight_b = event_ms(run_eight, 50)
        kernel_b = event_ms(run_levels, 200)
        plain_b = event_ms(run_plain, 10)
        # the card's own time: kernel durations from the profiler's trace, and
        # events around launches queued behind a spin kernel that hides the host
        traced_ms, traced_n = kernel_device_ms(run_levels, 50, "orient_describe_kernel")
        traced8_ms, traced8_n = kernel_device_ms(run_eight, 20, "orient_describe_kernel")
        floor_traced_ms, _ = kernel_device_ms(run_empty, 50, "orient_describe_empty_kernel")
        if traced8_ms is not None:
            traced8_ms *= n_levels   # mean of one launch -> a frame's eight
        queued = queued_ms(run_levels, 50)
        queued8 = queued_ms(run_eight, 20)
        floor_queued = queued_ms(run_empty, 50)
    kernel_ms = 0.5 * (kernel_a + kernel_b)
    eight_ms = 0.5 * (eight_a + eight_b)
    plain_ms = 0.5 * (plain_a + plain_b)
    if traced_ms is not None and traced8_ms is not None and floor_traced_ms is not None:
        method = (f"torch.profiler: the kernel's mean duration on the card times its "
                  f"launches per frame ({traced_n} and {traced8_n} kernels traced)")
        device_ms, eight_device_ms, floor_ms = traced_ms, traced8_ms, floor_traced_ms
    else:
        method = ("CUDA events around launches queued behind a spin kernel "
                  "(the profiler's trace held no device time)")
        device_ms, eight_device_ms, floor_ms = queued, queued8, floor_queued

    n_kp = sum(y.numel() for y in ys64)
    # each image read once; per keypoint two int64 coordinates read; per slot
    # an angle and eight words written; the pattern and the level table once
    n_bytes = sum(2 * raw.numel() * 4 for raw in raws) + n_kp * 16 \
        + ex.n_total * 36 + 256 * 16 + cuda_orb.LEVEL_TABLE_BYTES
    n_ops = n_kp * OPS_PER_KEYPOINT
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    mhz = clocks.mhz or [float("nan")]
    print(f"  per frame (1 launch, {ex.n_total} slots, {n_kp} keypoints):\n"
          f"    ms {kernel_ms:.4f} ({kernel_a:.4f}, {kernel_b:.4f}): CUDA events around "
          f"wrapper calls, one a frame; host-paced (the card finishes a launch before "
          f"the host sends the next)\n"
          f"    device_ms {device_ms:.5f} [{method}]\n"
          f"      traced {traced_ms}, queued behind a spin kernel {queued:.5f}\n"
          f"    eight_calls_ms {eight_ms:.4f} ({eight_a:.4f}, {eight_b:.4f}): eight one-level "
          f"calls of the same kernel, host-paced; on the card {eight_device_ms:.5f} "
          f"(traced {traced8_ms}, queued {queued8:.5f})\n"
          f"    launch_floor_ms {floor_ms:.5f}: an empty kernel on the same grid "
          f"(traced {floor_traced_ms}, queued {floor_queued:.5f})\n"
          f"    plain {plain_ms:.3f} ms ({plain_a:.3f}, {plain_b:.3f})\n"
          f"    bound {bound_ms:.5f} ms by {bound_by} ({n_bytes} bytes, {n_ops} operations); "
          f"library call: none\n"
          f"    SM clock min/median/max {min(mhz):.0f}/{np.median(mhz):.0f}/{max(mhz):.0f} MHz "
          f"({len(clocks.mhz)} samples). The level images sit in L2; the 2000 warps "
          f"(under a quarter of the card's 8448) are all resident at once and each "
          f"pulls its own two 31x31 windows from L2, so the launch lasts as long as "
          f"its slowest warp's chain of memory latencies, not the bound.", flush=True)
    return {"max_abs_err": max(s["max_angle_err"] for s in stats),
            "descriptor_exact_share_min": min(s["ham_exact_share"] for s in stats),
            "ms": kernel_ms, "device_ms": device_ms, "device_ms_method": method,
            "device_ms_queued": queued, "eight_calls_ms": eight_ms,
            "eight_calls_device_ms": eight_device_ms, "launch_floor_ms": floor_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "ms_covers": "one frame: one launch for all pyramid levels, timed by CUDA "
                         "events around wrapper calls (host-paced); device_ms is the "
                         "kernel's own duration on the card"}


def drive_main_path(system, frames, seq) -> dict:
    """Phase 4: the drive through SLAMSystem.track_rgbd and its checks.
    -> the main path's measured entries of the `kernels` line."""
    print("[main] SLAMSystem.track_rgbd, 640x480 / 2000 features / 8 levels", flush=True)
    tracker = system.tracker
    cuda_orb.fused_orient_describe.launches = 0
    frame_ms = []
    tracked = fused_frames = 0
    first_ok = t_steady = None
    with ClockSampler() as clocks:
        for i, (gray, depth) in enumerate(frames):
            if i == WARM_FRAMES:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            before = cuda_orb.fused_orient_describe.launches
            t_frame = time.perf_counter()
            tcw = system.track_rgbd(gray, depth, i / seq.fps)
            frame_ms.append((time.perf_counter() - t_frame) * 1e3)  # ends in a fetch
            built = cuda_orb.fused_orient_describe.launches - before
            if built != 1:
                fail(f"frame {i}: {built} kernel launches, expected 1")
            # the fused step leaves its associations on the card as the carry
            # (cleared again on frames that insert a keyframe)
            fused_frames += tracker._last_pid_dev is not None
            if tcw is not None:
                tracked += 1
                if first_ok is None:
                    first_ok = i
            elif first_ok is not None:
                fail(f"frame {i} lost after initialisation at frame {first_ok}")
        torch.cuda.synchronize()
        ms_per_frame = (time.perf_counter() - t_steady) / (N_FRAMES - WARM_FRAMES) * 1e3
    launches = cuda_orb.fused_orient_describe.launches
    steady = np.array(frame_ms[WARM_FRAMES:])

    if first_ok is None or system.tracking_state() != TrackingState.OK:
        fail("the system did not initialise")
    lf = tracker.last_frame
    mir = system.map.device_mirror(tracker.device)
    on_card = [lf.ur, lf.depth, *mir.arrays.values(),
               *(getattr(lf.kp, f) for f in ("xy", "response", "angle", "octave",
                                             "size", "desc", "valid"))]
    if tracker._last_pid_dev is not None:
        on_card.append(tracker._last_pid_dev)
    if fused_frames < N_FRAMES // 2:
        fail(f"only {fused_frames} frames went through the fused step")
    if any(t.device.type != "cuda" for t in on_card):
        fail("a tensor of the fused step is not on the card")
    if launches != N_FRAMES:
        fail(f"{launches} launches on the main path, expected {N_FRAMES}")
    lost = tracker.trajectory_lost_mask()
    if lost[first_ok:].any():
        fail(f"lost frames after initialisation: {np.where(lost)[0].tolist()}")
    est = tracker.full_trajectory_twc()
    gt = np.stack([np.linalg.inv(seq.poses[i]) for i in range(N_FRAMES)])
    if not np.isfinite(est).all() or est.shape != (N_FRAMES, 4, 4):
        fail("trajectory is not finite or has the wrong shape")
    ate = ate_rmse(est[first_ok:], gt[first_ok:])
    mhz = clocks.mhz or [float("nan")]
    print(f"  frames tracked {tracked}/{N_FRAMES}, keyframes {system.map.n_keyframes()}, "
          f"map points {system.map.n_points()}, ATE-RMSE {ate:.4f} m, "
          f"{ms_per_frame:.2f} ms per steady-state frame "
          f"(frames {WARM_FRAMES}..{N_FRAMES - 1}, host clock around a synchronised loop), "
          f"median {np.median(steady):.2f} ms, p95 {np.percentile(steady, 95):.2f} ms; "
          f"kernel launches {launches}, fused frames {fused_frames}; "
          f"SM clock over the drive min/median/max "
          f"{min(mhz):.0f}/{np.median(mhz):.0f}/{max(mhz):.0f} MHz "
          f"({len(clocks.mhz)} samples)", flush=True)
    print(tracker.stats.report(), flush=True)
    if ate > ATE_MAX_M:
        fail(f"ATE {ate:.4f} m above {ATE_MAX_M} m")
    return {"launches": launches, "launches_per_frame": launches // N_FRAMES,
            "main_path_ms_per_frame": ms_per_frame,
            "main_path_median_ms": float(np.median(steady)),
            "sm_clock_mhz_median": float(np.median(mhz)), "ate_m": ate}


def main() -> None:
    # ---- phase 1: device --------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py measures the port on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {smi_line} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    check_no_jax("at start")

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib_path = cuda_orb.build_kernels(force=True, ptxas_verbose=True)
    print(f"[build] {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)

    cam = PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                        width=640, height=480, bf=40.0)
    orb_cfg = orb.ORBConfig(n_features=2000, n_levels=8)
    t0 = time.perf_counter()
    seq = SyntheticSequence(cam, n_frames=N_FRAMES, trajectory="shuttle",
                            seed=3, world="cluttered")
    frames = [seq.render(i) for i in range(N_FRAMES)]
    print(f"[render] {N_FRAMES} frames 640x480 on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phases 3 and 4 ---------------------------------------------------
    kernel = check_kernel(orb.get_extractor(orb_cfg, (cam.height, cam.width)),
                          frames[0][0])
    cfg = SLAMConfig(cam=cam, orb=orb_cfg, th_depth=6.0, max_keyframes=64,
                     max_points=16384, local_point_cap=4096,
                     max_frames_between_kf=30, min_init_features=400,
                     async_mapping=False, pipelined_fetch=False,
                     profile_stages=True)
    system = SLAMSystem(cfg, Sensor.RGBD)        # default device: the card
    main_path = drive_main_path(system, frames, seq)
    check_no_jax("after the drive")   # a lazy import on the main path shows here

    print(json.dumps({"kernels": [{
        "name": "fused_orient_describe", "route": "cuda",
        "source": "orbslam2_tpu_torch/csrc/orient_describe.cu",
        "replaces": "orbslam2_tpu/ops/pallas_orb.py:196",
        **kernel, **main_path}]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
