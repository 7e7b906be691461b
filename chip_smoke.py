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
            events (host-paced), the kernel's own duration on the card with
            L2 flushed before each launch (the setting of the HBM bytes
            bound) and with its inputs left in L2, eight one-level calls,
            the plain version, the bytes bound and the duration of an empty
            kernel on the same grid
4. tracker  the first 30 frames of the 640x480 / 2000-feature / 8-level
            RGB-D drive (shuttle trajectory, cluttered world) through a
            Tracker without a local mapper (the path of the port's first
            slice), with the kernel's launch count (one per frame), tracked
            frames, keyframes, map points, ATE, ms per frame and the SM clock
            sampled beside the drive
5. main     60 frames of the same drive through SLAMSystem.track_rgbd with
            the mapping worker on (async_mapping, the default): every
            keyframe triangulated, fused, bundle-adjusted and culled on the
            worker's thread while the tracker goes on with the next frames
            (frames are sent back to back, as bench.py's bench_system sends
            them; the worker is waited for only before the trajectory is
            read). Tracked frames, keyframes created and culled, live
            points, points triangulated, observations fused, points merged,
            local BAs applied, skipped and dropped, stage conflicts, ATE, ms
            per frame, the mapper's stage times and the kernel's launch count,
            and the ids remapped to the point they were merged into, with
            those found through a slot handed out again since
            (reused_slot_ids) and those lost to a slot handed out twice
            (replacements_lost), read and not gated, as in phases 12, 14
            and 17. Fails unless every local BA of the drive ran as one
            replay of the mapper's solve program (its graphs captured once
            per padded size; phases 8, 9 and 12 hold the loop closer's
            essential-graph and global-BA programs to the same rule)
6. ba       the last local-BA problem that drive's mapper solved (caught at
            the mapper's solve program), solved
            again on the card and on the CPU in float64, as the mapper
            stages it: largest pose and point differences and the share of
            observations that change class; then the same problem in float32
            on the card, and the card's time of one solve in each precision
7. searches the mapper's triangulation (every keypoint free) and fuse
            searches on the drive's final map, on the card and on the CPU
8. keyframes the first 30 frames of the drive through SLAMSystem with the
            mapping worker and a keyframe every third frame, so that
            triangulation has free keypoints to pair, frames back to back as
            in phase 5: its counts, and a failure unless points were
            triangulated
9. place    place recognition at full width: 100 frames of the panorama
            (a 430-degree turn in the room world, 640x480 / 2000 / 8)
            through SLAMSystem.track_rgbd with the 10 000-word vocabulary,
            the mapping worker, a keyframe every fourth frame and loop
            consistency 2, paced as the verify recipe paces it (a frame
            waits while two keyframes are queued); fails unless every frame
            is tracked, a loop is closed, a global BA is applied and the ATE
            is under 0.15 m; prints the loop-closing stage times, the GBA's,
            the solve programs' captures and replays, and the longest
            tracker frame around the loop (the loop closer holds the map
            lock while it corrects). Between frames the drive waits for the
            whole device (torch.cuda.synchronize() after every frame, a
            torch.profiler started and stopped after every fifth), as a
            caller may, while the worker and the GBA thread capture; fails
            unless the local-BA and essential-graph programs captured on the
            mapping worker's thread and the GBA program on the GBA thread.
            Phases 9, 12 and 17c print each essential graph's edges and each
            global BA's observations, real and padded, beside the captures A full-width drive that closes no loop says so and the
            phase runs again at the verify geometry (320x240 / 800 / 4)
10. reloc   the phase-9 tracker set LOST without a motion model tracks a
            mapped frame again: through the keyframe database (EPnP runs),
            within 0.1 m of the true pose
11. loop    the last essential-graph and global-BA problems of phase 9
            solved again on the card and on the CPU in float64 (camera
            centres within 1e-6 m) and in float32, with times, and once
            more on the card under torch.profiler (kernel launches, device
            operations and their busy time); the word ids
            of every phase-9 keyframe computed again on the CPU must equal
            the card's
12. stereo  SLAMSystem.track_stereo at KITTI geometry (1241x376, KITTI 00
            intrinsics, 2000 features, 8 levels) and bench_kitti_full's
            capacities (1536 keyframes, 150 000 points, allocated on the
            card), the 10 000-word vocabulary, the mapping worker and loop
            consistency 2, on bench_kitti_full's 420 frames of two laps of
            the room circuit (circuit2, seed 9),
            paced by bench_kitti_full's backlog gate (a frame waits while a
            keyframe is queued); fails unless tracking starts before frame
            20 with no frame lost after it, a loop is closed, the ATE at true
            scale is under 0.25 m, the kernel is launched once per stereo
            frame build (both images in one launch) and the map-graph engine
            was loaded from orbslam2_tpu_torch/_build/; prints ms per frame,
            keyframes and points, stereo matches per frame, the mapper's,
            loop closer's and tracker's stage times (kf_covis among them) and
            the longest tracker frame around the loop
13. stereo parts  match_stereo on frame 0 on the card and on the CPU with the
            same keypoints and pyramids (matches, uR, depth against the
            renderer's truth, times, the SAD refinement's time); the
            one-launch describe of both images' 16 levels against its plain
            version, timed as in phase 3 beside one image's 8 levels; every
            native map-graph binding against its numpy plain version on
            phase 12's final map, with both times. The 16-level launch must
            give the plain version's descriptors bit for bit (0 differing
            slots), its angles within phase 3's figure
14. defaults the slice's main path: SLAMConfig's defaults (pipelined_fetch,
            fetch_batch 1, the mapping worker) at phase 5's geometry and
            capacity, phase 5's 60 frames back to back; the same with
            fetch_batch 4; then SLAMSystem.track_stereo on the first 60
            frames of phase 12's drive with phase 12's settings and the
            fetch at its defaults. Tracked frames come from the lost mask.
            Prints ATE, ms per frame (median, p95), frames tracked again and
            the kernel's launches; fails on a frame lost after
            initialisation, an RGB-D ATE above 0.10 m, or stereo tracking
            that starts at frame 20 or later. 14b: the K = 1 drive repeated
            10 times in this process on the frames already rendered, each
            with a new system shut down after it; prints each drive's ATE
            and the first frame whose rebuilt pose is past 0.05 m from the
            truth (anchored at the first tracked frame); fails on a drive
            above 0.10 m or a frame lost. 14c: a capture after a dropped
            system (tools/capture_after_drop.py): a system driven until it
            captured its frame graph and a local BA's graphs is dropped
            without shutdown(), and the last reference to its programs goes
            inside the next system's first capture under
            gc.set_threshold(1, 1, 1), so that the collector runs on the
            capturing thread; fails unless that capture succeeds, the next
            system tracks its 10 frames and the programs are freed after it
15. localization  tests/test_localization_vo.py's scenario (6 frames mapped,
            24 in localization mode, shuttle in the cluttered world, seed 9)
            at 640x480 / 2000 / 8, held to what the JAX package does there
            on the CPU (frames 27-29 lost, tests/reference_full_width.py), a
            frozen map and an RPE over the tracked frames under 0.05 m, with
            change_calibration to the same camera before frame 12 and that
            frame tracked; at the test's own 320x240 / 800 / 4, held to a
            frozen map, 22 of 24 frames tracked and an RPE under 0.05 m, then
            change_calibration and the next frame tracked; each drive
            prints its ms a frame in localization mode with the graph
            replays and captures a frame (every classic-path frame replays
            the frame build and the motion-model and local-map programs of
            phase 21b) and every capture with the frame it landed on; phase 9's map
            through save_map and load_map into a new system with the
            vocabulary, in localization mode, relocalizing a mapped frame
            through the keyframe database within 0.1 m; global_bundle_adjust
            on phase 14's final map through the system's GBA program with
            the first keyframe unchanged within 1e-6, its time and the ATE
            before and after
16. backlog the mapping worker made to fall behind (a keyframe every second
            frame, each call of the mapper's local-BA program held 0.5 s
            longer, the vocabulary,
            frames back to back) and its four paths counted one by one: the
            correction_gen drop, interrupt_ba, the backlog skip and the
            stage-conflict rerun; a path the drive did not reach is provoked
            on its last keyframe as its CPU test provokes it; fails unless
            each ran
17. mono    17a: tests/test_e2e_mono.py's drive at full width (640x480 /
            2000 / 8, 60 frames of the lateral sequence, seed 5) through
            SLAMSystem.track_monocular with SLAMConfig's defaults (the
            pipelined fetch, each keyframe mapped inline at insertion), no
            vocabulary, back to back; fails unless the map initializes
            before frame 15, at most 2 frames are lost after that, the map
            holds at least 3 keyframes and more than 150 points, the
            Sim3-aligned ATE is under 0.06 m and the kernel is launched
            once per frame build, dispatch again and rebuild; prints the
            frame and model (H or F) of initialization, ms per frame, the
            inline mapping's ms per keyframe and the frames dispatched
            again. 17b: that drive's successful two-view problem solved
            again on the card and on the CPU with the same sample sets (the
            same success and model, rotation within 1e-5 rad, translation
            direction within 1e-4 rad, good masks differing on at most 0.5 %
            of the pairs), with both times and the card's launches. 17c:
            tests/test_mono_extra.py::test_circuit_loop_fix_scale_false at
            full width (circuit3, 200 frames, the 10 000-word vocabulary,
            the worker waited for after each frame): fails unless the loop
            closer solves with scale, a loop is closed, the whole
            trajectory's scale error does not grow over the loop, the
            pre-loop window's grows at most 1.5 times and the Sim3 ATE is
            under 0.30 m; prints the frame by which the loop closed, the
            frames lost after it and the ids remapped to the point they were
            merged into (with reused_slot_ids and replacements_lost). 17d:
            that tracker set LOST without a motion model relocalizes on
            frame first+2 through the keyframe database
            (EPnP runs), within 0.1 in rotation and 0.15 in translation of
            the map's own estimate. 17e: replaced points in the last frame
            (Tracking::CheckReplacedInLastFrame): after 17a's drive, half of
            the points its last frame tracked are merged into duplicates
            (add_point at the same position and descriptor, replace_points
            under the map lock) and the next frame (one more step of the
            last velocity) is tracked through track_monocular; a copy of
            the tracker taken before the merge tracks the same frame without
            it. Fails unless the motion model's matches and inliers and the
            final inliers are equal, the camera centres within 1e-5 m, the
            ids remapped exactly the merged points' slots (half the frame's
            tracked points), the device carry dropped with the step given
            the remapped ids, a merged point's slot handed out again before
            the frame (on another copy) given to the step as its replacement,
            with reused_slot_ids up by the ids that held it (the last frame's
            and the local selection's) and replacements_lost unchanged, and
            the kernel launched once per frame

18. drivers the dataset drivers (python -m orbslam2_tpu_torch.examples.*) run in
            process with --device cuda and --eval on sequences the port's
            own PNG writer puts into a temporary directory, each with one
            kernel launch per frame build (and per frame built or
            dispatched again). 18a: phase 5's 60 frames as a TUM RGB-D
            sequence (DepthMapFactor 5000, a TUM1-layout settings file,
            the largest shipped vocabulary) through rgbd_tum: no frame lost
            after initialisation, ATE at most 0.10 m, printed beside phase
            14's. 18b: the first 100 frames of phase 12's drive as a KITTI
            sequence (image_0, image_1, times.txt, poses.txt) through
            stereo_kitti with its capacity hint (2048 x 200 000): tracking
            before frame 20, none lost after, ATE under 0.25 m. 18c: the
            EuRoC rectifier at 752x480 with a distorted, rotated
            calibration (card and CPU images identical, ms a pair; its
            maps are held to cv2's by the tests), then stereo_euroc on 40
            frames with an identity rectification: tracked before frame 20,
            none lost after. 18d: phase 17a's drive in TUM layout through
            mono_tum with --eval-scale, held to 17a's limits. 18e: the
            default vocabulary's corpus extracted on the card, trained on
            the card and on the CPU: identical trees; both times, and the
            share of a held-out frame's words equal to the shipped tree's

19. parallel 19a: the JAX dry run's production global BA
            (parallel/dryrun.py: 256 keyframes, 16 384 points, 65 536
            observations, phases (5, 10), 30 PCG iterations) through
            distributed_bundle_adjust with a group of 1 rank over NCCL (this
            process) and a group of 2 ranks over gloo (two processes, both on
            this card): in float32 held to the dry run's gates (finite,
            inliers >= 95 %, cost <= 2 x the single-device solve's + 1e-3),
            in float64 to the single-device bundle_adjust_pcg (camera centres
            within 1e-6 m); both costs and each solve's ms. 19b:
            make_multi_camera_step, the batched step as one program (one
            CUDA graph per shape), with 8 sessions at 640x480 / 2000 / 4
            levels on worlds built as tests/test_multi_session.py builds
            them: every session above 30 inliers and within 0.05 of the
            truth; the replay equal bit for bit to its warm-up, to the
            program's eager step and to 8 single steps (the program at
            B = 1); one graph launch a traced step and 2 describe launches
            counted a replay (8 x 4 levels in tables of 16); the batched
            tables against the plain version with 0 descriptors differing;
            then the same readings at B = 1, 4, 8 and 16 (16: the 8 worlds
            twice): capture ms, replay ms, the eager step's ms, kernels
            inside a replay, peak memory (and at B = 8 the 8 single steps'
            ms); the 16-level launch timed as in phase 3
20. periphery ros_demo's path (LocalTopicBus -> RGBDNode) on phase 5's 60
            frames with SLAMConfig's defaults and the 10 000-word tree, with
            ARViewer, HeadlessViewer (PNG) and LiveViewer(use_gui=False,
            JPEG) on every frame: frames = poses published, none lost after
            initialisation, ATE <= 0.10 m, one launch per frame build, the
            AR plane found, the PNG files read back equal and the JPEG files
            read back by the port's decoder within 35 dB; the viewers' host
            ms a frame. Then rgbd_tum --viewer on 18a's sequence: its
            published JPEG files read back

21. frame programs  each sensor's fused frame step as one CUDA graph
            (kernels.FrameProgram, the counterpart of the JAX package's
            _fused_*_program): the RGB-D program at 640x480 / 2000 / 8 on
            phase 14's tracker, the stereo program at phase 12's 1241x376 and
            capacity (1536 keyframes x 150 000 points) on phase 12's, the
            mono program at phase 17a's geometry on 17a's, each captured on
            inputs staged from the tracker's applied state (its last frame's
            keypoints and device carry, velocity, local selection, the map
            mirror): one graph and one describe launch after the first call
            (the warm-up frame; the capture runs nothing), then a replay that
            must equal the eager step on the same inputs (host reads, early
            stops) bit for bit in every output (pt_ids, is_outlier, visible,
            the three counts, tcw, depth, ur, the keypoints), and the warm-up
            frame too; 10 replays under torch.profiler must show 10 graph
            launches and 10 orient_describe_kernel; a replay's and the eager
            step's ms and the peak memory above the staged inputs. Then
            phases 5, 14 (K = 1, K = 4) and 12 (its first 120 frames) driven
            again by orbslam2_tpu_torch/tools/frame_step_ab.py: median and
            p95 ms a frame, the fetch wait (fused_dev), device operations,
            kernel and graph launches and describe kernels a frame and the
            card's busy share over a profiled window of 10 frames, the peak
            max_memory_allocated, the graphs captured, with the card's name
            and power limit on each line. Every drive of phases 4 to 20 runs
            its fused frames through these programs and prints the graphs its
            tracker captured and replayed; each replay adds its one describe
            launch to the kernel's count, so every launch gate counts what it
            counted before
21b. classic programs  the classic tracking path's programs (initialization,
            relocalization, localization mode, the motion-model fallback),
            each as one CUDA graph, the counterparts of the JAX package's
            jitted _rgbd_program, _stereo_program, _mono_program,
            motion_model_step and local_map_step: each sensor's frame build
            (frame.BuildProgram) on phase 14's, 12's and 17a's last images;
            then a copy of phase 14's tracker, its local selection dropped,
            tracks phase 5's last frame again on the classic path through
            its programs (all three captured there, their capture ms
            printed), and the motion-model and local-map programs
            (kernels.MotionModelProgram, LocalMapProgram) are held on the
            inputs of that frame's calls. Each through a new program: one
            graph and its describe launches after the first call (1 for a
            build, 0 for a step), a replay equal bit for bit to the eager
            step (host reads, early stops) and to the warm-up in every
            output, 10 replays traced (10 graph launches, 10 or 0
            orient_describe_kernel, the kernels inside a replay), the first
            call's and the capture's ms, a replay's and the eager step's ms,
            the peak memory above the staged inputs and the graph's pool
22. solve programs  local BA, the essential graph and global BA as
            programs (backend/solve_program.py: the counterpart of the JAX
            package's jitted solves, whose LM loops are lax.scan over one
            step): phase 6's local-BA problem and phase 11's essential-graph
            and global-BA problems, each through a new program on the card,
            captured once and replayed 5 times; every result held to the
            eager solve on the card (camera centres within 1e-9 m; index_add_
            sums by atomics) and to the CPU (within 1e-6 m); one replay
            traced (its graph launches, exactly a reset, each phase's
            prologue, steps and epilogue, or the setup and 20 steps; the
            kernels inside them; at most 40 kernels launched by the host);
            512 sentinel tensors of 0.5-64 KiB allocated after the capture
            must come out of the replays untouched (a buffer the program
            dropped while its graphs still write it would be among them);
            capture, replay and eager ms, the eager solve's host launches,
            and the peak memory of the program's buffers and graph pool;
            then two global BAs at once from two threads (one on a stream of
            its own) through one program, each equal to its own eager solve;
            the replay is traced three times (the kernels inside one graph,
            counted each time); phase 11's global BA unpadded and padded to
            the buckets of growth 2 and 4, each through a new program
            (capture, replay and device-busy ms) within 1e-9 m of the
            unpadded solve

Every phase runs under a watchdog (faulthandler): a phase that has not
returned within 600 s, or by 1150 s after the start, prints the stack of
every thread and exits with code 1.

Then one JSON line {"kernels": [...]} (phase 3's numbers and phase 5's
launches at its top level, each replay of a frame program counted, phase
13's 16-level launch and phase 12's launches under "stereo_16_levels",
phase 19b's 16-level launch under "multi_session_16_levels", every drive's
launches under "launches_by_path", phase 21 under "frame_programs", phase
21b under "classic_programs", phase 22 under "solve_programs"), the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import faulthandler
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation
from torch.profiler import ProfilerActivity, profile

from orbslam2_tpu_torch.backend import ba
from orbslam2_tpu_torch.backend import pose_graph, solve_program
from orbslam2_tpu_torch.frontend import frame as frame_mod
from orbslam2_tpu_torch.frontend import kernels, local_mapping, loop_closing
from orbslam2_tpu_torch.frontend import tracking as tracking_mod
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker, TrackingState
from orbslam2_tpu_torch.frontend.triangulation import triangulate_neighbors
from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.examples import (mono_tum, rgbd_tum, ros_demo, stereo_euroc,
                                         stereo_kitti)
from orbslam2_tpu_torch.io import datasets, jpeg, png
from orbslam2_tpu_torch.io.evaluate import ate_rmse, rpe
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence, make_texture
from orbslam2_tpu_torch.ops import cuda_orb, orb, stereo
from orbslam2_tpu_torch.place import pretrained, vocabulary
from orbslam2_tpu_torch.place.pretrained import get_large_vocabulary
from orbslam2_tpu_torch.slammap import covisibility, native, point_stats
from orbslam2_tpu_torch.slammap.device_map import FIELDS as DEVICE_MIRROR_FIELDS
from orbslam2_tpu_torch.slammap.device_map import DeviceKFStore, DeviceMapMirror
from orbslam2_tpu_torch.parallel import dryrun, mesh
from orbslam2_tpu_torch.parallel.dist_ba import distributed_bundle_adjust
from orbslam2_tpu_torch.parallel.multi_session import (make_multi_camera_step,
                                                       make_single_camera_step)
from orbslam2_tpu_torch.system import SLAMSystem, Sensor
from orbslam2_tpu_torch.viewer.ar import ARViewer
from orbslam2_tpu_torch.viewer.headless import STATUS_BAR_ROWS, HeadlessViewer
from orbslam2_tpu_torch.viewer.live import LiveViewer
from orbslam2_tpu_torch.utils.profiling import (device_activity, event_ms, kernel_device_ms,
                                                queued_ms)

# angle and descriptor tolerances between the kernel and its plain version
# (phase 3): both sum the disc in one stated order (csrc/orient_describe.cu)
# and agree bit for bit on the card, but the limits stay the JAX package's
# own between its twin paths, which a sum in another order (an angle off by
# float32 noise, a sample offset rounded the other way) would still meet.
# Phase 13 holds the 16-level launch to identical descriptors.
ANGLE_TOL_RAD = 1e-3
HAMMING_MEDIAN_MAX = 4
HAMMING_MAX = 40

ATE_MAX_M = 0.10
N_FRAMES = 60             # the mapped drive (phase 5)
N_FRAMES_TRACKER = 30     # the drive without a local mapper (phase 4)
N_FRAMES_DENSE = 30       # the keyframe-dense mapped drive (phase 8)
KF_EVERY = 3              # its keyframe cadence (SLAMConfig.force_kf_every)
WARM_FRAMES = 5           # frames before the timed steady-state window
# local BA on the card against the CPU, both in float64 as the mapper stages
# the problem: the card sums observations into the Hessian blocks in atomic
# order, so the two solves differ by rounding. They differed by 0 and by
# 1e-11 m on the drive's last window (PERF.md); a card solve that
# mis-sums a Hessian block lands millimetres away.
BA_TRANSLATION_TOL_M = 1e-6
BA_TIMED_SOLVES = 5       # solves timed per precision on the card
BA_CLASS_CHANGE_MAX = 0.01

N_FRAMES_PLACE = 100      # the place-recognition drive (phase 9)
PLACE_KF_EVERY = 4        # its keyframe cadence
PLACE_PROFILE_EVERY = 5   # a profiler started and stopped after every fifth frame
PLACE_ATE_MAX_M = 0.15
RELOC_FRAME = 50          # the mapped frame phase 10 relocalizes on
RELOC_TOL_M = 0.10
# essential graph and global BA, card against CPU in float64: as phase 6
LOOP_TRANSLATION_TOL_M = 1e-6
CARD = "cuda"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# operations per keypoint: 709 disc pixels x (add + multiply-add) for the two
# moments, 512 samples x (4 multiplies + 2 adds to rotate, 2 roundings,
# 1 quantisation) and 256 comparisons
OPS_PER_KEYPOINT = 709 * 3 + 512 * 9 + 256


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# modules the card's machine does not have: the port needs none of them
FORBIDDEN_MODULES = ("jax", "orbslam2_tpu", "cv2", "PIL", "yaml", "imageio")


def check_no_jax(when: str) -> None:
    found = [m for m in FORBIDDEN_MODULES if m in sys.modules]
    if found:
        fail(f"the port imported {found} ({when})")


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


def describe_bound(raws, ys, budgets):
    """The least time one describe launch over these levels could take on
    the card. -> (keypoints, bytes, operations, bound ms, what bounds it)."""
    n_kp = sum(y.numel() for y in ys)
    # each image read once; per keypoint two int64 coordinates read; per slot
    # an angle and eight words written; the pattern and the level table once
    n_bytes = sum(2 * raw.numel() * 4 for raw in raws) + n_kp * 16 \
        + sum(budgets) * 36 + 256 * 16 + cuda_orb.LEVEL_TABLE_BYTES
    n_ops = n_kp * OPS_PER_KEYPOINT
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_FLOP_PER_S * 1e3
    return (n_kp, n_bytes, n_ops, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


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
    def run_eight():
        for args in zip(raws, blurs, ys32, xs32):
            cuda_orb.fused_orient_describe(*args, pat)

    times = describe_times(frame_args, run_eight, n_levels, "eight_calls",
                           "eight one-level calls of the same kernel")
    return {"max_abs_err": max(s["max_angle_err"] for s in stats),
            "descriptor_exact_share_min": min(s["ham_exact_share"] for s in stats),
            **times,
            "ms_covers": "one frame: one launch for all pyramid levels, timed by CUDA "
                         "events around wrapper calls (host-paced); device_ms is the "
                         "kernel's own duration on the card with L2 flushed before "
                         "each launch, device_ms_warm_l2 with its inputs left in L2"}


def describe_times(frame_args, beside, beside_kernels, beside_name, beside_what) -> dict:
    """The times of one describe launch over the levels of ``frame_args``
    (the wrapper's arguments), and beside it of ``beside``, another way to
    describe (``beside_kernels`` launches of the same kernel a call), on the
    one card in alternating order. -> the entries of the `kernels` line.

    ``device_ms`` is the kernel's duration on the card with L2 flushed
    before each launch: its inputs come from device memory, as the bytes
    bound assumes. ``device_ms_warm_l2`` leaves them in the 50 MB L2 between
    launches, as on the main path where the pyramid was just written; the
    HBM bound does not hold for that reading."""
    raws, blurs, ys, xs, _, budgets = frame_args
    name = "orient_describe_kernel"

    def run():
        cuda_orb.fused_orient_describe_levels(*frame_args)

    def run_plain():
        cuda_orb.fused_orient_describe_levels_plain(*frame_args)

    table = cuda_orb.build_level_table(raws, blurs, ys, xs, budgets)
    scratch = torch.zeros(1, dtype=torch.float32, device=raws[0].device)

    def run_empty():
        cuda_orb.launch_empty_kernel(table, scratch)

    with ClockSampler() as clocks:
        plain_a = event_ms(run_plain, 10)
        kernel_a = event_ms(run, 200)
        beside_a = event_ms(beside, 50)
        beside_b = event_ms(beside, 50)
        kernel_b = event_ms(run, 200)
        plain_b = event_ms(run_plain, 10)
        # the card's own time: kernel durations from the profiler's trace, and
        # events around launches queued behind a spin kernel that hides the host
        cold_ms, cold_n = kernel_device_ms(run, 50, name, flush_l2=True)
        warm_ms, warm_n = kernel_device_ms(run, 50, name)
        beside_traced, beside_n = kernel_device_ms(beside, 20, name)
        floor_traced, _ = kernel_device_ms(run_empty, 50, "orient_describe_empty_kernel")
        if beside_traced is not None:
            beside_traced *= beside_kernels   # mean of one launch -> a call's
        queued = queued_ms(run, 50)
        beside_queued = queued_ms(beside, 20)
        floor_queued = queued_ms(run_empty, 50)
    kernel_ms = 0.5 * (kernel_a + kernel_b)
    beside_ms = 0.5 * (beside_a + beside_b)
    plain_ms = 0.5 * (plain_a + plain_b)
    traced = None not in (cold_ms, warm_ms, beside_traced, floor_traced)
    if traced:
        method = (f"torch.profiler: the kernel's mean duration on the card ({cold_n}, "
                  f"{warm_n} and {beside_n} kernels traced)")
        device_ms, warm, beside_dev, floor_ms = cold_ms, warm_ms, beside_traced, floor_traced
    else:
        # no L2-flushed reading without the trace: the queued launches share L2
        method = ("CUDA events around launches queued behind a spin kernel, L2 warm "
                  "(the profiler's trace held no device time)")
        device_ms, warm, beside_dev, floor_ms = queued, queued, beside_queued, floor_queued

    n_kp, n_bytes, n_ops, bound_ms, bound_by = describe_bound(raws, ys, budgets)
    mhz = clocks.mhz or [float("nan")]
    print(f"  one launch ({sum(budgets)} slots, {n_kp} keypoints, {len(raws)} levels):\n"
          f"    ms {kernel_ms:.4f} ({kernel_a:.4f}, {kernel_b:.4f}): CUDA events around "
          f"wrapper calls; host-paced (the card finishes a launch before the host "
          f"sends the next)\n"
          f"    device_ms {device_ms:.5f} with L2 flushed before each launch; "
          f"device_ms_warm_l2 {warm:.5f} [{method}]; queued behind a spin kernel "
          f"{queued:.5f}\n"
          f"    bound {bound_ms:.5f} ms by {bound_by} ({n_bytes} bytes over HBM, {n_ops} "
          f"operations): {bound_ms / device_ms * 100:.1f} % of device_ms, "
          f"{bound_ms / warm * 100:.1f} % of the warm reading (its inputs come from "
          f"L2, faster than the HBM rate the bound assumes); library call: none\n"
          f"    {beside_name}_ms {beside_ms:.4f} ({beside_a:.4f}, {beside_b:.4f}): "
          f"{beside_what}, host-paced; on the card {beside_dev:.5f} (L2 warm; queued "
          f"{beside_queued:.5f})\n"
          f"    launch_floor_ms {floor_ms:.5f}: an empty kernel on the same grid "
          f"(queued {floor_queued:.5f})\n"
          f"    plain {plain_ms:.3f} ms ({plain_a:.3f}, {plain_b:.3f})\n"
          f"    SM clock min/median/max {min(mhz):.0f}/{np.median(mhz):.0f}/{max(mhz):.0f} "
          f"MHz ({len(clocks.mhz)} samples)", flush=True)
    return {"ms": kernel_ms, "device_ms": device_ms, "device_ms_warm_l2": warm,
            "device_ms_method": method, "device_ms_queued": queued,
            f"{beside_name}_ms": beside_ms, f"{beside_name}_device_ms": beside_dev,
            f"{beside_name}_device_ms_queued": beside_queued, "launch_floor_ms": floor_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "roofline_share": bound_ms / device_ms, "library_ms": None}


def drive(name, track, tracker, frames, seq, pace=None, pipelined=False) -> dict:
    """Drive `track` over `frames`, back to back or after `pace()` (called
    before each frame, outside its time), with the kernel's launch count set
    to 0 just before and read just after, and check the drive: every frame
    after initialisation tracked, one launch a frame (and one for each frame
    built again or tracked again). A fused frame replays its program's CUDA
    graph, whose describe launch the program adds to the count; the graphs
    the tracker captured and replayed are printed. With `pipelined` the frames in flight are
    applied after the last one, inside the timed window, and tracked frames
    are counted from the tracker's lost mask, since a pipelined frame
    returns its prediction. -> the drive's measured entries."""
    n_frames = len(frames)
    cuda_orb.fused_orient_describe.launches = 0
    frame_ms = []
    tracked = 0
    first_ok = t_steady = None
    waited = 0.0
    with ClockSampler() as clocks:
        for i, (gray, depth) in enumerate(frames):
            if pace is not None:
                t_wait = time.perf_counter()
                pace()
                waited += time.perf_counter() - t_wait if i > WARM_FRAMES else 0.0
            if i == WARM_FRAMES:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            before = cuda_orb.fused_orient_describe.launches
            again = tracker.rebuilt_frames + tracker.retracked_frames
            t_frame = time.perf_counter()
            tcw = track(gray, depth, i / seq.fps)
            frame_ms.append((time.perf_counter() - t_frame) * 1e3)  # ends in a fetch
            built = cuda_orb.fused_orient_describe.launches - before
            # a frame whose map a loop correction rebased mid-step is built
            # again, and so is a pipelined frame whose chain was discarded
            expected = 1 + tracker.rebuilt_frames + tracker.retracked_frames - again
            if built != expected:
                fail(f"{name}: frame {i}: {built} kernel launches, expected {expected}")
            if pipelined:
                continue
            if tcw is not None:
                tracked += 1
                if first_ok is None:
                    first_ok = i
            elif first_ok is not None:
                fail(f"{name}: frame {i} lost after initialisation at frame {first_ok}")
        if pipelined:
            before = cuda_orb.fused_orient_describe.launches
            again = tracker.rebuilt_frames + tracker.retracked_frames
            tracker.flush_frames()
            built = cuda_orb.fused_orient_describe.launches - before
            if built != tracker.rebuilt_frames + tracker.retracked_frames - again:
                fail(f"{name}: the flush launched the kernel {built} times")
            lost = tracker.trajectory_lost_mask()[-n_frames:]
            if len(lost) != n_frames:
                fail(f"{name}: {len(lost)} trajectory entries for {n_frames} frames")
            ok_at = np.flatnonzero(~lost)
            first_ok = int(ok_at[0]) if len(ok_at) else None
            tracked = len(ok_at)
            if first_ok is not None and lost[first_ok:].any():
                fail(f"{name}: frames {np.flatnonzero(lost[first_ok:]) + first_ok} lost "
                     f"after initialisation at frame {first_ok}")
        torch.cuda.synchronize()
        n_steady = n_frames - WARM_FRAMES
        ms_per_frame = (time.perf_counter() - t_steady - waited) / n_steady * 1e3
    launches = cuda_orb.fused_orient_describe.launches
    steady = np.array(frame_ms[WARM_FRAMES:])
    fused_frames = tracker.stats.summary().get("fused_step", {}).get("n", 0)

    if first_ok is None or tracker.state != TrackingState.OK:
        fail(f"{name}: the tracker did not initialise")
    lf = tracker.last_frame
    mir = tracker.map.device_mirror(tracker.device)
    on_card = [lf.ur, lf.depth, *mir.arrays.values(),
               *(getattr(lf.kp, f) for f in ("xy", "response", "angle", "octave",
                                             "size", "desc", "valid"))]
    if tracker._last_pid_dev is not None:
        on_card.append(tracker._last_pid_dev)
    if fused_frames < n_frames // 2:
        fail(f"{name}: only {fused_frames} frames went through the fused step")
    if any(t.device.type != "cuda" for t in on_card):
        fail(f"{name}: a tensor of the fused step is not on the card")
    if launches != n_frames + tracker.rebuilt_frames + tracker.retracked_frames:
        fail(f"{name}: {launches} launches, expected {n_frames} frames + "
             f"{tracker.rebuilt_frames} rebuilt + {tracker.retracked_frames} tracked again")
    programs = list(tracker.frame_programs.values())
    graphs = sum(p.captures for p in programs)
    replays = sum(p.replays for p in programs)
    kinds = ", ".join(p.kind for p in programs) or "no program"
    classic = tracker.classic_programs
    print(f"  frame programs: {graphs} CUDA graphs captured ({kinds}), {replays} replays; "
          f"classic-path programs: "
          f"{', '.join(f'{k} {p.captures} / {p.replays}' for k, p in classic.items())} "
          f"captured / replayed; the launch count holds one describe launch per frame "
          f"program or build replay", flush=True)
    return dict(launches=launches, first_ok=first_ok, tracked=tracked,
                graphs_captured=graphs, graph_replays=replays,
                classic_programs={k: (p.captures, p.replays) for k, p in classic.items()},
                fused_frames=fused_frames, rebuilt_frames=tracker.rebuilt_frames,
                retracked_frames=tracker.retracked_frames,
                revalidated_frames=tracker.revalidated_frames,
                remapped_ids=tracker.remapped_ids, reused_slot_ids=tracker.reused_slot_ids,
                replacements_lost=tracker.replacements_lost, ms_per_frame=ms_per_frame,
                median_ms=float(np.median(steady)),
                p95_ms=float(np.percentile(steady, 95)),
                mhz=clocks.mhz or [float("nan")])


def check_trajectory(name, tracker, seq, d) -> float:
    n_frames = len(tracker.trajectory)
    lost = tracker.trajectory_lost_mask()
    if lost[d["first_ok"]:].any():
        fail(f"{name}: lost frames after initialisation: {np.where(lost)[0].tolist()}")
    est = tracker.full_trajectory_twc()
    gt = np.stack([np.linalg.inv(seq.poses[i]) for i in range(n_frames)])
    if not np.isfinite(est).all() or est.shape != (n_frames, 4, 4):
        fail(f"{name}: trajectory is not finite or has the wrong shape")
    return ate_rmse(est[d["first_ok"]:], gt[d["first_ok"]:])


def remapped(d) -> str:
    """A drive's counts of the tracker's replacement lookup, as printed."""
    return (f"ids remapped to the point they were merged into {d['remapped_ids']} (through a "
            f"slot handed out again {d['reused_slot_ids']}, lost to a slot handed out twice "
            f"{d['replacements_lost']})")


def describe(name, tracker, d, ate, n_frames) -> None:
    mhz = d["mhz"]
    print(f"  frames tracked {d['tracked']}/{n_frames}, keyframes "
          f"{tracker.map.n_keyframes()}, map points {tracker.map.n_points()}, "
          f"ATE-RMSE {ate:.4f} m, {d['ms_per_frame']:.2f} ms per steady-state frame "
          f"(frames {WARM_FRAMES}..{n_frames - 1}, host clock around a synchronised "
          f"loop), median {d['median_ms']:.2f} ms, p95 {d['p95_ms']:.2f} ms; kernel "
          f"launches {d['launches']}, fused frames {d['fused_frames']} ({d['revalidated_frames']} "
          f"with associations the mapper changed mid-step), {remapped(d)}; SM clock over "
          f"the drive min/median/max {min(mhz):.0f}/{np.median(mhz):.0f}/{max(mhz):.0f} "
          f"MHz ({len(mhz)} samples)", flush=True)
    print(tracker.stats.report(), flush=True)
    if ate > ATE_MAX_M:
        fail(f"{name}: ATE {ate:.4f} m above {ATE_MAX_M} m")


def drive_tracker_alone(cfg, frames, seq) -> dict:
    """Phase 4: a Tracker without a local mapper (the first slice's path)."""
    frames = frames[:N_FRAMES_TRACKER]
    print(f"[tracker] Tracker.track_rgbd without a local mapper, {len(frames)} frames, "
          "640x480 / 2000 features / 8 levels", flush=True)
    tracker = Tracker(cfg)                       # default device: the card
    d = drive("tracker", tracker.track_rgbd, tracker, frames, seq)
    ate = check_trajectory("tracker", tracker, seq, d)
    describe("tracker", tracker, d, ate, len(frames))
    return dict(launches=d["launches"], ate_m=ate, ms_per_frame=d["ms_per_frame"],
                median_ms=d["median_ms"])


class BACapture:
    """Keeps the last problem the local mapper hands to its local-BA program
    (on the worker's thread) while the context is open."""

    def __init__(self, mapper):
        self.mapper = mapper

    def __enter__(self):
        self.program = self.mapper.ba_program
        self.last = None

        def capture(problem, cam, point_fixed=None, **kw):
            self.last = (problem, point_fixed)
            return self.program(problem, cam, point_fixed=point_fixed, **kw)

        self.mapper.ba_program = capture
        return self

    def __exit__(self, *exc):
        self.mapper.ba_program = self.program


# graph launches one solve replays: a reset, then each phase's prologue,
# steps and epilogue (local BA (5, 10), global BA (5, 5)); the essential
# graph's setup and 20 steps
GRAPHS_PER_SOLVE = {"local_ba": 1 + (1 + 5 + 1) + (1 + 10 + 1), "gba": 1 + 2 * (1 + 5 + 1),
                    "essential_graph": 1 + 20}


def solve_programs(system) -> dict:
    """A system's solve programs by name: the local mapper's local BA and,
    with a loop closer, its essential graph and global BA."""
    progs = {"local_ba": system.local_mapper.ba_program}
    if system.loop_closer is not None:
        progs.update(essential_graph=system.loop_closer.eg_program,
                     gba=system.loop_closer.gba_program)
    return progs


def check_solve_programs_ran(name, system, solves: dict, threads=None) -> dict:
    """Prints each solve program's captures, replays, graph launches, capture
    ms, the ms each capture waited for a caller's call and the thread it
    ran on, the longest and the summed wait of its replays' launches, and with a loop closer each essential graph's edges and each
    global BA's observations (real / padded), which choose the key; fails
    unless every solve of the drive (`solves`: name -> count) ran as one
    replay of its program with its graphs, and, with `threads` (name ->
    thread name), unless each of those programs captured on that thread."""
    out = {}
    for prog_name, prog in solve_programs(system).items():
        out[prog_name] = dict(captures=prog.captures, replays=prog.replays,
                              graph_launches=prog.graph_launches,
                              capture_ms=[round(x, 1) for x in prog.capture_ms],
                              held_ms=[round(x, 1) for x in prog.held_ms],
                              capture_threads=list(prog.capture_threads),
                              replay_held_ms_max=max(prog.replay_held_ms, default=0.0),
                              replay_held_ms_total=sum(prog.replay_held_ms))
    print(f"  solve programs (captures / replays / graph launches; capture ms, ms held "
          f"for a caller's call, thread; replays' launches held for a call, ms max / "
          f"total): " + "; ".join(
              f"{k} {v['captures']} / {v['replays']} / {v['graph_launches']}; "
              f"{v['capture_ms']}, {v['held_ms']}, {v['capture_threads']}; "
              f"{v['replay_held_ms_max']:.1f} / {v['replay_held_ms_total']:.1f}"
              for k, v in out.items()), flush=True)
    if system.loop_closer is not None:
        sizes = system.loop_closer.solve_sizes
        out["sizes"] = {k: [list(x) for x in v] for k, v in sizes.items()}
        print(f"  solve sizes (real, padded): essential-graph edges "
              f"{sizes['essential_graph']}, global-BA observations {sizes['gba']}",
              flush=True)
    for prog_name, n_solves in solves.items():
        c = out[prog_name]
        want = n_solves * GRAPHS_PER_SOLVE[prog_name]
        if c["replays"] != n_solves or c["graph_launches"] != want or \
                (n_solves and not 1 <= c["captures"] <= n_solves):
            fail(f"{name}: the {prog_name} program replayed {c['replays']} solves with "
                 f"{c['graph_launches']} graph launches and {c['captures']} captures; the "
                 f"drive solved {n_solves} ({want} graph launches)")
    for prog_name, thread in (threads or {}).items():
        if not out[prog_name]["captures"] or \
                set(out[prog_name]["capture_threads"]) != {thread}:
            fail(f"{name}: the {prog_name} program captured on "
                 f"{out[prog_name]['capture_threads']}, expected {thread}")
    return out


def drive_mapped(name, cfg, frames, seq, what):
    """A drive through SLAMSystem with the mapping worker on the card, frames
    back to back as bench.py's bench_system sends them: the worker maps each
    keyframe beside the tracker, and is waited for only before the
    trajectory is read. -> (entries, system, the last local-BA problem); the
    system's worker is stopped."""
    print(f"[{name}] SLAMSystem.track_rgbd with the mapping worker, {what}, "
          f"{len(frames)} frames back to back, 640x480 / 2000 features / 8 levels",
          flush=True)
    system = SLAMSystem(cfg, Sensor.RGBD)        # default device: the card
    if system.mapping_worker is None or system.local_mapper.device.type != "cuda":
        fail(f"{name}: the mapping worker is not running on the card")
    tracker, mapper = system.tracker, system.local_mapper

    with BACapture(mapper) as captured:
        d = drive(name, system.track_rgbd, tracker, frames, seq)
        t0 = time.perf_counter()
        if not system.wait_mapping_idle(300):   # raises the worker's exception
            fail(f"{name}: the mapping worker did not become idle within 300 s")
        wait_s = time.perf_counter() - t0
    ate = check_trajectory(name, tracker, seq, d)
    c = mapper.counts
    n_created = int(tracker.map._kf_counter)
    print(f"  keyframes created {n_created}, culled {c['kf_culled']}, live "
          f"{tracker.map.n_keyframes()}; points live {tracker.map.n_points()}, "
          f"triangulated {c['points_created']}; fusion: observations added "
          f"{c['obs_fused']}, points merged {c['points_merged']}; local BAs applied "
          f"{c['ba_applied']}, dropped {c['ba_dropped']} (correction_gen), skipped "
          f"{c['ba_skipped']} (a keyframe waiting or the tracker asking for one); stage "
          f"conflicts rerun {c['conflicts']}; the worker went idle {wait_s:.2f} s after "
          f"the last frame", flush=True)
    print("  mapper stages (per keyframe, worker thread):", flush=True)
    print(mapper.stats.report(), flush=True)
    describe(name, tracker, d, ate, len(frames))
    if c["ba_applied"] < 1:
        fail(f"{name}: no local BA was applied")
    programs = check_solve_programs_ran(name, system, {"local_ba": c["ba_applied"]
                                                       + c["ba_dropped"]})
    if mapper.stats.summary().get("tri_dev", {}).get("n", 0) < 1:
        fail(f"{name}: no triangulation search ran on the card")
    system.shutdown()                # joins the worker; raises its exception
    summary = mapper.stats.summary()
    return dict(launches=d["launches"], ate_m=ate, ms_per_frame=d["ms_per_frame"],
                median_ms=d["median_ms"], p95_ms=d["p95_ms"],
                idle_after_last_frame_s=wait_s,
                sm_clock_mhz_median=float(np.median(d["mhz"])),
                keyframes_created=n_created, keyframes_culled=c["kf_culled"],
                points_live=int(tracker.map.n_points()),
                points_triangulated=c["points_created"], obs_fused=c["obs_fused"],
                points_merged=c["points_merged"], local_ba_applied=c["ba_applied"],
                local_ba_dropped=c["ba_dropped"], local_ba_skipped=c["ba_skipped"],
                mapper_stage_median_ms={k: v["median_ms"] for k, v in summary.items()},
                local_ba_conflicts=c["conflicts"],
                fused_frames=d["fused_frames"], revalidated_frames=d["revalidated_frames"],
                remapped_ids=d["remapped_ids"], reused_slot_ids=d["reused_slot_ids"],
                replacements_lost=d["replacements_lost"],
                tracker_stage_median_ms={k: v["median_ms"] for k, v in
                                         tracker.stats.summary().items()},
                solve_programs=programs), system, captured.last


def drive_main_path(cfg, frames, seq):
    """Phase 5: bench_system's drive with the mapping worker, frames back to
    back. Depth gives nearly every keypoint of this scene a point when its
    keyframe is inserted, so triangulation is checked to have searched, and
    the keyframe-dense drive (phase 8) checks that it creates points."""
    return drive_mapped("main", cfg, frames, seq, "bench_system's keyframe policy")


def drive_keyframe_dense(cfg, frames, seq) -> dict:
    """Phase 8: the mapped drive with a keyframe every third frame. Points of
    the new keyframes that tracking drops as outliers leave keypoints free
    in two covisible keyframes, so triangulation has work; the phase fails
    without a triangulated point."""
    frames = frames[:N_FRAMES_DENSE]
    d, _, _ = drive_mapped("keyframes", dataclasses.replace(cfg, force_kf_every=KF_EVERY),
                           frames, seq, f"a keyframe every {KF_EVERY} frames")
    if d["points_triangulated"] < 1:
        fail("keyframes: no point was triangulated")
    return d


def rotation_angle(r: np.ndarray) -> np.ndarray:
    """Angle of rotations [..., 3, 3], accurate for small angles too."""
    r = r.astype(np.float64)
    sin = 0.5 * np.linalg.norm(np.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                                         r[..., 1, 0] - r[..., 0, 1]], -1), axis=-1)
    cos = (np.trace(r, axis1=-2, axis2=-1) - 1.0) * 0.5
    return np.arctan2(sin, cos)


def timed_solve(problem, cam, pt_fixed):
    """bundle_adjust once to warm up, then BA_TIMED_SOLVES times. -> (every
    timed result as numpy, median ms by the host clock around a synchronised
    call)."""
    sync = torch.cuda.synchronize if problem.poses.is_cuda else (lambda: None)
    ba.bundle_adjust(problem, cam, point_fixed=pt_fixed)
    outs, times = [], []
    for _ in range(BA_TIMED_SOLVES):
        sync()
        t0 = time.perf_counter()
        out = ba.bundle_adjust(problem, cam, point_fixed=pt_fixed)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append([x.cpu().numpy() for x in out])
    return outs, float(np.median(times))


def check_ba_card_vs_cpu(staged, cam) -> dict:
    """Phase 6: the last local-BA problem the drive's mapper solved, solved
    again on the card and on the CPU in float64 (as the mapper stages it),
    then in float32 on the card."""
    if staged is None:
        fail("the drive solved no local-BA problem")
    problem, pt_fixed = staged
    if problem.poses.dtype != torch.float64 or not problem.poses.is_cuda:
        fail(f"the mapper staged its local BA as {problem.poses.dtype} on "
             f"{problem.poses.device}, expected float64 on the card")
    k, p, o = problem.poses.shape[0], problem.points.shape[0], problem.obs_cam.shape[0]
    n_obs = int(problem.obs_valid.sum())
    print(f"[ba] last local BA of the drive: {k} camera slots "
          f"({int((~problem.cam_fixed).sum())} free), {p} point slots, {o} observation "
          f"slots ({n_obs} valid); card vs CPU", flush=True)
    as32 = ba.BAProblem(*(x.to(torch.float32) if x.is_floating_point() else x
                          for x in problem))
    cards, card_ms = timed_solve(problem, cam, pt_fixed)
    cpus, cpu_ms = timed_solve(ba.BAProblem(*(x.cpu() for x in problem)), cam,
                               pt_fixed.cpu())
    cards32, card32_ms = timed_solve(as32, cam, pt_fixed)
    pu, xu, iu, cu = cpus[0]
    for pc, xc, _, cc in cards:
        if not (np.isfinite(pc).all() and np.isfinite(xc).all() and np.isfinite(cc)):
            fail("the card's local BA is not finite")
    centre = lambda t: -np.einsum("kji,kj->ki", t[:, :3, :3].astype(np.float64),
                                  t[:, :3, 3].astype(np.float64))

    def pose_diff(a):
        rot = float(rotation_angle(a[:, :3, :3] @ pu[:, :3, :3].transpose(0, 2, 1)).max())
        return rot, float(np.linalg.norm(centre(a) - centre(pu), axis=1).max())

    valid = problem.obs_valid.cpu().numpy()
    free_pts = ~pt_fixed.cpu().numpy()

    def worst(outs):
        """Largest differences from the CPU's float64 solve over the card's
        timed solves (each sums in its own atomic order)."""
        diffs = [(*pose_diff(p), float(np.abs(x - xu)[free_pts].max()),
                  int((i != iu)[valid].sum())) for p, x, i, _ in outs]
        return [max(col) for col in zip(*diffs)]

    rot, trans, point, n_changed = worst(cards)
    rot32, trans32, point32, n_changed32 = worst(cards32)
    changed, changed32 = n_changed / max(n_obs, 1), n_changed32 / max(n_obs, 1)
    ic, cc = cards[-1][2], cards[-1][3]
    print(f"  float64, card vs CPU, worst of {BA_TIMED_SOLVES} card solves: pose difference "
          f"rotation {rot:.3e} rad, camera centre {trans:.3e} m (limit "
          f"{BA_TRANSLATION_TOL_M}); point difference {point:.3e} m; observations changing "
          f"class {changed * 100:.3f} % ({n_changed} of {n_obs}); inliers card "
          f"{int(ic[valid].sum())} CPU {int(iu[valid].sum())}; cost card {float(cc):.6f} "
          f"CPU {float(cu):.6f}\n"
          f"  float32 on the card vs float64 on the CPU, worst of {BA_TIMED_SOLVES}: rotation "
          f"{rot32:.3e} rad, camera centre {trans32:.3e} m, point {point32:.3e} m, "
          f"observations changing class {changed32 * 100:.3f} %, cost "
          f"{float(cards32[-1][3]):.6f} (reported, not checked)\n"
          f"  one solve, median of {BA_TIMED_SOLVES} after a warm-up, host clock around a "
          f"synchronised call: card float64 {card_ms:.2f} ms, card float32 "
          f"{card32_ms:.2f} ms, CPU float64 {cpu_ms:.2f} ms", flush=True)
    if trans > BA_TRANSLATION_TOL_M:
        fail(f"local BA: camera centres differ by {trans} m (limit {BA_TRANSLATION_TOL_M})")
    if changed > BA_CLASS_CHANGE_MAX:
        fail(f"local BA: {changed * 100:.2f} % of observations change class "
             f"(limit {BA_CLASS_CHANGE_MAX * 100} %)")
    return dict(ba_rotation_diff_rad=rot, ba_centre_diff_m=trans, ba_point_diff_m=point,
                ba_class_change_share=changed, ba_card_f64_ms=card_ms,
                ba_card_f32_ms=card32_ms, ba_cpu_f64_ms=cpu_ms,
                ba_f32_centre_diff_m=trans32, ba_f32_point_diff_m=point32,
                ba_f32_class_change_share=changed32)


def check_mapping_searches(system, cam, orb_cfg) -> dict:
    """Phase 7: the mapper's two device searches at full width on the card
    against the CPU, on the drive's final map: triangulation of the newest
    keyframe against its best covisible neighbours with every keypoint
    treated as free (in this drive depth gives nearly every keypoint a point
    at insertion, so the mapper's own triangulations find few free pairs),
    and the fuse of every live point into those keyframes."""
    m = system.map
    kfs = m.keyframe_ids()
    kf = int(kfs[-1])
    w = covisibility.weight_matrix(m)
    nbs = [int(k) for k in covisibility.best_covisible(w, kf, 10)]
    if not nbs:
        fail("the newest keyframe has no covisible neighbour")
    print(f"[searches] keyframe {kf} against neighbours {nbs}; card vs CPU", flush=True)
    out = []
    for dev in ("cuda", "cpu"):
        store = DeviceKFStore(dev)
        store.sync(m)
        a = store.arrays
        free2 = torch.as_tensor(m.kf_kp_valid[nbs]).to(dev)
        t0 = time.perf_counter()
        tri = triangulate_neighbors(
            kf, torch.as_tensor(m.kf_kp_valid[kf]).to(dev), nbs, free2,
            store.pose, a["kf_kp_xy"], a["kf_kp_desc"], a["kf_kp_octave"], a["kf_kp_angle"],
            a["kf_kp_valid"], a["kf_kp_ur"], a["kf_kp_depth"], cam, orb_cfg.scale_factor,
            orb_cfg.n_levels, m.cap.n_features * len(nbs))
        tri = [x.cpu().numpy() for x in tri]
        tri_s = time.perf_counter() - t0
        cand = np.flatnonzero(m.pt_valid)[:4096]
        ids = np.zeros(4096, np.int64)
        ids[:len(cand)] = cand
        targets = [kf, *nbs]
        sel = np.zeros((len(targets), 4096), bool)
        sel[:, :len(cand)] = True
        mir = DeviceMapMirror(dev)
        mir.sync(m)
        t0 = time.perf_counter()
        assoc = kernels.fuse_targets(
            targets, store.pose, a["kf_kp_xy"], a["kf_kp_desc"],
            a["kf_kp_octave"], a["kf_kp_angle"], a["kf_kp_valid"],
            torch.as_tensor(ids).to(dev), torch.as_tensor(sel).to(dev),
            *(mir.arrays[f] for f in DEVICE_MIRROR_FIELDS), 3.0, cam,
            orb_cfg.scale_factor, orb_cfg.n_levels, 50).cpu().numpy()
        out.append((tri, assoc, tri_s, time.perf_counter() - t0))
    (tri_c, assoc_c, tri_cs, fuse_cs), (tri_u, assoc_u, tri_us, fuse_us) = out

    def triples(t):
        keep = t[1] >= 0
        return {(int(a), int(b), int(c)) for a, b, c in zip(t[1][keep], t[0][keep], t[2][keep])}

    tc, tu = triples(tri_c), triples(tri_u)
    differ = len(tc ^ tu)
    common = {(i, b): p for i, b, p in zip(tri_u[1], tri_u[0], tri_u[3]) if i >= 0}
    diffs = [np.abs(p - common[(i, b)]).max() for i, b, p in zip(tri_c[1], tri_c[0], tri_c[3])
             if i >= 0 and (i, b) in common]
    point_diff = float(max(diffs)) if diffs else 0.0
    agree = float((assoc_c == assoc_u).mean())
    print(f"  triangulation: {len(tc)} survivors on the card, {len(tu)} on the CPU, "
          f"{differ} differ; largest point difference {point_diff:.3e} m; fuse: "
          f"{int((assoc_c >= 0).sum())} associations on the card, {int((assoc_u >= 0).sum())} "
          f"on the CPU, {agree * 100:.3f} % of the {assoc_c.size} slots agree; host clock: "
          f"triangulation card {tri_cs:.3f} s CPU {tri_us:.3f} s, fuse card {fuse_cs:.3f} s "
          f"CPU {fuse_us:.3f} s", flush=True)
    if not tc:
        fail("triangulation found no survivor on the card")
    if differ > max(3, 0.01 * len(tu)):
        fail(f"triangulation: {differ} survivors differ between the card and the CPU")
    if agree < 0.995:
        fail(f"fuse: only {agree * 100:.2f} % of the associations agree")
    return dict(tri_survivors_card=len(tc), tri_survivors_cpu=len(tu), tri_differ=differ,
                tri_point_diff_m=point_diff, fuse_agree_share=agree,
                tri_card_s=tri_cs, tri_cpu_s=tri_us, fuse_card_s=fuse_cs, fuse_cpu_s=fuse_us)


class LoopCapture:
    """Keeps the last essential-graph and global-BA problems the loop closer
    hands to its programs (the GBA on its own thread) and every BoW
    transform the tracker makes, while the context is open."""

    def __init__(self, closer):
        self.closer = closer

    def __enter__(self):
        closer = self.closer
        self.eg_program, self.gba_program = closer.eg_program, closer.gba_program
        self.word_ids = tracking_mod.Tracker._word_ids
        self.eg = self.gba = None
        self.words = []

        def eg(*args, **kw):
            self.eg = (args, kw)
            return self.eg_program(*args, **kw)

        def gba(problem, cam, **kw):
            self.gba = (problem, kw)
            return self.gba_program(problem, cam, **kw)

        def words(tracker, fr):
            out = self.word_ids(tracker, fr)
            self.words.append((fr.kp.desc, fr.kp.valid, out))
            return out

        closer.eg_program, closer.gba_program = eg, gba
        tracking_mod.Tracker._word_ids = words
        return self

    def __exit__(self, *exc):
        self.closer.eg_program, self.closer.gba_program = self.eg_program, self.gba_program
        tracking_mod.Tracker._word_ids = self.word_ids


def longest_frame_at_loop(frame_log, median_ms):
    """The longest tracker frame from two frames before the first that saw a
    loop closed to two after it: the loop closer holds the map lock from
    detection to the end of the correction, and the tracker's frame that
    asks for the lock meanwhile waits. frame_log: per frame (ms, loops
    closed when it returned). -> a dict, or None without a loop."""
    loop_frame = next((i for i, (_, n) in enumerate(frame_log) if n > 0), None)
    if loop_frame is None:
        return None
    lo = max(0, loop_frame - 2)
    around = [ms for ms, _ in frame_log[lo:loop_frame + 3]]
    k = int(np.argmax(around))
    stall = dict(loop_seen_after_frame=loop_frame, frame=lo + k, ms=around[k],
                 frames=f"{lo}..{lo + len(around) - 1}")
    print(f"  the tracker saw the loop closed after frame {loop_frame}; the longest "
          f"frame of frames {stall['frames']}: frame {stall['frame']}, "
          f"{stall['ms']:.1f} ms (the drive's median {median_ms:.2f} ms)", flush=True)
    return stall


def place_drive(name, cam, orb_cfg, voc, what):
    """One place-recognition drive (phase 9): the panorama through
    SLAMSystem.track_rgbd with a vocabulary and the mapping worker, paced.
    -> (entries, system with its worker still running, LoopCapture)."""
    print(f"[{name}] SLAMSystem.track_rgbd with a {voc.n_words}-word vocabulary and "
          f"the mapping worker, panorama (room world), {N_FRAMES_PLACE} frames, {what}, "
          f"a keyframe every {PLACE_KF_EVERY} frames, loop consistency 2, paced while "
          f"two keyframes are queued", flush=True)
    t0 = time.perf_counter()
    seq = SyntheticSequence(cam, n_frames=N_FRAMES_PLACE, trajectory="panorama", seed=7,
                            world="room")
    frames = [seq.render(i) for i in range(N_FRAMES_PLACE)]
    print(f"  rendered in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = SLAMConfig(cam=cam, orb=orb_cfg, th_depth=4.0, max_keyframes=96,
                     max_points=16384, local_point_cap=4096, max_frames_between_kf=5,
                     min_init_features=300, force_kf_every=PLACE_KF_EVERY,
                     pipelined_fetch=False, profile_stages=True)
    system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=voc)   # default device: the card
    closer, worker = system.loop_closer, system.mapping_worker
    if closer is None or worker is None or closer.device.type != "cuda":
        fail(f"{name}: no loop closer on the card")
    closer.cfg.consistency_threshold = 2

    def pace():
        t_wait = time.perf_counter()
        while worker.queue_size() >= 2 and time.perf_counter() - t_wait < 30:
            time.sleep(0.005)

    frame_log = []    # per frame: its milliseconds, loops closed when it returned
    waits = {"synchronize": 0, "profiler": 0}

    def track(gray, depth, timestamp):
        t_frame = time.perf_counter()
        tcw = system.track_rgbd(gray, depth, timestamp)
        frame_log.append(((time.perf_counter() - t_frame) * 1e3, closer.n_loops_closed))
        # between frames a caller may wait for the whole device: the
        # worker's captures and graph launches never run then
        # (utils/graph_capture.py)
        torch.cuda.synchronize()
        waits["synchronize"] += 1
        if len(frame_log) % PLACE_PROFILE_EVERY == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.cuda.synchronize()    # the profiler's stop waits too
            waits["profiler"] += 1
        return tcw

    with LoopCapture(closer) as captured:
        d = drive(name, track, system.tracker, frames, seq, pace)
        t0 = time.perf_counter()
        if not system.wait_mapping_idle(600):    # raises a failed stage's exception
            fail(f"{name}: mapping and loop closing did not finish within 600 s")
        wait_s = time.perf_counter() - t0
    ate = check_trajectory(name, system.tracker, seq, d)
    lc_stats = closer.stats.summary()
    mapper_stats = system.local_mapper.stats.summary()
    print(f"  frames tracked {d['tracked']}/{N_FRAMES_PLACE}, keyframes created "
          f"{int(system.map._kf_counter)} (live {system.map.n_keyframes()}), points live "
          f"{system.map.n_points()}, loops closed {closer.n_loops_closed}, global BAs "
          f"applied {closer.n_gba_applied}, superseded {closer.n_gba_superseded}, "
          f"correction_gen {system.map.correction_gen}, local BAs applied "
          f"{system.local_mapper.counts['ba_applied']}, dropped "
          f"{system.local_mapper.counts['ba_dropped']} (correction_gen); frames "
          f"revalidated {d['revalidated_frames']}; ATE-RMSE {ate:.4f} m; "
          f"{d['ms_per_frame']:.2f} ms per steady-state frame without the pacing waits, "
          f"median {d['median_ms']:.2f} ms, p95 {d['p95_ms']:.2f} ms; kernel launches "
          f"{d['launches']}; idle {wait_s:.2f} s after the last frame", flush=True)
    stall = longest_frame_at_loop(frame_log, d["median_ms"])
    print("  loop closer (worker thread; gba_solve on its own thread):", flush=True)
    print(closer.stats.report(), flush=True)
    print("  mapper stages, loop_closing included:", flush=True)
    print(system.local_mapper.stats.report(), flush=True)
    mc = system.local_mapper.counts
    programs = check_solve_programs_ran(name, system, {
        "local_ba": mc["ba_applied"] + mc["ba_dropped"],
        "essential_graph": closer.n_loops_closed,
        "gba": closer.n_gba_applied + closer.n_gba_superseded},
        threads={"local_ba": "mapping-worker", "essential_graph": "mapping-worker",
                 "gba": "gba-worker"})
    print(f"  between frames: torch.cuda.synchronize() {waits['synchronize']} times, a "
          f"torch.profiler started and stopped {waits['profiler']} times, while the "
          f"worker's and the GBA thread's programs captured (above)", flush=True)
    entries = dict(
        geometry=what, device_waits_between_frames=waits, launches=d["launches"], tracked=d["tracked"], ate_m=ate,
        loops_closed=closer.n_loops_closed, gba_applied=closer.n_gba_applied,
        gba_superseded=closer.n_gba_superseded, correction_gen=system.map.correction_gen,
        local_ba_dropped=system.local_mapper.counts["ba_dropped"],
        revalidated_frames=d["revalidated_frames"],
        keyframes_created=int(system.map._kf_counter),
        ms_per_frame=d["ms_per_frame"], median_ms=d["median_ms"], p95_ms=d["p95_ms"],
        idle_after_last_frame_s=wait_s,
        loop_closer_stage_median_ms={k: v["median_ms"] for k, v in lc_stats.items()},
        loop_closer_stage_total_s={k: v["total_s"] for k, v in lc_stats.items()},
        loop_closing_stage_ms=mapper_stats.get("loop_closing", {}),
        longest_frame_at_loop=stall,
        gba_solve_ms=lc_stats.get("gba_solve", {}).get("median_ms"),
        mapper_stage_median_ms={k: v["median_ms"] for k, v in mapper_stats.items()},
        solve_programs=programs)
    return entries, system, captured, seq, frames


def drive_place_recognition(cam, orb_cfg):
    """Phase 9 at full width; at the verify geometry when that closes no loop."""
    voc = get_large_vocabulary()
    d, system, captured, seq, frames = place_drive(
        "place", cam, orb_cfg, voc, "640x480 / 2000 features / 8 levels")
    if d["loops_closed"] == 0:
        print("  the full-width drive closed no loop; the phase runs again at the verify "
              "geometry (320x240 / 800 features / 4 levels)", flush=True)
        system.shutdown()
        small = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320,
                              height=240, bf=26.0)
        d, system, captured, seq, frames = place_drive(
            "place", small, orb.ORBConfig(n_features=800, n_levels=4), voc,
            "320x240 / 800 features / 4 levels (verify geometry)")
        cam = small
    if d["tracked"] != N_FRAMES_PLACE:
        fail(f"place: {d['tracked']}/{N_FRAMES_PLACE} frames tracked")
    if d["loops_closed"] < 1:
        fail("place: no loop was closed")
    if d["gba_applied"] < 1:
        fail("place: no global BA was applied")
    if d["ate_m"] >= PLACE_ATE_MAX_M:
        fail(f"place: ATE {d['ate_m']:.4f} m, limit {PLACE_ATE_MAX_M} m")
    return d, system, captured, seq, frames, cam


def check_relocalization(system, seq, frames) -> dict:
    """Phase 10: the phase-9 tracker, set LOST without a motion model,
    tracks a mapped frame again through the keyframe database."""
    tracker = system.tracker
    calls = []
    solve = tracking_mod.epnp.epnp_ransac

    def spy(*a, **k):
        res = solve(*a, **k)
        calls.append(int(res.n_inliers))
        return res

    tracker.state = TrackingState.LOST
    tracker.velocity = None
    tracking_mod.epnp.epnp_ransac = spy
    cuda_orb.fused_orient_describe.launches = 0
    try:
        t0 = time.perf_counter()
        tcw = system.track_rgbd(*frames[RELOC_FRAME], N_FRAMES_PLACE / seq.fps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        tracking_mod.epnp.epnp_ransac = solve
    launches = cuda_orb.fused_orient_describe.launches
    if tcw is None or tracker.state != TrackingState.OK:
        fail("reloc: the tracker did not relocalize")
    err = float(np.linalg.norm(np.linalg.inv(tcw)[:3, 3]
                               - np.linalg.inv(seq.poses[RELOC_FRAME])[:3, 3]))
    print(f"[reloc] LOST tracker on frame {RELOC_FRAME}: relocalized with "
          f"{tracker.matches_inliers} inliers, camera centre {err:.4f} m from the truth "
          f"(limit {RELOC_TOL_M}), EPnP RANSAC runs {len(calls)} (inliers {calls}), "
          f"{ms:.1f} ms for the frame, kernel launches {launches}", flush=True)
    if not calls:
        fail("reloc: relocalized without the keyframe database (no EPnP run)")
    if err >= RELOC_TOL_M:
        fail(f"reloc: {err:.4f} m from the true pose")
    if launches != 1:
        fail(f"reloc: {launches} kernel launches, expected 1")
    return dict(err_m=err, epnp_runs=len(calls), epnp_inliers=calls,
                inliers=tracker.matches_inliers, ms=ms, launches=launches)


def _centre_diff(a: np.ndarray, b: np.ndarray) -> float:
    """Largest camera-centre difference of two pose or Sim3 stacks."""
    def centres(p):
        p = p.astype(np.float64)
        s = np.cbrt(np.linalg.det(p[:, :3, :3]))
        r = p[:, :3, :3] / s[:, None, None]
        return -np.einsum("kji,kj->ki", r, p[:, :3, 3] / s[:, None])
    return float(np.linalg.norm(centres(a) - centres(b), axis=1).max())


def _timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def check_loop_card_vs_cpu(captured, voc, cam) -> dict:
    """Phase 11: the last essential graph and global BA of phase 9, card
    against CPU in float64, and in float32; the BoW word ids of the drive
    again on the CPU."""
    if captured.eg is None or captured.gba is None:
        fail("loop: phase 9 solved no essential graph or no global BA")
    out = {}

    def sync_of(dev):
        return torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def as_dtype(x, dtype):
        return x.to(dtype) if x.is_floating_point() else x

    # essential graph
    args, kw = captured.eg
    if args[0].dtype != torch.float64 or not args[0].is_cuda:
        fail(f"loop: the essential graph was staged as {args[0].dtype} on "
             f"{args[0].device}, expected float64 on the card")
    valid = args[1].cpu().numpy()
    runs = {}
    for dev, dtype in ((CARD, torch.float64), ("cpu", torch.float64),
                       (CARD, torch.float32)):
        a = [as_dtype(x.to(dev), dtype) for x in args]
        sync = sync_of(dev)
        pose_graph.optimize_essential_graph(*a, **kw)            # warm-up
        (poses, _), ms = _timed(lambda: pose_graph.optimize_essential_graph(*a, **kw), sync)
        runs[(dev, dtype)] = (poses.cpu().numpy()[valid], ms)
    a64 = [x.to(CARD) for x in args]
    eg_act = device_activity(lambda: pose_graph.optimize_essential_graph(*a64, **kw))
    eg64 = _centre_diff(runs[(CARD, torch.float64)][0], runs[("cpu", torch.float64)][0])
    eg32 = _centre_diff(runs[(CARD, torch.float32)][0], runs[("cpu", torch.float64)][0])
    print(f"[loop] essential graph: {int(valid.sum())} keyframes, {args[3].shape[0]} edges; "
          f"card vs CPU float64 camera centres {eg64:.3e} m (limit "
          f"{LOOP_TRANSLATION_TOL_M}); float32 card vs float64 CPU {eg32:.3e} m; one solve: "
          f"card float64 {runs[(CARD, torch.float64)][1]:.1f} ms, card float32 "
          f"{runs[(CARD, torch.float32)][1]:.1f} ms, CPU float64 "
          f"{runs[('cpu', torch.float64)][1]:.1f} ms", flush=True)
    print(f"[loop] essential graph, card float64 under torch.profiler: "
          f"{eg_act[0]} kernel launches, {eg_act[1]} device operations, busy "
          f"{eg_act[2]:.1f} ms of {eg_act[3]:.1f} ms", flush=True)
    out.update(eg_launches=eg_act[0], eg_device_ops=eg_act[1], eg_device_busy_ms=eg_act[2],
               eg_profiled_wall_ms=eg_act[3])
    out.update(eg_keyframes=int(valid.sum()), eg_edges=int(args[3].shape[0]),
               eg_centre_diff_m=eg64, eg_f32_centre_diff_m=eg32,
               eg_card_f64_ms=runs[(CARD, torch.float64)][1],
               eg_card_f32_ms=runs[(CARD, torch.float32)][1],
               eg_cpu_f64_ms=runs[("cpu", torch.float64)][1])
    if eg64 > LOOP_TRANSLATION_TOL_M:
        fail(f"loop: essential graph card vs CPU {eg64} m")

    # global BA
    problem, kw = captured.gba
    if problem.poses.dtype != torch.float64 or not problem.poses.is_cuda:
        fail(f"loop: the global BA was staged as {problem.poses.dtype} on "
             f"{problem.poses.device}, expected float64 on the card")
    cams = ~problem.cam_fixed.cpu().numpy()
    runs = {}
    for dev, dtype in ((CARD, torch.float64), ("cpu", torch.float64),
                       (CARD, torch.float32)):
        prob = ba.BAProblem(*(as_dtype(x.to(dev), dtype) for x in problem))
        k = {key: (v.to(dev) if torch.is_tensor(v) else v) for key, v in kw.items()}
        sync = sync_of(dev)
        if dev == CARD:
            ba.bundle_adjust_pcg(prob, cam, **k)                     # warm-up
        res, ms = _timed(lambda: ba.bundle_adjust_pcg(prob, cam, **k), sync)
        runs[(dev, dtype)] = (res.poses.cpu().numpy()[cams], res.points.cpu().numpy(), ms)
    prob64 = ba.BAProblem(*(x.to(CARD) for x in problem))
    k64 = {key: (v.to(CARD) if torch.is_tensor(v) else v) for key, v in kw.items()}
    gba_act = device_activity(lambda: ba.bundle_adjust_pcg(prob64, cam, **k64))
    pt_free = ~kw["point_fixed"].cpu().numpy()
    gba64 = _centre_diff(runs[(CARD, torch.float64)][0], runs[("cpu", torch.float64)][0])
    gba32 = _centre_diff(runs[(CARD, torch.float32)][0], runs[("cpu", torch.float64)][0])
    pts64 = float(np.abs(runs[(CARD, torch.float64)][1]
                         - runs[("cpu", torch.float64)][1])[pt_free].max())
    n_obs = int(problem.obs_valid.sum())
    print(f"[loop] global BA: {int(cams.sum())} free keyframes, {int(pt_free.sum())} points, "
          f"{n_obs} observations ({problem.obs_cam.shape[0]} slots); card vs CPU float64 "
          f"camera centres {gba64:.3e} m (limit {LOOP_TRANSLATION_TOL_M}), points "
          f"{pts64:.3e} m; float32 card vs float64 CPU {gba32:.3e} m; one solve: card "
          f"float64 {runs[(CARD, torch.float64)][2]:.1f} ms, card float32 "
          f"{runs[(CARD, torch.float32)][2]:.1f} ms, CPU float64 "
          f"{runs[('cpu', torch.float64)][2]:.1f} ms", flush=True)
    print(f"[loop] global BA, card float64 under torch.profiler: {gba_act[0]} kernel "
          f"launches, {gba_act[1]} device operations, busy {gba_act[2]:.1f} ms of "
          f"{gba_act[3]:.1f} ms", flush=True)
    out.update(gba_launches=gba_act[0], gba_device_ops=gba_act[1],
               gba_device_busy_ms=gba_act[2], gba_profiled_wall_ms=gba_act[3])
    out.update(gba_free_keyframes=int(cams.sum()), gba_points=int(pt_free.sum()),
               gba_observations=n_obs, gba_centre_diff_m=gba64, gba_point_diff_m=pts64,
               gba_f32_centre_diff_m=gba32,
               gba_card_f64_ms=runs[(CARD, torch.float64)][2],
               gba_card_f32_ms=runs[(CARD, torch.float32)][2],
               gba_cpu_f64_ms=runs[("cpu", torch.float64)][2])
    if gba64 > LOOP_TRANSLATION_TOL_M:
        fail(f"loop: global BA card vs CPU {gba64} m")

    # word ids
    differ = n_words = 0
    for desc, valid_kp, ids in captured.words:
        cpu_ids = voc.transform_packed(desc.cpu(), valid_kp.cpu()).numpy()
        differ += int((cpu_ids != ids).sum())
        n_words += ids.size
    print(f"[loop] BoW word ids of {len(captured.words)} transforms ({n_words} "
          f"descriptors) card vs CPU: {differ} differ", flush=True)
    if not captured.words or differ:
        fail(f"loop: {differ} word ids differ between the card and the CPU")
    out.update(word_transforms=len(captured.words), word_ids_compared=n_words,
               word_ids_differ=differ)
    return out


KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241,
                 height=376, bf=386.1448)   # bench.py's bench_kitti_full (KITTI 00)
KITTI_ORB = dict(n_features=2000, n_levels=8)
# the stereo drive (phase 12): bench_kitti_full's two laps of the room
# circuit, 4 pi over 420 frames (0.030 rad a frame); one lap (circuit, 2.3 pi
# over 240 frames) revisits only its last 0.3 pi and closed no loop
N_FRAMES_STEREO = 420
STEREO_TRAJECTORY = "circuit2"
STEREO_INIT_BY = 20       # tracking must start before this frame
STEREO_ATE_MAX_M = 0.25   # the CPU twin's limit (tests/test_e2e_kitti_scale.py)
KITTI_MAX_POINTS = 150_000
KITTI_MIN_INIT = 400      # bench_kitti_full's stereo initialisation gate
# match_stereo card vs CPU on the same keypoints and pyramids: a SAD summed
# in another order may flip its argmin on a near-tie, so a few keypoints
# may be matched on one side only; uR agrees to 1e-3 px on the rest
STEREO_FLIP_SHARE = 0.01
STEREO_UR_TOL_PX = 1e-3
STEREO_DEPTH_REL_MAX = 0.05   # tests/test_e2e_stereo.py:36
# native bindings: the viewing normal and scale band are float32 in the
# engine and mixed float32 / float64 in numpy
NATIVE_FLOAT_RTOL = 1e-5


def render_stereo_frames(seq, n_frames):
    """Rectified pairs of the sequence, rendered on the host's cores."""
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        return [(l, r) for l, r, _ in pool.map(seq.render_stereo, range(n_frames))]


def drive_stereo_kitti():
    """Phase 12: SLAMSystem.track_stereo at KITTI geometry and capacity with
    the 10 000-word vocabulary and the mapping worker, paced by
    bench_kitti_full's backlog gate (a frame waits while a keyframe is
    queued). -> (entries, system after shutdown, seq, frames)."""
    cam = PinholeCamera(**KITTI_CAM)
    cfg = SLAMConfig(cam=cam, orb=orb.ORBConfig(**KITTI_ORB), th_depth=cam.bf / cam.fx * 40.0,
                     max_keyframes=1536, max_points=KITTI_MAX_POINTS, local_point_cap=4096,
                     max_frames_between_kf=10, min_init_features=KITTI_MIN_INIT,
                     async_mapping=True, pipelined_fetch=False, profile_stages=True)
    print(f"[stereo] SLAMSystem.track_stereo at KITTI geometry (1241x376, 2000 features, "
          f"8 levels) and capacity ({cfg.max_keyframes} keyframes, {cfg.max_points} points), "
          f"10 000-word vocabulary, mapping worker, loop consistency 2; {STEREO_TRAJECTORY} "
          f"(room world, seed 9), {N_FRAMES_STEREO} frames, paced while a keyframe is queued",
          flush=True)
    t0 = time.perf_counter()
    seq = SyntheticSequence(cam, n_frames=N_FRAMES_STEREO, trajectory=STEREO_TRAJECTORY,
                            seed=9, world="room")
    frames = render_stereo_frames(seq, N_FRAMES_STEREO)
    print(f"  rendered in {time.perf_counter() - t0:.1f} s", flush=True)
    system = SLAMSystem(cfg, Sensor.STEREO, vocabulary=get_large_vocabulary())
    closer, worker, tracker = system.loop_closer, system.mapping_worker, system.tracker
    if closer is None or worker is None or tracker.device.type != "cuda":
        fail("stereo: no loop closer or mapping worker on the card")
    closer.cfg.consistency_threshold = 2
    m = system.map
    mir = m.device_mirror(tracker.device)
    if not (m.cap.max_points == len(m.pt_valid) == KITTI_MAX_POINTS
            and mir.pt_pos.shape[0] == KITTI_MAX_POINTS and mir.pt_pos.is_cuda):
        fail("stereo: the map is not allocated at full KITTI capacity on the card")

    def pace():
        t_wait = time.perf_counter()
        while worker.queue_size() >= 1 and time.perf_counter() - t_wait < 30:
            time.sleep(0.002)

    frame_log = []    # per frame: its milliseconds, loops closed when it returned
    built = []        # per frame: the Frame it built

    def track(left, right, timestamp):
        t_frame = time.perf_counter()
        tcw = system.track_stereo(left, right, timestamp)
        frame_log.append(((time.perf_counter() - t_frame) * 1e3, closer.n_loops_closed))
        built.append(tracker.last_frame)
        return tcw

    d = drive("stereo", track, tracker, frames, seq, pace)
    t0 = time.perf_counter()
    if not system.wait_mapping_idle(600):
        fail("stereo: mapping and loop closing did not finish within 600 s")
    wait_s = time.perf_counter() - t0
    system.shutdown()
    if d["first_ok"] >= STEREO_INIT_BY:
        fail(f"stereo: tracking started at frame {d['first_ok']}, not before {STEREO_INIT_BY}")
    ate = check_trajectory("stereo", tracker, seq, d)    # true scale: stereo
    lib = native.loaded_path()
    want_lib = os.path.join(os.path.dirname(os.path.abspath(native.__file__)), os.pardir,
                            "_build", "libmapgraph.so")
    if lib is None or os.path.realpath(lib) != os.path.realpath(want_lib):
        fail(f"stereo: the map-graph engine was loaded from {lib}, not {want_lib}")
    matches = [int((fr.ur >= 0).sum()) for fr in built]
    lc = closer.stats.summary()
    ms_stats = system.local_mapper.stats.summary()
    tr_stats = tracker.stats.summary()
    covis = tr_stats.get("kf_covis", {})
    print(f"  frames tracked {d['tracked']}/{N_FRAMES_STEREO} from frame {d['first_ok']}, "
          f"keyframes created {int(m._kf_counter)} (live {m.n_keyframes()}), points live "
          f"{m.n_points()} of {m.cap.max_points}, loops closed {closer.n_loops_closed}, "
          f"global BAs applied {closer.n_gba_applied}, ATE-RMSE {ate:.4f} m (true scale); "
          f"{d['ms_per_frame']:.2f} ms per steady-state frame without the pacing waits, "
          f"median {d['median_ms']:.2f} ms, p95 {d['p95_ms']:.2f} ms; stereo matches per "
          f"frame median {np.median(matches):.0f} (min {min(matches)}, max {max(matches)}); "
          f"kernel launches {d['launches']} for {N_FRAMES_STEREO} frames "
          f"({d['rebuilt_frames']} rebuilt); {remapped(d)}; kf_covis per keyframe median "
          f"{covis.get('median_ms', float('nan')):.2f} ms, mean "
          f"{covis.get('mean_ms', float('nan')):.2f} ms over {covis.get('n', 0)}; idle "
          f"{wait_s:.2f} s after the last frame; map-graph engine {lib}", flush=True)
    stall = longest_frame_at_loop(frame_log, d["median_ms"])
    print("  tracker stages:", flush=True)
    print(tracker.stats.report(), flush=True)
    print("  mapper stages (worker thread), loop_closing included:", flush=True)
    print(system.local_mapper.stats.report(), flush=True)
    print("  loop closer (worker thread; gba_solve on its own thread):", flush=True)
    print(closer.stats.report(), flush=True)
    mc = system.local_mapper.counts
    programs = check_solve_programs_ran("stereo", system, {
        "local_ba": mc["ba_applied"] + mc["ba_dropped"],
        "essential_graph": closer.n_loops_closed,
        "gba": closer.n_gba_applied + closer.n_gba_superseded})
    if closer.n_loops_closed < 1:
        fail("stereo: no loop was closed")
    if ate >= STEREO_ATE_MAX_M:
        fail(f"stereo: ATE {ate:.4f} m, limit {STEREO_ATE_MAX_M} m")
    entries = dict(
        launches=d["launches"], launches_per_frame_build=d["launches"]
        / (N_FRAMES_STEREO + d["rebuilt_frames"]), rebuilt_frames=d["rebuilt_frames"],
        first_ok=d["first_ok"], tracked=d["tracked"], ate_m=ate,
        loops_closed=closer.n_loops_closed, gba_applied=closer.n_gba_applied,
        keyframes_created=int(m._kf_counter), keyframes_live=int(m.n_keyframes()),
        points_live=int(m.n_points()), max_points=int(m.cap.max_points),
        ms_per_frame=d["ms_per_frame"], median_ms=d["median_ms"], p95_ms=d["p95_ms"],
        stereo_matches_median=float(np.median(matches)),
        kf_covis_ms=covis, idle_after_last_frame_s=wait_s, longest_frame_at_loop=stall,
        remapped_ids=d["remapped_ids"], reused_slot_ids=d["reused_slot_ids"],
        replacements_lost=d["replacements_lost"],
        native_library=lib,
        tracker_stage_median_ms={k: v["median_ms"] for k, v in tr_stats.items()},
        mapper_stage_median_ms={k: v["median_ms"] for k, v in ms_stats.items()},
        loop_closer_stage_median_ms={k: v["median_ms"] for k, v in lc.items()},
        sm_clock_mhz_median=float(np.median(d["mhz"])), solve_programs=programs)
    return entries, system, seq, frames


def check_stereo_parts(system, seq, frames) -> dict:
    """Phase 13: match_stereo card vs CPU on one KITTI pair, the paired
    describe launch against its plain version with its times, and every
    native map-graph binding against its numpy plain version on phase 12's
    final map."""
    out = {}
    ex = system.tracker.extractor
    cam = system.cfg.cam
    host = lambda: None    # host-side work needs no synchronisation
    dev = system.tracker.device
    gl, gr = (torch.as_tensor(x, dtype=torch.float32).to(dev) for x in frames[0])
    _, _, depth_gt = seq.render_stereo(0)
    (kp_l, pyr_l), (kp_r, pyr_r) = ex.extract_pair_with_pyramid(gl, gr)
    sf, budgets = ex.config.scale_factor, ex.level_budgets

    def on(dev_, kp, pyr):
        return (kp.replace(**{f: getattr(kp, f).to(dev_) for f in
                              ("xy", "response", "angle", "octave", "size", "desc", "valid")}),
                [p.to(dev_) for p in pyr])

    args = {}
    for where, dev_ in (("card", dev), ("cpu", torch.device("cpu"))):
        (kl, pl), (kr, pr) = on(dev_, kp_l, pyr_l), on(dev_, kp_r, pyr_r)
        args[where] = (kl, kr, pl, pr)
    run = {w: (lambda w=w: stereo.match_stereo(*args[w], cam, sf, level_budgets=budgets))
           for w in args}
    ur_c, d_c = (x.cpu().numpy() for x in run["card"]())
    (ur_u, d_u), cpu_ms = _timed(lambda: [x.numpy() for x in run["cpu"]()], host)
    mc, mu = ur_c >= 0, ur_u >= 0
    differ, both = int((mc ^ mu).sum()), mc & mu
    ur_diff = float(np.abs(ur_c - ur_u)[both].max()) if both.any() else 0.0
    xy = kp_l.xy.cpu().numpy()[mc]
    xi = np.clip(np.round(xy[:, 0]).astype(int), 0, cam.width - 1)
    yi = np.clip(np.round(xy[:, 1]).astype(int), 0, cam.height - 1)
    gt = depth_gt[yi, xi]
    rel = np.abs(d_c[mc][gt > 0] - gt[gt > 0]) / gt[gt > 0]
    card_ms = event_ms(run["card"], 20)
    act = device_activity(run["card"])
    kl, kr, pl, pr = args["card"]
    ur0 = kr.xy[:, 0][:kl.n]    # any right x per slot: the SAD's work does not depend on it

    def run_sad():
        stereo._sad_subpixel(pl, pr, kl.xy, ur0, sf, budgets)

    sad_ms = event_ms(run_sad, 20)
    sad_act = device_activity(run_sad)
    print(f"[stereo parts] match_stereo on frame 0 ({kl.n} + {kr.n} keypoints): card "
          f"{int(mc.sum())} matches, CPU {int(mu.sum())}, {differ} on one side only "
          f"(limit {STEREO_FLIP_SHARE * 100:.0f} %), uR difference on common matches "
          f"{ur_diff:.2e} px (limit {STEREO_UR_TOL_PX}); depth against the renderer: median "
          f"relative error {np.median(rel):.4f} (limit {STEREO_DEPTH_REL_MAX}) over "
          f"{rel.size} matches\n"
          f"  one call: card {card_ms:.3f} ms (CUDA events, host-paced), CPU {cpu_ms:.1f} ms; "
          f"under torch.profiler {act[0]} kernel launches, busy {act[2]:.3f} of "
          f"{act[3]:.3f} ms; SAD refinement alone {sad_ms:.3f} ms, {sad_act[0]} launches, "
          f"busy {sad_act[2]:.3f} of {sad_act[3]:.3f} ms", flush=True)
    if not mc.any() or differ > max(2, STEREO_FLIP_SHARE * mu.sum()):
        fail(f"stereo parts: {differ} matches differ between the card and the CPU")
    if ur_diff > STEREO_UR_TOL_PX:
        fail(f"stereo parts: uR differs by {ur_diff} px between the card and the CPU")
    if not np.median(rel) < STEREO_DEPTH_REL_MAX:
        fail(f"stereo parts: median depth error {np.median(rel):.4f}")
    out.update(matches_card=int(mc.sum()), matches_cpu=int(mu.sum()), matches_differ=differ,
               ur_diff_px=ur_diff, depth_rel_err_median=float(np.median(rel)),
               match_card_ms=card_ms, match_cpu_ms=cpu_ms, match_launches=act[0],
               match_busy_ms=act[2], match_wall_ms=act[3], sad_card_ms=sad_ms,
               sad_launches=sad_act[0], sad_busy_ms=sad_act[2], sad_wall_ms=sad_act[3])

    # ---- both images' levels in one describe launch ----
    levels = [ex._levels(gl), ex._levels(gr)]
    both_lv = [sum((list(lv[i]) for lv in levels), []) for i in range(4)]
    budgets16 = list(budgets) * 2
    args16 = (*both_lv, ex.pattern_t, budgets16)
    args8 = (*levels[0][:4], ex.pattern_t, budgets)
    out16 = cuda_orb.fused_orient_describe_levels(*args16)
    plain16 = cuda_orb.fused_orient_describe_levels_plain(*args16)
    stats = compare(f"both images, {len(budgets16)} levels, one launch", out16, plain16)
    # one order of the float sums in both (csrc/orient_describe.cu): the
    # descriptors are identical, and the angles within phase 3's figure
    n_differ = int((hamming_rows(out16[1], plain16[1]) > 0).sum())
    print(f"  differing descriptors {n_differ} of {out16[1].shape[0]} slots (must be 0), "
          f"max angle difference {stats['max_angle_err']:.2e} rad (limit "
          f"{STEREO16_ANGLE_TOL_RAD})", flush=True)
    if n_differ:
        fail(f"stereo parts: {n_differ} descriptors differ from the plain version")
    if stats["max_angle_err"] > STEREO16_ANGLE_TOL_RAD:
        fail(f"stereo parts: angles differ by {stats['max_angle_err']} rad")

    def run8():
        cuda_orb.fused_orient_describe_levels(*args8)

    print("  describe, one launch for both images; one image's 8 levels beside it",
          flush=True)
    out["describe16"] = dict(
        max_abs_err=stats["max_angle_err"], descriptor_exact_share_min=stats["ham_exact_share"],
        descriptors_differing=n_differ,
        **describe_times(args16, run8, 1, "one_image_8_levels",
                         "one launch over one image's 8 levels"),
        ms_covers="one stereo frame build: one launch for both images' 16 levels at "
                  "1241x376, timed by CUDA events around wrapper calls (host-paced); "
                  "device_ms is the kernel's own duration on the card with L2 flushed "
                  "before each launch, device_ms_warm_l2 with its inputs left in L2")

    # ---- the native map-graph engine against numpy on the final map ----
    m = system.map
    pids = system.tracker.last_frame.pt_ids
    pids = pids[pids >= 0]
    pairs = {
        "covis_weights": (lambda: covisibility.weight_matrix(m),
                          lambda: covisibility.weight_matrix_plain(m)),
        "invert_obs_slots": (lambda: native.invert_obs_slots(m.kf_pt, m.kf_valid,
                                                             m.cap.max_points),
                             m._obs_index_plain),
        "point_obs_count": (m._point_obs_count_impl, m._point_obs_count_plain),
        "share_from_index": (lambda: native.share_from_index(
            *m.obs_index()[:2], pids, m.cap.max_keyframes),
            lambda: covisibility.frame_share_plain(m, pids)),
    }
    # the port's weight matrix before the native engine: a [K, P] float32
    # incidence and its product (921 MB at full capacity)
    def dense_product():
        inc = m.incidence().astype(np.float32)
        w = (inc @ inc.T).astype(np.int32)
        np.fill_diagonal(w, 0)
        return w

    pairs["covis_weights_dense"] = (lambda: covisibility.weight_matrix(m), dense_product)
    timing = {}
    for name, (fast, plain) in pairs.items():
        a, fast_ms = _timed(fast, host)
        b, plain_ms = _timed(plain, host)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            fail(f"native: {name} differs from its numpy plain version")
        timing[name] = (fast_ms, plain_ms)
    pts = np.flatnonzero(m.pt_valid)
    a, b = copy.deepcopy(m), copy.deepcopy(m)
    b._obs_index_cache = (b.obs_gen, b._obs_index_plain())
    _, fast_ms = _timed(lambda: native.update_point_stats(a, pts, ex.config.scale_factor,
                                                          ex.config.n_levels), host)
    _, plain_ms = _timed(lambda: point_stats.update_points(
        b, pts, ex.config.scale_factor, ex.config.n_levels), host)
    timing["update_point_stats"] = (fast_ms, plain_ms)
    if not (np.array_equal(a.pt_desc, b.pt_desc) and np.array_equal(a.pt_ref_kf, b.pt_ref_kf)):
        fail("native: update_point_stats descriptors or reference keyframes differ")
    for f in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        if not np.allclose(getattr(a, f), getattr(b, f), rtol=NATIVE_FLOAT_RTOL, atol=1e-6):
            fail(f"native: update_point_stats {f} beyond rtol {NATIVE_FLOAT_RTOL}")
    print(f"  native map-graph engine vs numpy on the final map ({m.n_keyframes()} "
          f"keyframes, {m.n_points()} points, capacity {m.cap.max_keyframes} x "
          f"{m.cap.max_points}; {len(pids)} frame points, {len(pts)} points updated): "
          f"identical integers, floats within rtol {NATIVE_FLOAT_RTOL}; host ms native / "
          f"numpy: " + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in timing.items()),
          flush=True)
    out.update(native_ms={k: v[0] for k, v in timing.items()},
               numpy_ms={k: v[1] for k, v in timing.items()})
    return out


# ---- phases 14 to 16: the default configuration, localization, backlog ----
N_FRAMES_DEFAULTS_STEREO = 60   # the first frames of phase 12's drive
STEREO16_ANGLE_TOL_RAD = 8.34e-6   # phase 3's 640x480 figure of PRs 3-5
LOC_MAPPED = 6            # frames mapped before localization mode (test_localization_vo.py)
LOC_FRAMES = 24           # frames tracked in localization mode
LOC_MIN_TRACKED = 22
LOC_RPE_MAX_M = 0.05
# at full width the frames the JAX package loses on the CPU
# (tests/reference_full_width.py), and change_calibration while the map tracks
LOC_LOST_FULL = (27, 28, 29)
LOC_CALIB_FULL = LOC_MAPPED + 6
GAUGE_TOL = 1e-6          # the first keyframe through a global BA
BACKLOG_FRAMES = 40
BACKLOG_KF_EVERY = 2
BACKLOG_BA_DELAY_S = 0.5
# the four mapping paths a worker that falls behind takes, by their counters
BACKLOG_PATHS = {"correction_gen drop": "ba_dropped", "interrupt_ba": "ba_interrupted",
                 "backlog skip": "ba_backlog", "stage-conflict rerun": "conflicts"}


def defaults_config(cam, orb_cfg, **kw) -> SLAMConfig:
    """The slice's main path: SLAMConfig's defaults at phase 5's geometry and
    capacity (pipelined_fetch on, fetch_batch 1, the mapping worker on)."""
    return SLAMConfig(cam=cam, orb=orb_cfg, max_points=16384, local_point_cap=4096,
                      max_keyframes=64, th_depth=6.0, **kw)


def drive_defaults_rgbd(name, cfg, frames, seq):
    """One RGB-D drive with the default configuration, frames back to back as
    in phase 5; the stage timer is switched on by the script (it times, it
    configures nothing). -> (entries, system after shutdown)."""
    print(f"[{name}] SLAMSystem.track_rgbd with SLAMConfig's defaults (pipelined_fetch="
          f"{cfg.pipelined_fetch}, fetch_batch={cfg.fetch_batch}, mapping worker), "
          f"{len(frames)} frames back to back, 640x480 / 2000 features / 8 levels",
          flush=True)
    system = SLAMSystem(cfg, Sensor.RGBD)
    tracker = system.tracker
    tracker.stats.enabled = True
    d = drive(name, system.track_rgbd, tracker, frames, seq, pipelined=True)
    if not system.wait_mapping_idle(300):
        fail(f"{name}: the mapping worker did not become idle within 300 s")
    ate = check_trajectory(name, tracker, seq, d)
    waits = tracker.stats.summary().get("fused_dev", {})
    print(f"  frames tracked again (a discarded chain) {d['retracked_frames']}, built again "
          f"(the map moved under the step) {d['rebuilt_frames']}; waits for a fetch: "
          f"{waits.get('n', 0)}, median {waits.get('median_ms', float('nan')):.3f} ms",
          flush=True)
    describe(name, tracker, d, ate, len(frames))   # fails above ATE_MAX_M
    system.shutdown()
    return dict(launches=d["launches"], first_ok=d["first_ok"], tracked=d["tracked"],
                ate_m=ate, ms_per_frame=d["ms_per_frame"], median_ms=d["median_ms"],
                p95_ms=d["p95_ms"], retracked_frames=d["retracked_frames"],
                rebuilt_frames=d["rebuilt_frames"], fused_frames=d["fused_frames"],
                keyframes=int(system.map.n_keyframes()), fetch_wait_ms=waits,
                remapped_ids=d["remapped_ids"], reused_slot_ids=d["reused_slot_ids"],
                replacements_lost=d["replacements_lost"],
                sm_clock_mhz_median=float(np.median(d["mhz"]))), system


DEFAULTS_REPEATS = 10    # phase 14b: K = 1 drives repeated in one process
NEAR_M = 0.05            # 14b prints the first frame past this


def frame_errors(est_twc: np.ndarray, gt_twc: np.ndarray, first: int) -> np.ndarray:
    """Position error of each pose against the truth, the estimate moved
    rigidly onto the truth at frame `first`."""
    align = gt_twc[first] @ np.linalg.inv(est_twc[first])
    est = np.einsum("ij,njk->nik", align, est_twc)
    return np.linalg.norm(est[:, :3, 3] - gt_twc[:, :3, 3], axis=1)


def check_repeated_defaults(cam, orb_cfg, frames, seq) -> dict:
    """Phase 14b: the K = 1 defaults drive DEFAULTS_REPEATS times, each with a
    new system, shut down after it; each within ATE_MAX_M and no frame lost."""
    print(f"[defaults repeated] the K = 1 drive {DEFAULTS_REPEATS} times in one process, a "
          f"new SLAMSystem each, {len(frames)} frames back to back", flush=True)
    gt = np.stack([np.linalg.inv(seq.poses[i]) for i in range(len(frames))])
    runs = []
    for k in range(DEFAULTS_REPEATS):
        name = f"defaults repeat {k}"
        system = SLAMSystem(defaults_config(cam, orb_cfg), Sensor.RGBD)
        tracker = system.tracker
        tracker.stats.enabled = True
        d = drive(name, system.track_rgbd, tracker, frames, seq, pipelined=True)
        if not system.wait_mapping_idle(300):
            fail(f"{name}: the mapping worker did not become idle within 300 s")
        ate = check_trajectory(name, tracker, seq, d)     # fails on a lost frame
        err = frame_errors(tracker.full_trajectory_twc(), gt, d["first_ok"])
        past = np.flatnonzero(err[d["first_ok"]:] > NEAR_M)
        first_past = int(past[0]) + d["first_ok"] if len(past) else None
        keyframes = int(system.map.n_keyframes())
        system.shutdown()
        runs.append(dict(ate_m=ate, tracked=d["tracked"], keyframes=keyframes,
                         retracked_frames=d["retracked_frames"],
                         rebuilt_frames=d["rebuilt_frames"], launches=d["launches"],
                         max_error_m=float(err[d["first_ok"]:].max()),
                         first_frame_past_005=first_past))
        print(f"  drive {k}: ATE {ate:.4f} m, {d['tracked']}/{len(frames)} tracked, "
              f"{keyframes} keyframes, {d['retracked_frames']} frames tracked again, "
              f"{d['rebuilt_frames']} built again; largest error "
              f"{runs[-1]['max_error_m']:.4f} m, first frame past {NEAR_M} m: {first_past}",
              flush=True)
    ates = [r["ate_m"] for r in runs]
    print(f"  ATE over {len(runs)} drives: min {min(ates):.4f}, median "
          f"{float(np.median(ates)):.4f}, max {max(ates):.4f} m", flush=True)
    far = [k for k, a in enumerate(ates) if a > ATE_MAX_M]
    if far:
        fail(f"defaults repeated: drives {far} above {ATE_MAX_M} m: "
             f"{[round(ates[k], 4) for k in far]}")
    return dict(runs=runs, launches=sum(r["launches"] for r in runs), ate_max_m=max(ates),
                ate_median_m=float(np.median(ates)))


def check_capture_after_drop(cam, orb_cfg, frames, seq) -> dict:
    """Phase 14c: tools/capture_after_drop.py's scenario; fails unless the
    next system's capture succeeds with the dropped programs collected
    inside it."""
    from orbslam2_tpu_torch.tools import capture_after_drop

    print("[capture after drop] a system's frame and local-BA graphs dropped inside the next "
          "system's first capture, gc.set_threshold(1, 1, 1)", flush=True)
    out = capture_after_drop.drop_inside_capture(
        lambda: SLAMSystem(defaults_config(cam, orb_cfg), Sensor.RGBD), frames, seq.fps)
    print(f"  {out['graphs_dropped']} graphs of {out['programs_dropped']} programs dropped "
          f"after {out['warm_frames']} frames; dropped inside the capture "
          f"{out['dropped_in_capture']}; the next system's capture error "
          f"{out['capture_error']}; its graphs captured {out['next_captures']}, frames lost "
          f"{out['next_frames_lost']}; programs freed after it {out['programs_freed']}",
          flush=True)
    if not out["ok"]:
        fail(f"capture after drop: {out}")
    return out


def drive_defaults_stereo(seq, frames):
    """Phase 14's stereo part: SLAMSystem.track_stereo at phase 12's geometry
    and capacity, with phase 12's settings (bench_kitti_full's th_depth,
    keyframe cadence and initialisation gate, 1536 keyframes x 150 000
    points) and every other field at its default: the pipelined fetch, no
    vocabulary. The first frames of phase 12's drive, back to back."""
    cam = seq.cam
    cfg = SLAMConfig(cam=cam, orb=orb.ORBConfig(**KITTI_ORB), th_depth=cam.bf / cam.fx * 40.0,
                     max_keyframes=1536, max_points=KITTI_MAX_POINTS, local_point_cap=4096,
                     max_frames_between_kf=10, min_init_features=KITTI_MIN_INIT)
    frames = frames[:N_FRAMES_DEFAULTS_STEREO]
    print(f"[defaults stereo] SLAMSystem.track_stereo with SLAMConfig's defaults at KITTI "
          f"geometry and capacity, the first {len(frames)} frames of {STEREO_TRAJECTORY}, "
          f"back to back", flush=True)
    system = SLAMSystem(cfg, Sensor.STEREO)
    tracker = system.tracker
    tracker.stats.enabled = True
    d = drive("defaults stereo", system.track_stereo, tracker, frames, seq, pipelined=True)
    if not system.wait_mapping_idle(300):
        fail("defaults stereo: the mapping worker did not become idle within 300 s")
    ate = check_trajectory("defaults stereo", tracker, seq, d)   # fails on a lost frame
    system.shutdown()
    print(f"  frames tracked {d['tracked']}/{len(frames)} from frame {d['first_ok']}, "
          f"keyframes {system.map.n_keyframes()}, ATE-RMSE {ate:.4f} m (true scale), "
          f"median {d['median_ms']:.2f} ms, p95 {d['p95_ms']:.2f} ms, {d['ms_per_frame']:.2f} "
          f"ms per steady-state frame; kernel launches {d['launches']} ({d['retracked_frames']} "
          f"frames tracked again, {d['rebuilt_frames']} built again); {remapped(d)}", flush=True)
    if d["first_ok"] >= STEREO_INIT_BY:
        fail(f"defaults stereo: tracking started at frame {d['first_ok']}, not before "
             f"{STEREO_INIT_BY}")
    return dict(launches=d["launches"], first_ok=d["first_ok"], tracked=d["tracked"],
                ate_m=ate, ms_per_frame=d["ms_per_frame"], median_ms=d["median_ms"],
                p95_ms=d["p95_ms"], retracked_frames=d["retracked_frames"],
                rebuilt_frames=d["rebuilt_frames"], remapped_ids=d["remapped_ids"],
                reused_slot_ids=d["reused_slot_ids"], replacements_lost=d["replacements_lost"],
                keyframes=int(system.map.n_keyframes()))


def program_counts(tracker: Tracker) -> dict:
    """-> {program: (graphs captured, replays)} over the tracker's fused
    frame programs ("fused <sensor>") and classic-path programs."""
    return {name: (p.captures, p.replays) for name, p in (
        *((f"fused {k}", p) for k, p in tracker.frame_programs.items()),
        *tracker.classic_programs.items())}


def program_of(tracker: Tracker, name: str):
    """The tracker's program of that name in ``program_counts``."""
    if name.startswith("fused "):
        return tracker.frame_programs[name[len("fused "):]]
    return tracker.classic_programs[name]


def localization_drive(name, cfg, calib_at, smi_line, lost_expected=None) -> dict:
    """tests/test_localization_vo.py's scenario through SLAMSystem with
    `cfg` (no vocabulary, as the test): map the first frames of the shuttle
    (cluttered world, seed 9), then track on in localization mode into
    unmapped space on temporal VO points. change_calibration to the same
    camera comes just before frame `calib_at`, which must be tracked, and the
    map must stay frozen. Without `lost_expected` the tracked count and the
    RPE are held to the test's limits; with it, the frames lost must be
    exactly those and the RPE over the tracked frames within the test's
    limit. Prints the ms a frame in localization mode, the graph replays and
    captures a frame, and every capture of the drive with its frame."""
    cam = cfg.cam
    n_all = LOC_MAPPED + LOC_FRAMES
    seq = SyntheticSequence(cam, n_frames=60, trajectory="shuttle", seed=9, world="cluttered")
    frames = [seq.render(i) for i in range(max(n_all, calib_at + 1))]
    print(f"[{name}] {LOC_MAPPED} frames mapped, then {LOC_FRAMES} in localization mode "
          f"(shuttle, cluttered world, seed 9, no vocabulary), {cam.width}x{cam.height} / "
          f"{cfg.orb.n_features} features / {cfg.orb.n_levels} levels; change_calibration "
          f"before frame {calib_at}", flush=True)
    system = SLAMSystem(cfg, Sensor.RGBD)
    tracker = system.tracker
    cuda_orb.fused_orient_describe.launches = 0
    landed = []    # (frame, program, capture ms, the frame's ms)

    def track(i):
        before = program_counts(tracker)
        t_frame = time.perf_counter()
        system.track_rgbd(*frames[i], i / seq.fps)
        frame_ms = (time.perf_counter() - t_frame) * 1e3
        for name, (n_cap, _) in program_counts(tracker).items():
            for k in range(before.get(name, (0, 0))[0], n_cap):
                landed.append((i, name, program_of(tracker, name).capture_ms[k], frame_ms))

    for i in range(LOC_MAPPED):
        track(i)
    system.activate_localization_mode()
    m = system.map
    frozen = (m.n_points(), m.n_keyframes(), m.pt_valid.copy(), m.kf_valid.copy(),
              m.pt_pos.copy(), m.kf_pose.copy())

    def calibrate():
        # the calibration, changed to the same camera, reaches the next frame
        system.change_calibration(PinholeCamera(**dataclasses.asdict(cam)))

    t0 = time.perf_counter()
    vo_frames = 0
    at_start = program_counts(tracker)
    for i in range(LOC_MAPPED, n_all):
        if i == calib_at:
            calibrate()
        track(i)
        vo_frames += tracker.mb_vo
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / LOC_FRAMES
    at_end = program_counts(tracker)
    replays = sum(at_end[k][1] - at_start.get(k, (0, 0))[1] for k in at_end) / LOC_FRAMES
    captures = sum(at_end[k][0] - at_start.get(k, (0, 0))[0] for k in at_end) / LOC_FRAMES
    launches = cuda_orb.fused_orient_describe.launches
    est = tracker.full_trajectory_twc()[LOC_MAPPED:n_all]
    lost = tracker.trajectory_lost_mask()[LOC_MAPPED:n_all]
    tracked = int((~lost).sum())
    lost_ids = (np.flatnonzero(lost) + LOC_MAPPED).tolist()
    gt = np.stack([np.linalg.inv(seq.poses[i]) for i in range(LOC_MAPPED, n_all)])
    t_rpe, r_rpe = rpe(est, gt)
    t_rpe_tracked = rpe(est[~lost], gt[~lost])[0] if tracked >= 2 else float("nan")
    unchanged = (m.n_points() == frozen[0] and m.n_keyframes() == frozen[1]
                 and np.array_equal(m.pt_valid, frozen[2]) and np.array_equal(m.kf_valid, frozen[3])
                 and np.array_equal(m.pt_pos, frozen[4]) and np.array_equal(m.kf_pose, frozen[5]))
    if calib_at >= n_all:
        calibrate()
        system.track_rgbd(*frames[calib_at], calib_at / seq.fps)
    calib_ok = not tracker.trajectory_lost_mask()[calib_at]
    system.shutdown()
    print(f"  map frozen {unchanged} ({frozen[0]} points, {frozen[1]} keyframes); frames "
          f"tracked {tracked}/{LOC_FRAMES} (lost: {lost_ids}), {vo_frames} on temporal points "
          f"only; RPE {t_rpe:.4f} m / {r_rpe:.5f} rad per frame, {t_rpe_tracked:.4f} m over "
          f"the tracked frames; {ms:.1f} ms a frame in localization mode, {replays:.2f} graph "
          f"replays and {captures:.2f} captures a frame | {smi_line}; kernel launches "
          f"{launches} for {n_all} frames; frame {calib_at} after change_calibration tracked: "
          f"{calib_ok}", flush=True)
    print("  captures: " + "; ".join(f"frame {i} {name} {cap:.1f} ms (the frame {f_ms:.1f} ms)"
                                     for i, name, cap, f_ms in landed), flush=True)
    if not unchanged:
        fail(f"{name}: the map changed in localization mode")
    if launches != n_all + tracker.rebuilt_frames + tracker.retracked_frames:
        fail(f"{name}: {launches} kernel launches for {n_all} frames")
    if not calib_ok:
        fail(f"{name}: frame {calib_at}, after change_calibration, was lost")
    if lost_expected is None:
        if tracked < LOC_MIN_TRACKED:
            fail(f"{name}: {tracked}/{LOC_FRAMES} frames tracked (limit {LOC_MIN_TRACKED})")
        if not t_rpe < LOC_RPE_MAX_M:
            fail(f"{name}: RPE {t_rpe:.4f} m per frame (limit {LOC_RPE_MAX_M} m)")
    else:
        if lost_ids != list(lost_expected):
            fail(f"{name}: frames {lost_ids} lost, the JAX package loses {list(lost_expected)}")
        if not t_rpe_tracked < LOC_RPE_MAX_M:
            fail(f"{name}: RPE {t_rpe_tracked:.4f} m per tracked frame (limit "
                 f"{LOC_RPE_MAX_M} m)")
    return dict(tracked=tracked, lost=lost_ids, vo_frames=int(vo_frames), rpe_m=t_rpe,
                rpe_rad=r_rpe, rpe_tracked_m=t_rpe_tracked, map_frozen=unchanged,
                ms_per_frame=ms, graph_replays_per_frame=replays,
                graph_captures_per_frame=captures,
                captures=[dict(frame=i, program=name, capture_ms=cap, frame_ms=f_ms)
                          for i, name, cap, f_ms in landed],
                launches=launches, calibration_frame=calib_at,
                tracked_after_change_calibration=calib_ok)


def check_localization(cam, orb_cfg, smi_line) -> dict:
    """Phase 15a. At full width a relocalization in the aliased cluttered
    world lands metres off late in the drive and frames 27-29 are lost, as
    the JAX package loses them on the CPU (tests/reference_full_width.py):
    that drive is held to the reference's outcome (the same frames lost, the
    map frozen, the RPE over the tracked frames), with change_calibration
    mid-drive while the map tracks. The test's own limits are held at its
    geometry (320x240 / 800 / 4), where neither package relocalizes."""
    full = localization_drive(
        "localization", defaults_config(cam, orb_cfg, max_frames_between_kf=10,
                                        min_init_features=300),
        calib_at=LOC_CALIB_FULL, smi_line=smi_line, lost_expected=LOC_LOST_FULL)
    small = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240,
                          bf=26.0)
    test = localization_drive(
        "localization, test geometry",
        SLAMConfig(cam=small, orb=orb.ORBConfig(n_features=800, n_levels=4), th_depth=4.0,
                   max_keyframes=64, max_points=8192, local_point_cap=2048,
                   max_frames_between_kf=10, min_init_features=300),
        calib_at=LOC_MAPPED + LOC_FRAMES, smi_line=smi_line)
    return {"full_width": full, "test_geometry": test,
            "launches": full["launches"] + test["launches"]}


def check_map_reload(place_system, seq, frames) -> dict:
    """Phase 15b: phase 9's map through save_map and load_map into a new
    system with the vocabulary, in localization mode, relocalizes a mapped
    frame through the keyframe database."""
    cfg = dataclasses.replace(place_system.cfg, localization_only=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        place_system.save_map(path)
        system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=place_system.vocabulary)
        system.load_map(path)
    system.activate_localization_mode()
    calls = []
    solve = tracking_mod.epnp.epnp_ransac

    def spy(*a, **k):
        res = solve(*a, **k)
        calls.append(int(res.n_inliers))
        return res

    tracking_mod.epnp.epnp_ransac = spy
    try:
        tcw = system.track_rgbd(*frames[RELOC_FRAME], N_FRAMES_PLACE / seq.fps)
    finally:
        tracking_mod.epnp.epnp_ransac = solve
    same = (system.map.n_points() == place_system.map.n_points()
            and np.array_equal(system.map.kf_pose, place_system.map.kf_pose))
    system.shutdown()
    if tcw is None:
        fail("map reload: the loaded map did not relocalize the frame")
    err = float(np.linalg.norm(np.linalg.inv(tcw)[:3, 3]
                               - np.linalg.inv(seq.poses[RELOC_FRAME])[:3, 3]))
    print(f"[map reload] phase 9's map saved and loaded ({system.map.n_keyframes()} "
          f"keyframes, {system.map.n_points()} points, identical: {same}); in localization "
          f"mode frame {RELOC_FRAME} relocalized {err:.4f} m from the truth (limit "
          f"{RELOC_TOL_M}), EPnP RANSAC runs {len(calls)}", flush=True)
    if not same:
        fail("map reload: the loaded map differs from the saved one")
    if not calls:
        fail("map reload: relocalized without the keyframe database (no EPnP run)")
    if err >= RELOC_TOL_M:
        fail(f"map reload: {err:.4f} m from the true pose")
    return dict(err_m=err, epnp_runs=len(calls))


def check_global_ba(system, seq) -> dict:
    """Phase 15c: SLAMSystem.global_bundle_adjust on the default drive's final
    map (phase 14, fetch_batch 1): the first keyframe is the gauge."""
    m = system.map
    n = len(system.tracker.trajectory)
    gt = np.stack([np.linalg.inv(seq.poses[i]) for i in range(n)])
    ate_before = ate_rmse(system.tracker.full_trajectory_twc(), gt)
    poses = m.kf_pose.copy()
    ids = m.keyframe_ids()
    change = m.change_index
    program = system._gba_program
    replays = program.replays
    t0 = time.perf_counter()
    system.global_bundle_adjust()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ate_after = ate_rmse(system.tracker.full_trajectory_twc(), gt)
    gauge = float(np.abs(m.kf_pose[ids[0]] - poses[ids[0]]).max())
    moved = float(np.abs(m.kf_pose[ids] - poses[ids]).max())
    print(f"[global BA] on phase 14's map ({len(ids)} keyframes, {m.n_points()} points): "
          f"{ms:.1f} ms, first keyframe moved {gauge:.2e} (limit {GAUGE_TOL}), the others up "
          f"to {moved:.2e}; ATE-RMSE {ate_before:.4f} m before, {ate_after:.4f} m after; "
          f"through the system's GBA program ({program.replays - replays} replay, "
          f"{program.captures} capture, {program.graph_launches} graph launches)", flush=True)
    if program.replays != replays + 1:
        fail("global BA: the solve did not run through the GBA program")
    if gauge > GAUGE_TOL:
        fail(f"global BA: the first keyframe moved by {gauge}")
    if m.change_index == change:
        fail("global BA: the map's change index did not move")
    if not np.isfinite(m.kf_pose[ids]).all():
        fail("global BA: a pose is not finite")
    return dict(ms=ms, gauge_moved=gauge, poses_moved=moved, ate_before_m=ate_before,
                ate_after_m=ate_after)


def drive_backlog(cam, orb_cfg, frames, seq, voc) -> dict:
    """Phase 16: make the mapping worker fall behind (a keyframe every second
    frame, every local-BA solve held BACKLOG_BA_DELAY_S longer, frames back to
    back, the vocabulary on) and count the four paths a worker behind takes.
    A path the drive did not reach is then provoked on its last keyframe, as
    the CPU test of that path does, and the phase says which came about by
    themselves. Fails unless each path ran at least once."""
    frames = frames[:BACKLOG_FRAMES]
    print(f"[backlog] SLAMSystem.track_rgbd with the defaults, a keyframe every "
          f"{BACKLOG_KF_EVERY} frames, each local BA held {BACKLOG_BA_DELAY_S} s longer, "
          f"{voc.n_words}-word vocabulary, {len(frames)} frames back to back", flush=True)
    cfg = defaults_config(cam, orb_cfg, force_kf_every=BACKLOG_KF_EVERY, profile_stages=True)
    system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=voc)
    mapper, tracker = system.local_mapper, system.tracker
    solve = mapper.ba_program
    queue_max = [0]

    def slow_solve(*a, **k):
        out = solve(*a, **k)
        time.sleep(BACKLOG_BA_DELAY_S)
        return out

    def pace():
        queue_max[0] = max(queue_max[0], system.mapping_worker.queue_size())

    mapper.ba_program = slow_solve
    try:
        d = drive("backlog", system.track_rgbd, tracker, frames, seq, pace, pipelined=True)
        if not system.wait_mapping_idle(300):
            fail("backlog: the mapping worker did not become idle within 300 s")
    finally:
        mapper.ba_program = solve
    natural = {path: mapper.counts[key] for path, key in BACKLOG_PATHS.items()}
    ate = check_trajectory("backlog", tracker, seq, d)
    m = system.map
    ids = m.keyframe_ids()
    kf = int(ids[np.argmax(m.kf_order[ids])])
    provoked = []

    def again(path, **kw):
        provoked.append(path)
        mapper.process_keyframe(kf, **kw)

    if not natural["correction_gen drop"]:
        def solve_during_correction(*a, **k):
            out = solve(*a, **k)
            with tracker.map_lock:
                m.correction_gen += 1    # a loop correction lands mid-solve
            return out

        mapper.ba_program = solve_during_correction
        try:
            again("correction_gen drop")
        finally:
            mapper.ba_program = solve
    if not natural["interrupt_ba"]:
        mapper.interrupt_ba = True       # the tracker asked for a keyframe
        again("interrupt_ba")
    if not natural["backlog skip"]:
        again("backlog skip", backlog=True)
    if not natural["stage-conflict rerun"]:
        # the triangulation and fuse searches each edit the map's
        # observations once after they ran, as a keyframe the tracker
        # inserts meanwhile would
        searches = [(local_mapping, "triangulate_neighbors"), (kernels, "fuse_targets")]
        kept = [getattr(mod, name) for mod, name in searches]

        def search_then_edit(search):
            def run(*a, **k):
                out = search(*a, **k)
                with tracker.map_lock:
                    m.touch_obs()
                return out
            return run

        for (mod, name), search in zip(searches, kept):
            setattr(mod, name, search_then_edit(search))
        try:
            again("stage-conflict rerun")
        finally:
            for (mod, name), search in zip(searches, kept):
                setattr(mod, name, search)
    counts = {path: mapper.counts[key] for path, key in BACKLOG_PATHS.items()}
    system.shutdown()
    print(f"  frames tracked {d['tracked']}/{len(frames)}, keyframes created "
          f"{int(m._kf_counter)}, worker queue up to {queue_max[0]}, ATE-RMSE {ate:.4f} m, "
          f"{d['ms_per_frame']:.2f} ms per steady-state frame; kernel launches "
          f"{d['launches']}; local BAs applied {mapper.counts['ba_applied']}, skipped "
          f"{mapper.counts['ba_skipped']}", flush=True)
    print("  mapping paths (count after the drive -> after provoking): " + ", ".join(
        f"{p} {natural[p]} -> {counts[p]}" for p in BACKLOG_PATHS) + "; came about by "
        f"themselves: {[p for p in BACKLOG_PATHS if natural[p]]}, provoked: {provoked}",
          flush=True)
    missing = [p for p, n in counts.items() if n < 1]
    if missing:
        fail(f"backlog: the mapping paths {missing} never ran")
    return dict(launches=d["launches"], tracked=d["tracked"], ate_m=ate,
                queue_max=queue_max[0], natural=natural, counts=counts, provoked=provoked,
                ms_per_frame=d["ms_per_frame"])


# ---- phase 17: monocular ---------------------------------------------------
N_FRAMES_MONO = 60        # tests/test_e2e_mono.py's drive at full width (17a)
MONO_INIT_BEFORE = 15     # the map initializes before this frame
MONO_LOST_MAX = 2         # frames lost after initialization
MONO_MIN_KEYFRAMES = 3
MONO_MIN_POINTS = 150
MONO_ATE_MAX_M = 0.06     # Sim3-aligned: a monocular map has its own scale
# 17b: the two-view solve on the card against the CPU, with the same sets;
# eigh and SVD run in another order of work on each, and a point at the edge
# of the reprojection gate may fall either way. On the H100 the two agree to
# 1.2e-6 rad in rotation and 4.7e-5 rad in direction, with the good masks
# identical (PERF.md, PR 7): the rotation limit is tightened from 1e-4
INIT_ROT_TOL_RAD = 1e-5
INIT_DIR_TOL_RAD = 1e-4
INIT_GOOD_DIFF_MAX = 0.005
INIT_TIMED_SOLVES = 5
# 17c: tests/test_mono_extra.py::test_circuit_loop_fix_scale_false at full width
N_FRAMES_MONO_LOOP = 200
MONO_LOOP_ATE_MAX_M = 0.30
# 17d: test_kidnapped_mono's limits, against the map's own estimate
MONO_RELOC_ROT_MAX = 0.1
MONO_RELOC_T_MAX = 0.15


def geometry(cam, orb_cfg) -> str:
    return (f"{cam.width}x{cam.height} / {orb_cfg.n_features} features / "
            f"{orb_cfg.n_levels} levels")


class InitCapture:
    """Keeps the arguments and the result of every two-view solve the
    tracker makes (through the module attribute it calls) while open."""

    def __enter__(self):
        self.solve = tracking_mod.initializer.initialize_two_view
        self.calls = []

        def capture(*args):
            res = self.solve(*args)
            self.calls.append((args, res))
            return res

        tracking_mod.initializer.initialize_two_view = capture
        return self

    def __exit__(self, *exc):
        tracking_mod.initializer.initialize_two_view = self.solve


def seg_scale_error(est_twc: np.ndarray, gt_twc: np.ndarray) -> float:
    """tests/test_mono_extra.py's scale error: the median |log| of the
    per-step translation ratio (estimate over truth), normalised by its early
    median (a monocular map's scale is its own)."""
    e = np.diff(est_twc[:, :3, 3], axis=0)
    g = np.diff(gt_twc[:, :3, 3], axis=0)
    en, gn = np.linalg.norm(e, axis=1), np.linalg.norm(g, axis=1)
    keep = (gn > 1e-4) & (en > 1e-9)
    r = en[keep] / gn[keep]
    r = r / np.median(r[: max(5, len(r) // 10)])
    return float(np.median(np.abs(np.log(r))))


def mono_drive(name, system, seq, n_frames, after=None) -> dict:
    """SLAMSystem.track_monocular over the first `n_frames` of `seq`, each
    rendered on the host just before it (outside its time), back to back or
    with `after(i)` run after frame i (outside its time). The kernel's launch
    count is set to 0 just before and read just after; each frame must
    launch it once, and once more for each frame built again or tracked
    again. Keyframes are mapped inline on the tracker's thread: their time
    is read around the worker's insert_keyframe. -> the drive's entries."""
    tracker, worker = system.tracker, system.mapping_worker
    insert, kf_ms = worker.insert_keyframe, []

    def timed_insert(*a, **k):
        t0 = time.perf_counter()
        out = insert(*a, **k)
        kf_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    worker.insert_keyframe = timed_insert
    cuda_orb.fused_orient_describe.launches = 0
    frame_ms = []
    try:
        for i in range(n_frames):
            gray = seq.render(i)[0]
            before = cuda_orb.fused_orient_describe.launches
            again = tracker.rebuilt_frames + tracker.retracked_frames
            t0 = time.perf_counter()
            system.track_monocular(gray, i / seq.fps)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            built = cuda_orb.fused_orient_describe.launches - before
            expected = 1 + tracker.rebuilt_frames + tracker.retracked_frames - again
            if built != expected:
                fail(f"{name}: frame {i}: {built} kernel launches, expected {expected}")
            if after is not None:
                after(i)
        before = cuda_orb.fused_orient_describe.launches
        again = tracker.rebuilt_frames + tracker.retracked_frames
        lost = tracker.trajectory_lost_mask()          # applies the frames in flight
        if (cuda_orb.fused_orient_describe.launches - before
                != tracker.rebuilt_frames + tracker.retracked_frames - again):
            fail(f"{name}: the flush launched the kernel an unexpected number of times")
    finally:
        worker.insert_keyframe = insert
    torch.cuda.synchronize()
    launches = cuda_orb.fused_orient_describe.launches
    if len(lost) != n_frames:
        fail(f"{name}: {len(lost)} trajectory entries for {n_frames} frames")
    if launches != n_frames + tracker.rebuilt_frames + tracker.retracked_frames:
        fail(f"{name}: {launches} kernel launches, expected {n_frames} frame builds + "
             f"{tracker.retracked_frames} dispatched again + {tracker.rebuilt_frames} rebuilt")
    ok_at = np.flatnonzero(~lost)
    if not len(ok_at):
        fail(f"{name}: the map never initialized")
    first = int(ok_at[0])
    steady = np.array(frame_ms[first + 1:])
    return dict(launches=launches, first_ok=first, tracked=int(len(ok_at)),
                lost_after_init=(np.flatnonzero(lost[first:]) + first).tolist(),
                redispatched=tracker.retracked_frames, rebuilt=tracker.rebuilt_frames,
                remapped_ids=tracker.remapped_ids, reused_slot_ids=tracker.reused_slot_ids,
                replacements_lost=tracker.replacements_lost,
                revalidated_frames=tracker.revalidated_frames,
                keyframes=int(system.map.n_keyframes()), points=int(system.map.n_points()),
                median_ms=float(np.median(steady)), p95_ms=float(np.percentile(steady, 95)),
                inline_mapping_ms=kf_ms, lost=lost)


def describe_two_view(calls) -> dict:
    """The drive's two-view solves: the successful one's frame, model and
    good points."""
    ok = [res for _, res in calls if bool(res.success)]
    if not ok:
        fail("mono: no two-view solve succeeded")
    res = ok[-1]
    return dict(solves=len(calls), model="H" if bool(res.used_homography) else "F",
                n_good=int(res.n_good))


def drive_mono(cam, orb_cfg):
    """Phase 17a: tests/test_e2e_mono.py's drive at full width through
    SLAMSystem.track_monocular: the default configuration (the pipelined
    fetch, fetch_batch 1, the worker with each keyframe mapped inline), no
    vocabulary, 60 frames of the lateral sequence back to back. The stage
    timer is switched on (it times, it configures nothing). -> (entries, the
    last successful two-view problem, the system, still running, and the
    sequence: phase 17e goes on from them)."""
    cfg = SLAMConfig(cam=cam, orb=orb_cfg, max_keyframes=64, max_points=16384,
                     local_point_cap=4096, max_frames_between_kf=10, profile_stages=True)
    print(f"[mono] SLAMSystem.track_monocular with SLAMConfig's defaults (pipelined_fetch, "
          f"mapping inline at keyframe insertion), {N_FRAMES_MONO} frames of the lateral "
          f"sequence back to back, {geometry(cam, orb_cfg)}", flush=True)
    system = SLAMSystem(cfg, Sensor.MONOCULAR)
    if not system.mapping_worker.sync_mapping or not system.local_mapper.cfg.monocular:
        fail("mono: the worker does not map inline or the mapper is not monocular")
    tracker = system.tracker
    seq = SyntheticSequence(cam, n_frames=N_FRAMES_MONO, trajectory="lateral", seed=5)
    with InitCapture() as inits:
        d = mono_drive("mono", system, seq, N_FRAMES_MONO)
    init = describe_two_view(inits.calls)
    lost = d.pop("lost")
    first = d["first_ok"]
    est = tracker.full_trajectory_twc()
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    if not np.isfinite(est).all():
        fail("mono: the trajectory is not finite")
    ate = ate_rmse(est[first:], gt[first:], with_scale=True)
    kf_ms = d.pop("inline_mapping_ms")
    print(f"  initialized at frame {first} by {init['model']} ({init['solves']} two-view "
          f"solves, {init['n_good']} good points); frames tracked {d['tracked']}/"
          f"{N_FRAMES_MONO}, lost after initialization {d['lost_after_init']}; keyframes "
          f"{d['keyframes']}, map points {d['points']}; ATE-RMSE {ate:.4f} m after Sim3 "
          f"alignment; ms per frame after initialization median {d['median_ms']:.2f}, p95 "
          f"{d['p95_ms']:.2f}; inline mapping on the tracker's thread {len(kf_ms)} keyframes, "
          f"median {np.median(kf_ms) if kf_ms else float('nan'):.1f} ms; frames dispatched "
          f"again {d['redispatched']}, rebuilt {d['rebuilt']}; {remapped(d)}; kernel launches "
          f"{d['launches']}", flush=True)
    print(tracker.stats.report(), flush=True)
    print("  mapper stages (per keyframe, inline on the tracker's thread):", flush=True)
    print(system.local_mapper.stats.report(), flush=True)
    if first >= MONO_INIT_BEFORE:
        fail(f"mono: initialized at frame {first}, not before {MONO_INIT_BEFORE}")
    if len(d["lost_after_init"]) > MONO_LOST_MAX:
        fail(f"mono: frames {d['lost_after_init']} lost after initialization")
    if d["keyframes"] < MONO_MIN_KEYFRAMES or d["points"] <= MONO_MIN_POINTS:
        fail(f"mono: {d['keyframes']} keyframes and {d['points']} points")
    if not ate < MONO_ATE_MAX_M:
        fail(f"mono: ATE {ate:.4f} m, limit {MONO_ATE_MAX_M}")
    ok = [args for args, res in inits.calls if bool(res.success)]
    return dict(d, ate_sim3_m=ate, init=init, inline_mapping_ms_median=float(np.median(kf_ms))
                if kf_ms else None, inline_mapping_keyframes=len(kf_ms)), ok[-1], system, seq


def check_two_view_card_vs_cpu(args) -> dict:
    """Phase 17b: 17a's successful two-view problem solved again on the card
    and on the CPU with the same sample sets."""
    if not args[0].is_cuda:
        fail("two-view: the drive solved its two-view problem off the card")
    solve = tracking_mod.initializer.initialize_two_view
    out = {}
    for dev, sync in ((CARD, torch.cuda.synchronize), ("cpu", lambda: None)):
        a = [x.to(dev) for x in args]
        res = solve(*a)
        times = [_timed(lambda: solve(*a), sync)[1] for _ in range(INIT_TIMED_SOLVES)]
        out[dev] = (res, float(np.median(times)))
    rc, rh = out[CARD][0], out["cpu"][0]
    act = device_activity(lambda: solve(*args))
    same = (bool(rc.success) == bool(rh.success)
            and bool(rc.used_homography) == bool(rh.used_homography))
    rot = float(rotation_angle(rc.r21.cpu().numpy() @ rh.r21.numpy().T))
    tc, th = rc.t21.cpu().numpy().astype(np.float64), rh.t21.numpy().astype(np.float64)
    direction = float(np.arccos(np.clip(tc @ th / np.linalg.norm(tc) / np.linalg.norm(th),
                                        -1.0, 1.0)))
    good = float((rc.good.cpu().numpy() != rh.good.numpy()).mean())
    print(f"[two-view] {int(args[2].sum())} pairs, {args[4].shape[0]} sample sets: card and "
          f"CPU {'agree' if same else 'DIFFER'} on success and model "
          f"({'H' if bool(rh.used_homography) else 'F'}); rotation {rot:.3e} rad (limit "
          f"{INIT_ROT_TOL_RAD}), translation direction {direction:.3e} rad (limit "
          f"{INIT_DIR_TOL_RAD}), good masks differ on {good:.4%} of the pairs (limit "
          f"{INIT_GOOD_DIFF_MAX:.1%}), good points {int(rc.n_good)} / {int(rh.n_good)}; one "
          f"solve: card {out[CARD][1]:.1f} ms, CPU {out['cpu'][1]:.1f} ms (host clock around "
          f"a synchronised call, median of {INIT_TIMED_SOLVES}); on the card under "
          f"torch.profiler {act[0]} kernel launches, {act[1]} device operations, busy "
          f"{act[2]:.2f} ms of {act[3]:.1f} ms", flush=True)
    if not same:
        fail("two-view: card and CPU disagree on success or model")
    if not (rot < INIT_ROT_TOL_RAD and direction < INIT_DIR_TOL_RAD
            and good <= INIT_GOOD_DIFF_MAX):
        fail("two-view: card and CPU motions or good masks differ beyond the limits")
    return dict(pairs=int(args[2].sum()), model="H" if bool(rh.used_homography) else "F",
                rotation_diff_rad=rot, direction_diff_rad=direction, good_diff_share=good,
                n_good_card=int(rc.n_good), n_good_cpu=int(rh.n_good),
                card_ms=out[CARD][1], cpu_ms=out["cpu"][1], card_launches=act[0],
                card_device_ops=act[1], card_busy_ms=act[2], card_profiled_wall_ms=act[3])


def drive_mono_loop(cam, orb_cfg, voc):
    """Phase 17c: tests/test_mono_extra.py::test_circuit_loop_fix_scale_false
    at full width: circuit3 (a full turn and 135 degrees) in the room world,
    seed 9, exposure swing 0.35, 200 frames, the 10 000-word vocabulary, loop
    consistency 2, no keyframe culling (kf_cull_redundancy 2.0), the worker
    waited for after each frame as the test waits. The loop closer solves
    with scale (fix_scale False): Sim3 RANSAC, optimize_sim3 and the
    essential graph with scale. -> (entries, the system, the drive's
    trajectory)."""
    cfg = SLAMConfig(cam=cam, orb=orb_cfg, max_keyframes=96, max_points=16384,
                     local_point_cap=4096, max_frames_between_kf=8, profile_stages=True)
    system = SLAMSystem(cfg, Sensor.MONOCULAR, vocabulary=voc)
    closer = system.loop_closer
    closer.cfg.consistency_threshold = 2
    system.local_mapper.cfg.kf_cull_redundancy = 2.0
    print(f"[mono loop] SLAMSystem.track_monocular with the {voc.n_words}-word vocabulary, "
          f"{N_FRAMES_MONO_LOOP} frames of circuit3 (room, seed 9, exposure 0.35), the worker "
          f"waited for after each frame, {geometry(cam, orb_cfg)}; loop closer "
          f"fix_scale={closer.cfg.fix_scale}", flush=True)
    if closer.cfg.fix_scale:
        fail("mono loop: the loop closer of a monocular system fixes the scale")
    tracker = system.tracker
    seq = SyntheticSequence(cam, n_frames=N_FRAMES_MONO_LOOP, trajectory="circuit3", seed=9,
                            world="room", exposure=0.35)
    pre, loop_at = [None], [None]

    def after(i):
        if not system.wait_mapping_idle(timeout=60.0):
            fail(f"mono loop: the worker did not become idle after frame {i}")
        if closer.n_loops_closed == 0 and i % 10 == 9:
            pre[0] = tracker.full_trajectory_twc(wait=False)
        if closer.n_loops_closed and loop_at[0] is None:
            loop_at[0] = i

    d = mono_drive("mono loop", system, seq, N_FRAMES_MONO_LOOP, after)
    system.wait_mapping_idle(300)
    lost = d.pop("lost")
    kf_ms = d.pop("inline_mapping_ms")
    post = tracker.full_trajectory_twc()
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    loops = closer.n_loops_closed
    lost_after_loop = [f for f in d["lost_after_init"]
                       if loop_at[0] is not None and f > loop_at[0]]
    out = dict(d, loops=loops, fix_scale=bool(closer.cfg.fix_scale),
               loop_closed_by_frame=loop_at[0], lost_after_loop=lost_after_loop,
               inline_mapping_ms_median=float(np.median(kf_ms)) if kf_ms else None,
               loop_stage_median_ms={k: v["median_ms"]
                                     for k, v in closer.stats.summary().items()})
    if loops < 1 or pre[0] is None:
        fail(f"mono loop: {loops} loops closed at full width (the JAX package closes one on "
             "this drive on the CPU, tests/reference_full_width.py mono-loop)")
    n_pre = len(pre[0])
    if n_pre <= 40:
        fail(f"mono loop: the loop closed by frame {n_pre}, before the drift the test measures")
    keep_pre, keep = ~lost[:n_pre], ~lost
    pre_scale = seg_scale_error(pre[0][keep_pre], gt[:n_pre][keep_pre])
    win_scale = seg_scale_error(post[:n_pre][keep_pre], gt[:n_pre][keep_pre])
    full_scale = seg_scale_error(post[keep], gt[keep])
    ate = ate_rmse(post[keep], gt[keep], with_scale=True)
    out.update(pre_frames=n_pre, pre_scale=pre_scale, window_scale=win_scale,
               full_scale=full_scale, ate_sim3_m=ate)
    print(f"  initialized at frame {d['first_ok']}, frames tracked {d['tracked']}/"
          f"{N_FRAMES_MONO_LOOP}, keyframes {d['keyframes']}, points {d['points']}, loops "
          f"closed {loops}; scale error before the loop {pre_scale:.4f} (first {n_pre} "
          f"frames), after: that window {win_scale:.4f} (limit {1.5 * pre_scale + 1e-3:.4f}),"
          f" the whole drive {full_scale:.4f} (limit {pre_scale + 1e-3:.4f}); ATE-RMSE "
          f"{ate:.4f} m after Sim3 alignment (limit {MONO_LOOP_ATE_MAX_M}); ms per frame "
          f"median {d['median_ms']:.2f}, p95 {d['p95_ms']:.2f} (the worker's wait "
          f"excluded); inline mapping median {out['inline_mapping_ms_median']:.1f} ms over "
          f"{len(kf_ms)} keyframes; frames dispatched again {d['redispatched']}, rebuilt "
          f"{d['rebuilt']}; kernel launches {d['launches']}; the loop closed by frame "
          f"{loop_at[0]}, frames lost after it {lost_after_loop}, lost after initialization "
          f"{d['lost_after_init']}; {remapped(d)}; frames whose associations changed while "
          f"in flight {d['revalidated_frames']}", flush=True)
    print("  loop closer stages:", flush=True)
    print(closer.stats.report(), flush=True)
    mc = system.local_mapper.counts
    out["solve_programs"] = check_solve_programs_ran("mono loop", system, {
        "local_ba": mc["ba_applied"] + mc["ba_dropped"],
        "essential_graph": closer.n_loops_closed,
        "gba": closer.n_gba_applied + closer.n_gba_superseded})
    if not full_scale <= pre_scale + 1e-3:
        fail("mono loop: the whole trajectory's scale error grew over the loop")
    if not win_scale <= pre_scale * 1.5 + 1e-3:
        fail("mono loop: the pre-loop window's scale error grew beyond 1.5 times")
    if not ate < MONO_LOOP_ATE_MAX_M:
        fail(f"mono loop: ATE {ate:.4f} m")
    return out, system, seq


def check_mono_relocalization(system, seq, first_ok) -> dict:
    """Phase 17d: 17c's tracker, set LOST without a motion model, tracks a
    mapped frame again (test_kidnapped_mono's frame: two after the map
    initialized) through the keyframe database; held to the map's own
    estimate of that frame, which carries the map's scale."""
    tracker = system.tracker
    revisit = first_ok + 2
    expect = np.linalg.inv(tracker.full_trajectory_twc()[revisit])
    calls = []
    solve = tracking_mod.epnp.epnp_ransac

    def spy(*a, **k):
        res = solve(*a, **k)
        calls.append(int(res.n_inliers))
        return res

    tracker.state = TrackingState.LOST
    tracker.velocity = None
    gray = seq.render(revisit)[0]
    tracking_mod.epnp.epnp_ransac = spy
    cuda_orb.fused_orient_describe.launches = 0
    try:
        t0 = time.perf_counter()
        tcw = system.track_monocular(gray, 99.0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        tracking_mod.epnp.epnp_ransac = solve
    launches = cuda_orb.fused_orient_describe.launches
    if tcw is None or tracker.state != TrackingState.OK:
        fail("mono reloc: the tracker did not relocalize")
    r_err = float(np.linalg.norm(tcw[:3, :3] - expect[:3, :3]))
    t_err = float(np.linalg.norm(tcw[:3, 3] - expect[:3, 3]))
    print(f"[mono reloc] LOST tracker on frame {revisit}: relocalized with "
          f"{tracker.matches_inliers} inliers, rotation {r_err:.4f} (limit "
          f"{MONO_RELOC_ROT_MAX}) and translation {t_err:.4f} (limit {MONO_RELOC_T_MAX}, "
          f"map units) from the map's own estimate, EPnP RANSAC runs {len(calls)} "
          f"(inliers {calls}), {ms:.1f} ms for the frame, kernel launches {launches}",
          flush=True)
    if not calls:
        fail("mono reloc: relocalized without the keyframe database (no EPnP run)")
    if not (r_err < MONO_RELOC_ROT_MAX and t_err < MONO_RELOC_T_MAX):
        fail("mono reloc: too far from the map's estimate")
    if launches != 1:
        fail(f"mono reloc: {launches} kernel launches, expected 1")
    return dict(frame=revisit, rotation_err=r_err, translation_err=t_err,
                epnp_runs=len(calls), epnp_inliers=calls, inliers=tracker.matches_inliers,
                ms=ms, launches=launches)


# ---- phase 17e: replaced points in the last frame ---------------------------
# the frame after 17a's last tracked with half of that frame's points merged
# into duplicates, against the same frame without the merge: the same
# arithmetic on the same values, so the poses agree to float32 noise
REPLACED_POSE_TOL_M = 1e-5
# a tracker's collaborators, which copy_tracker's copy goes without, and what
# the copy shares with it
_TRACKER_COLLABORATORS = ("mapping_worker", "local_mapper", "loop_closer", "kfdb",
                          "vocabulary", "applied_pose_cb")
_TRACKER_SHARED = ("cfg", "cam", "device", "extractor", "stats")


def copy_tracker(tracker: Tracker) -> Tracker:
    """A copy of `tracker`, its frames in flight applied first: a deep copy of
    its map and per-frame state (the device carry and mirrors included), no
    mapper, worker, loop closer or keyframe database, and its settings,
    extractor and stage timer shared. A frame tracked on the copy leaves the
    tracker as it was."""
    tracker.flush_frames()
    out = copy.copy(tracker)
    memo = {}
    for name, value in vars(tracker).items():
        if name in _TRACKER_COLLABORATORS:
            setattr(out, name, None)
        elif name == "map_lock":
            out.map_lock = threading.RLock()
        elif name not in _TRACKER_SHARED:
            setattr(out, name, copy.deepcopy(value, memo))
    return out


def duplicate_half(tracker: Tracker, replace: bool):
    """A duplicate (add_point with the same position, descriptor, normal and
    scale band) of every other point the last frame tracked that is still in
    the map and, with `replace`, each replaced by its duplicate
    (replace_points) under the map lock. -> (old ids, duplicate ids, the last
    frame's slots holding an old id, its slots holding a live point)."""
    m, ids = tracker.map, tracker.last_frame.pt_ids
    live = np.flatnonzero((ids >= 0) & m.pt_valid[np.maximum(ids, 0)])
    old = np.unique(ids[live[::2]])
    with tracker.map_lock:
        dup = np.array([m.add_point(
            m.pt_pos[p].copy(), m.pt_desc[p].copy(), int(m.pt_ref_kf[p]),
            int(m.pt_first_frame[p]), normal=m.pt_normal[p].copy(),
            min_dist=float(m.pt_min_dist[p]), max_dist=float(m.pt_max_dist[p]))
            for p in old], np.int64)
        if replace:
            m.replace_points(list(zip(old.tolist(), dup.tolist())))
    return old, dup, np.flatnonzero(np.isin(ids, old)), len(live)


def track_watched(name, tracker: Tracker, track):
    """`track()` one frame on `tracker`'s fused path and apply it. -> (the
    fused apply's motion-model matches and inliers, final inliers and pose;
    the last frame's ids the fused step was given; the device carry right
    after the dispatch)."""
    got, staged = {}, {}
    apply_, step = tracker._fused_apply, tracking_mod.kernels.fused_frame_step

    def spy_apply(rec, fetched):
        got.update(mm_matches=int(fetched[4]), mm_inliers=int(fetched[5]),
                   inliers=int(fetched[6]), tcw=np.array(fetched[0], np.float64))
        return apply_(rec, fetched)

    def spy_step(*a, **kw):
        staged["last_pid"] = a[7].cpu().numpy()
        return step(*a, **kw)

    tracker._fused_apply = spy_apply
    tracking_mod.kernels.fused_frame_step = spy_step
    try:
        track()
        carry = tracker._last_pid_dev
        tracker.flush_frames()
    finally:
        vars(tracker).pop("_fused_apply")
        tracking_mod.kernels.fused_frame_step = step
    if not got or "last_pid" not in staged:
        fail(f"replaced: {name}: the frame did not take the fused path")
    return got, staged["last_pid"], carry


def next_view(seq, n_frames: int) -> np.ndarray:
    """The frame after the first `n_frames` of `seq`: one more step of the
    last frame's velocity, rendered in the same world. -> gray image."""
    view = copy.copy(seq)
    poses = seq.poses[:n_frames]
    tcw = poses[-1] @ np.linalg.inv(poses[-2]) @ poses[-1]
    view.poses = np.concatenate([poses, tcw[None]])
    return view.render(n_frames)[0]


def check_replaced_points(system, seq, n_frames: int) -> dict:
    """Phase 17e: after 17a's drive, the next frame with half of the points
    the last frame tracked merged into duplicates before it, through
    SLAMSystem.track_monocular, against that frame tracked on a copy of the
    tracker taken before the merge (the same duplicates added, not merged);
    then a merged point's slot handed out again before the frame, on another
    copy."""
    tracker = system.tracker
    if tracker.trajectory_lost_mask()[-1]:
        fail("replaced: 17a's last frame was lost")
    gray, ts = next_view(seq, n_frames), n_frames / seq.fps
    cuda_orb.fused_orient_describe.launches = 0
    plain = copy_tracker(tracker)
    duplicate_half(plain, replace=False)
    r0 = plain.remapped_ids
    c0, pid0, _ = track_watched("without the merge", plain, lambda: plain.track_mono(gray, ts))

    reuse = copy_tracker(tracker)
    m, ids = reuse.map, reuse.last_frame.pt_ids
    p = int(ids[(ids >= 0) & m.pt_valid[np.maximum(ids, 0)]][0])
    with reuse.map_lock:
        d = m.add_point(m.pt_pos[p].copy(), m.pt_desc[p].copy(), int(m.pt_ref_kf[p]), 0)
        m.replace_points([(p, d)])
        q = m.add_point(m.pt_pos[p] + 1.0, ~m.pt_desc[p], int(m.pt_ref_kf[p]), 0)
    slots_p = np.flatnonzero(ids == p)
    # the ids the lookup finds through the slot's previous life: the last
    # frame's positions and the local selection's entries holding p
    in_sel = 0 if reuse._local_pts is None else int((reuse._local_pts == p).sum())
    u0, l0 = reuse.reused_slot_ids, reuse.replacements_lost
    _, pid_r, _ = track_watched("slot handed out again", reuse,
                                lambda: reuse.track_mono(gray, ts))
    reused, lost = reuse.reused_slot_ids - u0, reuse.replacements_lost - l0

    had_carry = tracker._last_pid_dev is not None
    r1 = tracker.remapped_ids
    old, dup, slots, n_live = duplicate_half(tracker, replace=True)
    c1, pid1, carry1 = track_watched("merged", tracker,
                                     lambda: system.track_monocular(gray, ts))
    torch.cuda.synchronize()
    launches = cuda_orb.fused_orient_describe.launches
    remapped = (tracker.remapped_ids - r1) - (plain.remapped_ids - r0)
    remap = dict(zip(old.tolist(), dup.tolist()))
    read_remapped = bool((pid1 == np.array([remap.get(int(x), int(x)) for x in pid0])).all())
    centre = [-t[:3, :3].T @ t[:3, 3] for t in (c0["tcw"], c1["tcw"])]
    pose_m = float(np.linalg.norm(centre[0] - centre[1]))
    same = all(c0[k] == c1[k] for k in ("mm_matches", "mm_inliers", "inliers"))
    print(f"[replaced] frame {n_frames} after 17a's drive ({geometry(system.cfg.cam, system.cfg.orb)}"
          f"): {len(old)} of the last frame's {n_live} live points merged into duplicates "
          f"({len(slots)} slots); motion-model matches {c1['mm_matches']} / inliers "
          f"{c1['mm_inliers']}, final inliers {c1['inliers']} against {c0['mm_matches']} / "
          f"{c0['mm_inliers']} / {c0['inliers']} without the merge; camera centres "
          f"{pose_m:.2e} m apart (limit {REPLACED_POSE_TOL_M}); ids remapped {remapped} "
          f"(expected {len(slots)}); device carry {'held' if had_carry else 'absent'} "
          f"before, {'dropped' if carry1 is None else 'KEPT'} at the dispatch, the step "
          f"given the remapped ids: {read_remapped}; a merged point's slot {p} handed out "
          f"again ({'the same slot' if q == p else f'slot {q}'}): its {len(slots_p)} "
          f"last-frame slot(s) staged as {pid_r[slots_p].tolist()} (its replacement {d}), "
          f"ids resolved through the slot's previous life {reused} (expected {len(slots_p)} "
          f"in the last frame + {in_sel} in the local selection), lost {lost}; kernel launches "
          f"{launches} for 3 frames", flush=True)
    if not same:
        fail("replaced: the merged run's matches or inliers differ from the run without it")
    if not pose_m <= REPLACED_POSE_TOL_M:
        fail(f"replaced: the poses are {pose_m:.2e} m apart")
    if remapped != len(slots) or not 2 * len(slots) >= n_live:
        fail(f"replaced: {remapped} ids remapped, expected {len(slots)} (half of {n_live})")
    if carry1 is not None or not read_remapped:
        fail("replaced: the fused step did not read the remapped ids from the host")
    if q != p or not len(slots_p) or not (pid_r[slots_p] == d).all():
        fail("replaced: a merged point whose slot was handed out again was not given to the "
             "step as its replacement")
    if reused != len(slots_p) + in_sel or lost:
        fail(f"replaced: {reused} ids resolved through a reused slot (expected "
             f"{len(slots_p) + in_sel}), {lost} lost")
    if launches != 3:
        fail(f"replaced: {launches} kernel launches for 3 frames")
    return dict(frame=n_frames, live_points=n_live, merged=len(old), slots=len(slots),
                remapped_ids=remapped, pose_diff_m=pose_m, merged_run=c1 | {"tcw": None},
                plain_run=c0 | {"tcw": None}, carry_dropped=carry1 is None,
                had_carry=had_carry, reused_slot_staged=pid_r[slots_p].tolist(),
                reused_slot_replacement=d, reused_slot_ids=reused, replacements_lost=lost,
                launches=launches)


# ---- phase 18: the dataset drivers ------------------------------------------
# every sequence is written by the port's own writer into a temporary
# directory and read back by the drivers, in process, with --device cuda
TUM_DRIVER_ATE_MAX_M = ATE_MAX_M       # phase 5's limit
N_FRAMES_KITTI_DRIVER = 100            # the first frames of phase 12's drive
EUROC_SHAPE = (480, 752)
N_FRAMES_EUROC = 40
EUROC_INIT_BY = 20
# EuRoC's own settings (Examples/Stereo/EuRoC.yaml): the rectified camera
EUROC_CAM = dict(fx=435.2046959714599, fy=435.2046959714599, cx=367.4517211914062,
                 cy=252.2008514404297, width=752, height=480, bf=47.90639384423901)
RECTIFY_TIMED_PAIRS = 20


def _settings_lines(cam, orb_cfg, fps, th_depth_units, extra=()) -> list:
    """A reference-format settings file (Examples/RGB-D/TUM1.yaml's layout)."""
    return ["%YAML:1.0", "", "# Camera calibration and distortion parameters (OpenCV)",
            f"Camera.fx: {cam.fx!r}", f"Camera.fy: {cam.fy!r}", f"Camera.cx: {cam.cx!r}",
            f"Camera.cy: {cam.cy!r}", "", "Camera.k1: 0.0", "Camera.k2: 0.0",
            "Camera.p1: 0.0", "Camera.p2: 0.0", "",
            f"Camera.width: {cam.width}", f"Camera.height: {cam.height}", "",
            "# Camera frames per second", f"Camera.fps: {fps!r}", "",
            "# IR projector baseline times fx (aprox.)", f"Camera.bf: {cam.bf!r}", "",
            "# Color order of the images (0: BGR, 1: RGB)", "Camera.RGB: 1", "",
            "# Close/Far threshold. Baseline times.", f"ThDepth: {th_depth_units!r}", "",
            f"ORBextractor.nFeatures: {orb_cfg.n_features}",
            f"ORBextractor.scaleFactor: {orb_cfg.scale_factor!r}",
            f"ORBextractor.nLevels: {orb_cfg.n_levels}",
            f"ORBextractor.iniThFAST: {int(orb_cfg.ini_th_fast)}",
            f"ORBextractor.minThFAST: {int(orb_cfg.min_th_fast)}", *extra]


def write_settings(path, lines) -> str:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def opencv_matrix(name, m) -> list:
    m = np.asarray(m, np.float64)
    data = ", ".join(f"{x:.17g}" for x in m.reshape(-1))
    return [f"{name}: !!opencv-matrix", f"   rows: {m.shape[0]}", f"   cols: {m.shape[1]}",
            "   dt: d", f"   data: [{data}]"]


def euroc_rectification(left, right, shape) -> list:
    """The LEFT./RIGHT. keys of Examples/Stereo/EuRoC.yaml: (K, D, R, P) a side."""
    out = []
    for side, (k, d, r, p) in (("LEFT", left), ("RIGHT", right)):
        out += [f"{side}.height: {shape[0]}", f"{side}.width: {shape[1]}",
                *opencv_matrix(f"{side}.D", np.reshape(d, (1, -1))),
                *opencv_matrix(f"{side}.K", k), *opencv_matrix(f"{side}.R", r),
                *opencv_matrix(f"{side}.P", p)]
    return out


def run_driver(name, module, argv, n_frames) -> tuple:
    """One example main's main(argv) in process, the kernel's launch count set to 0
    just before and read just after: one launch per frame build, and one
    for each frame built again or dispatched again. -> (system, the --eval
    result, entries)."""
    print(f"  python -m {module.__name__} {' '.join(os.path.basename(a) for a in argv)}",
          flush=True)
    cuda_orb.fused_orient_describe.launches = 0
    t0 = time.perf_counter()
    system, evaluation = module.main(argv)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = cuda_orb.fused_orient_describe.launches
    tracker = system.tracker
    card = torch.device(CARD).type
    if system.device.type != card or tracker.extractor.device.type != card:
        fail(f"{name}: the system {module.__name__} built is not on the card")
    lost = tracker.trajectory_lost_mask()
    if len(lost) != n_frames:
        fail(f"{name}: {len(lost)} trajectory entries for {n_frames} frames")
    if launches != n_frames + tracker.rebuilt_frames + tracker.retracked_frames:
        fail(f"{name}: {launches} kernel launches, expected {n_frames} frame builds + "
             f"{tracker.retracked_frames} dispatched again + {tracker.rebuilt_frames} rebuilt")
    ok_at = np.flatnonzero(~lost)
    if not len(ok_at):
        fail(f"{name}: no frame was tracked")
    first = int(ok_at[0])
    if evaluation is None:
        fail(f"{name}: the driver printed no evaluation")
    return system, evaluation, dict(
        launches=launches, first_ok=first, tracked=int(len(ok_at)),
        lost_after_init=(np.flatnonzero(lost[first:]) + first).tolist(),
        redispatched=tracker.retracked_frames, rebuilt=tracker.rebuilt_frames,
        keyframes=int(system.map.n_keyframes()), points=int(system.map.n_points()),
        seconds=seconds, ms_per_frame=seconds / n_frames * 1e3, eval=evaluation)


def outputs(tmp, name) -> list:
    return ["--trajectory-out", os.path.join(tmp, f"{name}_trajectory.txt"),
            "--kf-trajectory-out", os.path.join(tmp, f"{name}_keyframes.txt")]


class Rendered:
    """A sequence whose frames were rendered already, for
    datasets.export_synthetic_tum (which reads n_frames, fps, poses and
    render(i))."""

    def __init__(self, seq, frames):
        self.n_frames, self.fps, self.poses = len(frames), seq.fps, seq.poses
        self._frames = frames

    def render(self, i):
        return self._frames[i]


def drive_driver_tum(cam, orb_cfg, seq, frames, tmp, ate_defaults) -> dict:
    """18a: phase 5's 60 frames written as a TUM RGB-D sequence and run
    through rgbd_tum with the default configuration and vocabulary."""
    seq = Rendered(seq, frames)
    root = os.path.join(tmp, "tum")
    t0 = time.perf_counter()
    assoc = datasets.export_synthetic_tum(seq, root)
    write_s = time.perf_counter() - t0
    # ThDepth 78 at bf 40 and fx 520: phase 5's th_depth of 6 m
    settings = write_settings(os.path.join(tmp, "TUM_synthetic.yaml"), _settings_lines(
        cam, orb_cfg, 30.0, 78.0, ["", "DepthMapFactor: 5000.0", "",
                                   "Map.MaxKeyFrames: 64", "Map.MaxPoints: 16384"]))
    print(f"[driver tum] rgbd_tum on phase 5's {seq.n_frames} frames written as TUM RGB-D PNGs "
          f"in {write_s:.1f} s ({geometry(cam, orb_cfg)}, DepthMapFactor 5000, the largest "
          f"shipped vocabulary)", flush=True)
    argv = [settings, root, assoc, "--device", CARD, "--eval",
            os.path.join(root, "groundtruth.txt")]
    system, ev, d = run_driver("driver tum", rgbd_tum, [*argv, *outputs(tmp, "tum")],
                               seq.n_frames)
    print(f"  frames tracked {d['tracked']}/{seq.n_frames} from frame {d['first_ok']}, lost after "
          f"{d['lost_after_init']}; keyframes {d['keyframes']}, points {d['points']}; ATE-RMSE "
          f"{ev['ate_rmse_m']:.4f} m (phase 14, the same drive from rendered frames: "
          f"{ate_defaults:.4f} m), RPE {ev['rpe_trans_m']:.4f} m; {d['ms_per_frame']:.2f} ms a "
          f"frame with PNG decoding; kernel launches {d['launches']} ({d['redispatched']} "
          f"dispatched again, {d['rebuilt']} rebuilt)", flush=True)
    if d["lost_after_init"]:
        fail(f"driver tum: frames {d['lost_after_init']} lost after initialisation")
    if not ev["ate_rmse_m"] <= TUM_DRIVER_ATE_MAX_M:
        fail(f"driver tum: ATE {ev['ate_rmse_m']} m, limit {TUM_DRIVER_ATE_MAX_M}")
    if system.vocabulary is None or system.vocabulary.n_words != 10000:
        fail("driver tum: the driver did not load the 10 000-word vocabulary")
    return dict(d, write_s=write_s, ate_phase14_m=ate_defaults), argv


def drive_driver_kitti(seq, frames, tmp) -> dict:
    """18b: the first 100 frames of phase 12's drive written as a KITTI
    odometry sequence (image_0/, image_1/, times.txt, poses.txt) and run
    through stereo_kitti with its capacity hint."""
    root = os.path.join(tmp, "kitti", "00")
    os.makedirs(os.path.join(root, "image_0"))
    os.makedirs(os.path.join(root, "image_1"))
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(frames[:N_FRAMES_KITTI_DRIVER]):
        for sub, img in (("image_0", left), ("image_1", right)):
            png.imwrite(os.path.join(root, sub, f"{i:06d}.png"),
                        np.clip(np.round(img), 0, 255).astype(np.uint8))
    np.savetxt(os.path.join(root, "times.txt"),
               np.arange(N_FRAMES_KITTI_DRIVER) / seq.fps, fmt="%.6e")
    np.savetxt(os.path.join(root, "poses.txt"), np.stack(
        [np.linalg.inv(seq.poses[i])[:3, :4].reshape(-1)
         for i in range(N_FRAMES_KITTI_DRIVER)]), fmt="%.9e")
    write_s = time.perf_counter() - t0
    cam = PinholeCamera(**KITTI_CAM)
    settings = write_settings(os.path.join(tmp, "KITTI_synthetic.yaml"), _settings_lines(
        cam, orb.ORBConfig(**KITTI_ORB), 10.0, 40.0))
    print(f"[driver kitti] stereo_kitti on the first {N_FRAMES_KITTI_DRIVER} frames of phase "
          f"12's drive written as KITTI PNGs in {write_s:.1f} s (1241x376, bf 386.1448, "
          f"ThDepth 40, 2000 features, 8 levels, capacity hint 2048 keyframes x 200 000 "
          f"points)", flush=True)
    system, ev, d = run_driver("driver kitti", stereo_kitti, [
        settings, root, "--device", CARD, "--eval", os.path.join(root, "poses.txt"),
        "--kitti-trajectory-out", os.path.join(tmp, "kitti_trajectory_kitti.txt"),
        *outputs(tmp, "kitti")], N_FRAMES_KITTI_DRIVER)
    cap = system.map.cap
    print(f"  frames tracked {d['tracked']}/{N_FRAMES_KITTI_DRIVER} from frame "
          f"{d['first_ok']}, lost after {d['lost_after_init']}; keyframes {d['keyframes']}, "
          f"points {d['points']} of {cap.max_points}; ATE-RMSE {ev['ate_rmse_m']:.4f} m "
          f"(index association, {ev['n_associated']} frames); {d['ms_per_frame']:.2f} ms a "
          f"frame with PNG decoding; kernel launches {d['launches']}", flush=True)
    if d["first_ok"] >= STEREO_INIT_BY:
        fail(f"driver kitti: tracking started at frame {d['first_ok']}")
    if d["lost_after_init"]:
        fail(f"driver kitti: frames {d['lost_after_init']} lost after initialisation")
    if not ev["ate_rmse_m"] < STEREO_ATE_MAX_M:
        fail(f"driver kitti: ATE {ev['ate_rmse_m']} m, limit {STEREO_ATE_MAX_M}")
    if cap.max_points != 200_000 or cap.max_keyframes != 2048:
        fail(f"driver kitti: capacity {cap.max_keyframes} x {cap.max_points}, not the hint")
    return dict(d, write_s=write_s)


def check_rectifier(tmp) -> dict:
    """18c, first part: the EuRoC rectifier at 752x480 with a distorted and
    rotated calibration shaped like Examples/Stereo/EuRoC.yaml's: its images
    on the card against the CPU, and its milliseconds per pair on the card.
    Its maps are held against cv2.initUndistortRectifyMap and the closed form
    at this calibration by tests/test_torch_io.py."""
    k_l = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    k_r = np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1]])
    p = np.array([[435.2046, 0, 367.4517, 0], [0, 435.2046, 252.2004, 0], [0, 0, 1, 0]])
    left = (k_l, np.array([-0.2834, 0.0739, 0.00019, 1.76e-5]),
            Rotation.from_rotvec([0.003, -0.002, 0.001]).as_matrix(), p)
    right = (k_r, np.array([-0.2836, 0.0745, -0.00011, -5.7e-5]),
             Rotation.from_rotvec([-0.002, 0.0025, -0.0008]).as_matrix(), p)
    cam = PinholeCamera(**EUROC_CAM)
    path = write_settings(os.path.join(tmp, "EuRoC_distorted.yaml"), _settings_lines(
        cam, orb.ORBConfig(n_features=1200, n_levels=8), 20.0, 35.0,
        euroc_rectification(left, right, EUROC_SHAPE)))
    t0 = time.perf_counter()
    rect = datasets.EurocRectifier(path, device=CARD)
    maps_s = time.perf_counter() - t0
    rect_cpu = datasets.EurocRectifier(path, device="cpu")
    rng = np.random.default_rng(18)
    raw = [np.clip(rng.normal(128, 60, EUROC_SHAPE), 0, 255).astype(np.uint8)
           for _ in range(2)]
    card, cpu = rect(*raw), rect_cpu(*raw)
    differ = int(sum((a != b).sum() for a, b in zip(card, cpu)))
    outside = int(sum((a == 0).sum() for a in card))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RECTIFY_TIMED_PAIRS):
        rect(*raw)                       # numpy in, numpy out: ends in a fetch
    ms_pair = (time.perf_counter() - t0) / RECTIFY_TIMED_PAIRS * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        rect_cpu(*raw)
    ms_pair_cpu = (time.perf_counter() - t0) / 3 * 1e3
    print(f"[driver euroc] EurocRectifier at 752x480, distorted and rotated calibration: "
          f"maps built in {maps_s * 1e3:.1f} ms on the host; card vs CPU images: "
          f"{differ} pixels differ ({outside} outside the source, 0); {ms_pair:.3f} ms a "
          f"pair on the card (host to card and back included), {ms_pair_cpu:.3f} ms on the "
          f"host's CPU", flush=True)
    if differ:
        fail(f"driver euroc: {differ} rectified pixels differ between card and CPU")
    return dict(card_cpu_pixels_differ=differ, ms_per_pair=ms_pair,
                ms_per_pair_cpu=ms_pair_cpu, maps_ms=maps_s * 1e3)


def drive_driver_euroc(tmp) -> dict:
    """18c, second part: a 752x480 stereo sequence of 40 frames written in
    EuRoC's layout (mav0/cam0/data, mav0/cam1/data, a timestamps list) with
    an identity rectification in EuRoC's YAML, through stereo_euroc."""
    cam = PinholeCamera(**EUROC_CAM)
    seq = SyntheticSequence(cam, n_frames=N_FRAMES_EUROC, trajectory="lateral", seed=6,
                            world="cluttered")
    root = os.path.join(tmp, "euroc", "mav0")
    lines = ["#timestamp [ns]"]
    t0_ns = 1403636579763555584
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(render_stereo_frames(seq, N_FRAMES_EUROC)):
        ts = t0_ns + int(round(i / seq.fps * 1e9))
        for sub, img in (("cam0", left), ("cam1", right)):
            os.makedirs(os.path.join(root, sub, "data"), exist_ok=True)
            png.imwrite(os.path.join(root, sub, "data", f"{ts}.png"),
                        np.clip(np.round(img), 0, 255).astype(np.uint8))
        lines.append(f"{ts}")
    ts_path = os.path.join(tmp, "euroc", "timestamps.txt")
    with open(ts_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    write_s = time.perf_counter() - t0
    k = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    ident = (k, np.zeros(5), np.eye(3), np.hstack([k, np.zeros((3, 1))]))
    settings = write_settings(os.path.join(tmp, "EuRoC_identity.yaml"), _settings_lines(
        cam, orb.ORBConfig(n_features=1200, n_levels=8), 20.0, 35.0,
        ["", *euroc_rectification(ident, ident, EUROC_SHAPE)]))
    gt = os.path.join(tmp, "euroc", "groundtruth.txt")
    with open(gt, "w") as f:      # TUM format, in seconds as stereo_euroc stamps frames
        for i in range(N_FRAMES_EUROC):
            twc = np.linalg.inv(seq.poses[i])
            q = datasets._rot_to_quat(twc[:3, :3])
            ts = (t0_ns + int(round(i / seq.fps * 1e9))) * 1e-9
            f.write(f"{ts:.9f} " + " ".join(f"{x:.9f}" for x in (*twc[:3, 3], *q)) + "\n")
    print(f"  stereo_euroc on {N_FRAMES_EUROC} frames of the lateral sequence (cluttered "
          f"world, seed 6) written in EuRoC's layout in {write_s:.1f} s, EuRoC.yaml's camera "
          f"(1200 features, 8 levels, ThDepth 35) with an identity rectification",
          flush=True)
    _, ev, d = run_driver("driver euroc", stereo_euroc, [
        settings, root, ts_path, "--device", CARD, "--eval", gt,
        *outputs(tmp, "euroc")], N_FRAMES_EUROC)
    print(f"  frames tracked {d['tracked']}/{N_FRAMES_EUROC} from frame {d['first_ok']}, lost "
          f"after {d['lost_after_init']}; keyframes {d['keyframes']}; ATE-RMSE "
          f"{ev['ate_rmse_m']:.4f} m; {d['ms_per_frame']:.2f} ms a frame with PNG decoding "
          f"and rectification; kernel launches {d['launches']}", flush=True)
    if d["first_ok"] >= EUROC_INIT_BY or d["lost_after_init"]:
        fail(f"driver euroc: tracked from frame {d['first_ok']}, lost after "
             f"{d['lost_after_init']}")
    return dict(d, write_s=write_s)


def drive_driver_mono(cam, orb_cfg, tmp) -> dict:
    """18d: phase 17a's lateral drive written in TUM layout, through mono_tum
    with --eval-scale and no vocabulary (17a has none), held to 17a's
    limits."""
    seq = SyntheticSequence(cam, n_frames=N_FRAMES_MONO, trajectory="lateral", seed=5)
    root = os.path.join(tmp, "tum_mono")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        frames = list(pool.map(seq.render, range(N_FRAMES_MONO)))
    assoc = datasets.export_synthetic_tum(Rendered(seq, frames), root)
    write_s = time.perf_counter() - t0
    # fps 10: 17a's max_frames_between_kf
    settings = write_settings(os.path.join(tmp, "TUM_mono.yaml"), _settings_lines(
        cam, orb_cfg, 10.0, 40.0, ["", "Map.MaxKeyFrames: 64", "Map.MaxPoints: 16384"]))
    print(f"[driver mono] mono_tum on phase 17a's {N_FRAMES_MONO} frames written in TUM "
          f"layout in {write_s:.1f} s ({geometry(cam, orb_cfg)}, no vocabulary, Sim3 "
          f"evaluation)", flush=True)
    _, ev, d = run_driver("driver mono", mono_tum, [
        settings, root, assoc, "--device", CARD, "--no-loop-closing", "--eval",
        os.path.join(root, "groundtruth.txt"), "--eval-scale", *outputs(tmp, "mono")],
        N_FRAMES_MONO)
    print(f"  initialized at frame {d['first_ok']}; frames tracked {d['tracked']}/"
          f"{N_FRAMES_MONO}, lost after {d['lost_after_init']}; keyframes {d['keyframes']}, "
          f"points {d['points']}; ATE-RMSE {ev['ate_rmse_m']:.4f} m after Sim3 alignment; "
          f"{d['ms_per_frame']:.2f} ms a frame with PNG decoding; kernel launches "
          f"{d['launches']} ({d['redispatched']} dispatched again)", flush=True)
    if d["first_ok"] >= MONO_INIT_BEFORE:
        fail(f"driver mono: initialized at frame {d['first_ok']}")
    if len(d["lost_after_init"]) > MONO_LOST_MAX:
        fail(f"driver mono: frames {d['lost_after_init']} lost after initialization")
    if d["keyframes"] < MONO_MIN_KEYFRAMES or d["points"] <= MONO_MIN_POINTS:
        fail(f"driver mono: {d['keyframes']} keyframes and {d['points']} points")
    if not (ev["scale_aligned"] and ev["ate_rmse_m"] < MONO_ATE_MAX_M):
        fail(f"driver mono: ATE {ev['ate_rmse_m']} m, limit {MONO_ATE_MAX_M}")
    return dict(d, write_s=write_s)


def check_vocabulary_training() -> dict:
    """18e: the default vocabulary's corpus (pretrained._train_default's: 12
    textures, 1500 features, 4 levels) extracted on the card and trained
    (k=10, depth 3, seed 7) on the card and on the CPU: the trees must be
    identical. Then the share of a held-out frame's word ids that equal the
    shipped tree's (informational: the two packages' extractors agree to a
    tolerance, not bit for bit)."""
    cuda_orb.fused_orient_describe.launches = 0
    t0 = time.perf_counter()
    corpus = pretrained.default_training_corpus(CARD)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = cuda_orb.fused_orient_describe.launches
    t0 = time.perf_counter()
    voc_card = vocabulary.train_vocabulary(corpus, k=10, levels=3, seed=7, device=CARD)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    voc_cpu = vocabulary.train_vocabulary(corpus.cpu(), k=10, levels=3, seed=7, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = (all(np.array_equal(a, b) for a, b in zip(voc_card.centers, voc_cpu.centers))
            and np.array_equal(voc_card.word_weights, voc_cpu.word_weights))
    ex = orb.ORBExtractor(orb.ORBConfig(n_features=1500, n_levels=4), (480, 640), CARD)
    tex = make_texture(np.random.default_rng(4321), 1024)[:480, :640]
    kp = ex(torch.from_numpy(np.ascontiguousarray(tex, np.float32)).to(CARD))
    shipped = pretrained.get_default_vocabulary()
    ids_new = voc_card.transform_packed(kp.desc, kp.valid)
    ids_ship = shipped.transform_packed(kp.desc, kp.valid)
    share = float((ids_new == ids_ship)[kp.valid].float().mean())
    print(f"[vocabulary] _train_default's corpus, {corpus.shape[0]} descriptors extracted on "
          f"the card in {extract_s:.2f} s ({launches} kernel launches for 12 textures); "
          f"k=10 depth 3 seed 7 trained on the card in {card_s:.2f} s and on the CPU in "
          f"{cpu_s:.2f} s: centres and weights {'identical' if same else 'DIFFER'}; a "
          f"held-out frame's word ids equal to the shipped tree's: {share:.3f} of "
          f"{int(kp.valid.sum())} (informational)", flush=True)
    if not same:
        fail("vocabulary: the tree trained on the card differs from the CPU's")
    if launches != 12:
        fail(f"vocabulary: {launches} kernel launches for 12 texture extractions")
    return dict(descriptors=int(corpus.shape[0]), extract_s=extract_s, train_card_s=card_s,
                train_cpu_s=cpu_s, identical=same, held_out_same_words_as_shipped=share,
                launches=launches)


def drive_drivers(cam, orb_cfg, seq, frames, stereo_seq, stereo_frames,
                  ate_defaults, tmp) -> tuple:
    """Phase 18: the dataset drivers, each on a sequence written into the
    temporary directory ``tmp``. -> (entries, rgbd_tum's arguments on 18a's
    sequence)."""
    t0 = time.perf_counter()
    tum, tum_argv = drive_driver_tum(cam, orb_cfg, seq, frames, tmp, ate_defaults)
    kitti = drive_driver_kitti(stereo_seq, stereo_frames, tmp)
    rectifier = check_rectifier(tmp)
    euroc = drive_driver_euroc(tmp)
    mono = drive_driver_mono(cam, orb_cfg, tmp)
    voc = check_vocabulary_training()
    seconds = time.perf_counter() - t0
    print(f"[drivers] phase 18 took {seconds:.1f} s", flush=True)
    return dict(rgbd_tum=tum, stereo_kitti=kitti, rectifier=rectifier, stereo_euroc=euroc,
                mono_tum=mono, vocabulary=voc, seconds=seconds), tum_argv


# ---- phase 19: the parallel paths ---------------------------------------
# distributed global BA in float64 against the single-device solve: the
# ranks' partial sums add up in another order, so the solves differ by
# rounding; phases 6 and 11's limit
DIST_CENTRE_TOL_M = 1e-6
MULTI_SESSIONS = 8                     # 19b: sessions in one batched step
SESSION_INLIERS_MIN = 30               # tests/test_multi_session.py's limits
SESSION_POSE_ERR_MAX = 0.05
MULTI_TIMED_STEPS = 5                  # replays of the batched step timed at each B
MULTI_TIMED_EAGER = 3                  # eager steps and loops of single steps timed
MULTI_TRACED_REPLAYS = 3               # replays traced, one a profiler session
MULTI_SWEEP = (1, 4, 8, 16)            # sessions a step in the sweep


def _pose_errors(tcw: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """The norm of se3.log(Tcw Tgt^-1) for stacks of poses, as
    tests/test_multi_session.py measures a session's error."""
    d = se3.log(se3.compose(torch.as_tensor(tcw, dtype=torch.float64),
                            se3.inverse(torch.as_tensor(gt, dtype=torch.float64))))
    return torch.linalg.norm(d, dim=-1).numpy()


def check_distributed_gba(tmp) -> dict:
    """19a: the JAX dry run's production GBA through distributed_bundle_adjust
    with a group of 1 rank over NCCL (this process) and of 2 ranks over gloo
    (two processes, both on this card), in float32 against the dry run's
    gates and in float64 against the single-device bundle_adjust_pcg."""
    n_cams, n_pts, n_obs = dryrun.GBA_SIZE
    print(f"[parallel gba] distributed_bundle_adjust, the dry run's problem: {n_cams} "
          f"keyframes, {n_pts} points, {n_obs} observations, phases {dryrun.GBA_PHASES}, "
          f"{dryrun.GBA_PCG_ITERS} PCG iterations", flush=True)
    fields, gcam = dryrun.make_gba_problem_np(n_cams, n_pts, n_obs)
    dev = torch.device(CARD)
    sync = torch.cuda.synchronize
    kw = dict(phase_iters=dryrun.GBA_PHASES, pcg_iters=dryrun.GBA_PCG_ITERS)
    dtypes = ("float32", "float64")
    problems = {dt: dryrun.problem_from_numpy(fields, dev, getattr(torch, dt)) for dt in dtypes}
    single, single_ms = {}, {}
    for dt in dtypes:
        ba.bundle_adjust_pcg(problems[dt], gcam, **kw)             # warm
        single[dt], single_ms[dt] = _timed(
            lambda: ba.bundle_adjust_pcg(problems[dt], gcam, **kw), sync)
    runs = {}
    mesh.init(0, 1, "nccl", mesh.free_port())
    try:
        group = mesh.make_group(backend="nccl", device=dev)
        runs["nccl_1"] = {}
        for dt in dtypes:
            # one LM step first: NCCL sets a communicator up at a group's
            # first all-reduce, and each dtype's kernels load at first use
            distributed_bundle_adjust(problems[dt], gcam, group, phase_iters=(1,), pcg_iters=1)
            res, ms = _timed(lambda: distributed_bundle_adjust(problems[dt], gcam, group, **kw),
                             sync)
            runs["nccl_1"][dt] = (res._replace(**{f: getattr(res, f).cpu().numpy() for f in
                                                  ("poses", "points", "inlier")}), ms, False)
    finally:
        torch.distributed.destroy_process_group()
    path, out = os.path.join(tmp, "gba.npz"), os.path.join(tmp, "gba_gloo.npz")
    dryrun.save_problem(path, fields, gcam)
    t0 = time.perf_counter()
    mesh.spawn(dryrun.solve_in_groups, 2, "gloo",
               ([path], [(0, dt, 2) for dt in dtypes], out, CARD, *kw.values(), True))
    spawn_s = time.perf_counter() - t0
    with np.load(out) as f:
        runs["gloo_2"] = {dt: (ba.BAResult(*(f[f"0/{dt}/2/{name}"] for name in ba.BAResult._fields)),
                               float(f[f"0/{dt}/2/seconds"]) * 1e3, bool(f[f"0/{dt}/2/staged"]))
                          for dt in dtypes}
    entries = dict(single_cost_f32=float(single["float32"].cost),
                   single_cost_f64=float(single["float64"].cost),
                   single_ms_f32=single_ms["float32"], single_ms_f64=single_ms["float64"],
                   gloo_spawn_s=spawn_s)
    for name, by_dt in runs.items():
        (r32, ms32, staged), (r64, ms64, _) = by_dt["float32"], by_dt["float64"]
        gates = dryrun.gba_gates(r32, float(single["float32"].cost))
        centre = _centre_diff(np.asarray(r64.poses), single["float64"].poses.cpu().numpy())
        inlier_same = float((np.asarray(r64.inlier) == single["float64"].inlier.cpu().numpy()
                             ).mean())
        print(f"  {name}: float32 cost {gates['cost']:.3f} (single-device "
              f"{gates['cost_single']:.3f}, gate <= 2x + 1e-3), inliers "
              f"{gates['inlier_share']:.4f} (gate >= {dryrun.INLIER_MIN}), finite; float64 cost "
              f"{float(r64.cost):.6f} (single-device {float(single['float64'].cost):.6f}), "
              f"camera centres within {centre:.2e} m of the single-device solve (limit "
              f"{DIST_CENTRE_TOL_M}), inlier classes equal on {inlier_same:.6f}; one solve "
              f"{ms32:.1f} ms float32, {ms64:.1f} ms float64 (single-device {single_ms['float32']:.1f}"
              f" / {single_ms['float64']:.1f} ms)"
              + (f"; gloo staged through pinned host memory: {staged}" if name == "gloo_2" else ""),
              flush=True)
        if centre > DIST_CENTRE_TOL_M:
            fail(f"parallel gba: {name} float64 camera centres {centre} m from single-device")
        entries[name] = dict(cost_f32=gates["cost"], inlier_share_f32=gates["inlier_share"],
                             cost_f64=float(r64.cost), centre_diff_f64_m=centre,
                             inlier_classes_equal_f64=inlier_same, ms_f32=ms32, ms_f64=ms64,
                             staged_through_host=staged)
    print(f"  the gloo pair's two processes took {spawn_s:.1f} s from spawn to exit "
          f"(process start and CUDA set-up included)", flush=True)
    return entries


def _multi_program_at(program, single, inputs, n_tables, b, smi_line):
    """19b at one B: the program's first call (warm-up and capture), then
    its replay held to its warm-up and to its eager step (``run``) bit for
    bit, the describe launches a replay counts, replays traced (graph
    launches, kernels inside a replay), and the ms of a replay, of the
    eager step and, at MULTI_SESSIONS, of B single steps (the B = 1
    program's replays). -> (the readings, the replay's outputs)."""
    from orbslam2_tpu_torch.tools import frame_step_ab

    sync = torch.cuda.synchronize
    sync()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    captures = program.captures
    warm, capture_ms = _timed(lambda: program(*inputs), sync)
    if program.captures != captures + 1:
        fail(f"multi-session: B = {b}: {program.captures - captures} graphs captured by the "
             "first call")
    cuda_orb.fused_orient_describe.launches = 0
    replay = program(*inputs)
    sync()
    counted = cuda_orb.fused_orient_describe.launches
    if counted != n_tables:
        fail(f"multi-session: B = {b}: {counted} describe launches counted for one replay, "
             f"expected {n_tables}")
    eager = program.run(*inputs)
    sync()
    same = {name: all(torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                                  y.view(torch.int32) if y.is_floating_point() else y)
                      for x, y in zip(replay, other))
            for name, other in (("eager", eager), ("warm-up", warm))}
    traced = []
    for _ in range(MULTI_TRACED_REPLAYS):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
            program(*inputs)
            sync()
        traced.append(frame_step_ab.window_counts(trace))
    graphs = [t["graphs"] for t in traced]
    replay_ms = [_timed(lambda: program(*inputs), sync)[1] for _ in range(MULTI_TIMED_STEPS)]
    eager_ms = [_timed(lambda: program.run(*inputs), sync)[1] for _ in range(MULTI_TIMED_EAGER)]
    singles_ms = None
    if b == MULTI_SESSIONS:
        singles = lambda: [single(*(x[s] for x in inputs)) for s in range(b)]  # noqa: E731
        singles()
        singles_ms = [_timed(singles, sync)[1] for _ in range(MULTI_TIMED_EAGER)]
    peak = torch.cuda.max_memory_allocated() - base_mem
    c = traced[0]
    r = dict(sessions=b, capture_ms=capture_ms, replay_ms=float(np.median(replay_ms)),
             replay_ms_min=min(replay_ms), eager_ms=float(np.median(eager_ms)),
             single_steps_ms=float(np.median(singles_ms)) if singles_ms else None,
             describe_per_replay=counted,
             graph_launches_per_step=graphs, kernels_per_replay=c["graph_kernels"],
             launches_outside_per_replay=c["launches"], describe_kernels_traced=c["describe"],
             device_ms_per_replay=c["device_ms"], peak_memory_above_start_bytes=int(peak),
             replay_equal_to_eager=same["eager"], replay_equal_to_warm_up=same["warm-up"])
    print(f"  B = {b}: capture {capture_ms:.1f} ms (warm-up step and capture); a replay "
          f"median {r['replay_ms']:.2f} ms (min {r['replay_ms_min']:.2f}), the eager batched "
          f"step {r['eager_ms']:.2f} ms"
          + (f", {b} single steps {r['single_steps_ms']:.2f} ms" if singles_ms else "")
          + f" (medians, host clock around synchronised calls); replay = eager step: "
          f"{same['eager']}, = "
          f"warm-up: {same['warm-up']}; {graphs} graph launches a traced step, "
          f"{c['graph_kernels']} kernels inside a replay ({c['describe']} describe), "
          f"{c['launches']} launched outside it, {c['device_ms']:.2f} ms of device time; "
          f"{counted} describe launches counted a replay; peak memory "
          f"{peak / 2**20:.0f} MiB above what the process held before this B (its graph's "
          f"pool, the eager steps) | {smi_line}", flush=True)
    if not all(same.values()):
        fail(f"multi-session: B = {b}: the replay differs from the step ({same})")
    if graphs != [1] * MULTI_TRACED_REPLAYS or c["describe"] != n_tables:
        fail(f"multi-session: B = {b}: traced steps made {graphs} graph launches and "
             f"{c['describe']} describe kernels (expected 1 and {n_tables})")
    return r, replay


def check_multi_session(smi_line) -> dict:
    """19b: make_multi_camera_step, the batched step as one program, with 8
    sessions at 640x480 / 2000 / 4 on per-session worlds built as
    tests/test_multi_session.py builds them, held to its eager step, to the
    single steps and to the truth; then the sweep over B."""
    cam, orb_cfg, cap, b = (dryrun.SESSION_CAM, dryrun.SESSION_ORB, dryrun.SESSION_CAP,
                            MULTI_SESSIONS)
    tables_at = lambda k: -(-k * orb_cfg.n_levels // cuda_orb.MAX_LEVELS)  # noqa: E731
    n_tables = tables_at(b)
    print(f"[multi-session] make_multi_camera_step as one program, {b} sessions at "
          f"{geometry(cam, orb_cfg)}, local maps of {cap} points, {n_tables} describe "
          f"launches a step; B = {MULTI_SWEEP}", flush=True)
    t0 = time.perf_counter()
    worlds, gts = dryrun.session_worlds(cam, orb_cfg, b, cap, CARD)
    worlds_s = time.perf_counter() - t0
    program = make_multi_camera_step(cam, orb_cfg, cap, CARD)
    single = make_single_camera_step(cam, orb_cfg, cap, CARD)
    sweep, main = [], None
    for k in MULTI_SWEEP:
        # B above the worlds built repeats them (B = 16: each world twice)
        inputs = tuple(torch.cat([x] * -(-k // b))[:k] for x in worlds)
        r, replay = _multi_program_at(program, single, inputs, tables_at(k), k, smi_line)
        sweep.append(r)
        if k == b:
            main = r
            tcw, n_in = (x.cpu().numpy() for x in replay)
            singles = [single(*(x[s] for x in worlds)) for s in range(b)]
            same = all(np.array_equal(t.cpu().numpy().view(np.int32), tcw[s].view(np.int32))
                       and int(n) == int(n_in[s]) for s, (t, n) in enumerate(singles))
    if program.captures != len(MULTI_SWEEP) or single.program.captures != 1:
        fail(f"multi-session: {program.captures} graphs for {len(MULTI_SWEEP)} shapes, "
             f"{single.program.captures} for the single step")
    launches = main["describe_per_replay"]
    errors = _pose_errors(tcw, gts)
    # the batched tables against the plain version
    ex = orb.get_extractor(orb_cfg, (cam.height, cam.width), CARD)
    per_image = [ex._levels(img) for img in worlds[0]]
    fields = [sum((list(lv[i]) for lv in per_image), []) for i in range(4)]
    budgets = list(ex.level_budgets) * b
    tables = [(*(f[lo:lo + cuda_orb.MAX_LEVELS] for f in fields), ex.pattern_t,
               budgets[lo:lo + cuda_orb.MAX_LEVELS])
              for lo in range(0, len(budgets), cuda_orb.MAX_LEVELS)]
    n_differ, angle_err, n_slots = 0, 0.0, 0
    for args in tables:
        k_out = cuda_orb.fused_orient_describe_levels(*args)
        p_out = cuda_orb.fused_orient_describe_levels_plain(*args)
        n_differ += int((hamming_rows(k_out[1], p_out[1]) > 0).sum())
        d = torch.atan2(torch.sin(k_out[0] - p_out[0]), torch.cos(k_out[0] - p_out[0])).abs()
        angle_err = max(angle_err, float(d.max()))
        n_slots += k_out[1].shape[0]
    print(f"  B = {b}: inliers per session {n_in.tolist()} (each > {SESSION_INLIERS_MIN}); "
          f"pose errors {np.round(errors, 5).tolist()} (each < {SESSION_POSE_ERR_MAX}); the "
          f"replay = {b} single steps: {same}; batched tables against the plain version: "
          f"{n_differ} of {n_slots} descriptors differ (must be 0), max angle difference "
          f"{angle_err:.2e} rad; worlds built in {worlds_s:.1f} s", flush=True)
    if not (n_in > SESSION_INLIERS_MIN).all():
        fail(f"multi-session: inliers {n_in.tolist()}")
    if not (errors < SESSION_POSE_ERR_MAX).all():
        fail(f"multi-session: pose errors {errors.tolist()}")
    if not same:
        fail("multi-session: the batched step differs from the single-session steps")
    if n_differ:
        fail(f"multi-session: {n_differ} descriptors differ from the plain version")
    if angle_err > STEREO16_ANGLE_TOL_RAD:
        fail(f"multi-session: angles differ by {angle_err} rad")

    def run_four_images():
        for img in range(cuda_orb.MAX_LEVELS // orb_cfg.n_levels):
            cuda_orb.fused_orient_describe_levels(*(lv for lv in per_image[img][:4]),
                                                  ex.pattern_t, ex.level_budgets)

    print("  describe, one launch over 4 sessions' 16 levels; each image's 4 levels in a "
          "launch of its own beside it", flush=True)
    times = describe_times(tables[0], run_four_images, cuda_orb.MAX_LEVELS // orb_cfg.n_levels,
                           "four_images_one_launch_each",
                           "four launches, one over each image's 4 levels")
    return dict(launches=launches, launches_per_step=launches, sessions=b,
                inliers=n_in.tolist(), pose_errors=errors.tolist(), equal_to_single=same,
                descriptors_differing=n_differ, max_abs_err=angle_err,
                batched_step_ms=main["replay_ms"], eager_step_ms=main["eager_ms"],
                single_steps_ms=main["single_steps_ms"], sweep=sweep, describe=dict(
                    max_abs_err=angle_err, descriptors_differing=n_differ, **times,
                    ms_covers="one launch over one table of the batched step: 4 sessions' 4 "
                              "levels at 640x480 (the step makes two), timed by CUDA events "
                              "around wrapper calls (host-paced); device_ms is the kernel's "
                              "own duration with L2 flushed before each launch"))


# ---- phase 20: the periphery -------------------------------------------
JPEG_PSNR_MIN_DB = 35.0   # tests/test_torch_viewer.py's bound (quality 95, 4:4:4)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def check_published(live, out_dir, name) -> dict:
    """The live viewer's two JPEG files read back by the port's decoder."""
    frame = jpeg.imread(os.path.join(out_dir, "latest_frame.jpg"))
    top = jpeg.imread(os.path.join(out_dir, "latest_map.jpg"))
    psnr = _psnr(frame, live.last_frame_img) if frame.shape == live.last_frame_img.shape \
        else float("nan")
    if not psnr >= JPEG_PSNR_MIN_DB:
        fail(f"{name}: latest_frame.jpg of shape {frame.shape} at {psnr} dB against the "
             f"rendered frame {live.last_frame_img.shape}")
    if top.shape != (640, 640, 3):
        fail(f"{name}: latest_map.jpg has shape {top.shape}")
    return dict(rendered=live.n_rendered, frame_psnr_db=psnr,
                render_ms_median=float(np.median(live.render_ms)) if live.render_ms else None)


def drive_periphery(cam, orb_cfg, seq, frames, voc, tmp) -> dict:
    """20: ros_demo's path at phase 5's geometry (LocalTopicBus -> RGBDNode)
    with SLAMConfig's defaults and the 10 000-word tree, the AR overlay, the
    headless viewer (PNG) and the live viewer (JPEG) on every frame."""
    print(f"[periphery] ros_demo.replay: phase 5's {len(frames)} frames published on a "
          f"LocalTopicBus into an RGBDNode ({geometry(cam, orb_cfg)}, SLAMConfig's defaults, the "
          f"10 000-word tree), with ARViewer, HeadlessViewer (PNG) and LiveViewer(use_gui=False, "
          f"JPEG) on every frame", flush=True)
    system = SLAMSystem(defaults_config(cam, orb_cfg), Sensor.RGBD, vocabulary=voc)
    tracker = system.tracker
    ar_view = ARViewer(system, cube_size=0.3, plane_threshold=0.05)
    viz_dir, live_dir = os.path.join(tmp, "viz"), os.path.join(tmp, "live")
    os.makedirs(live_dir)
    offline = HeadlessViewer(system, out_dir=viz_dir, map_every=30)
    live = LiveViewer(system, out_dir=live_dir, use_gui=False)
    host_ms = {"ar": [], "headless": []}
    last = {}

    def on_frame(gray):
        t0 = time.perf_counter()
        last["ar"] = ar_view.update(gray)
        t1 = time.perf_counter()
        last["headless"] = offline.update(gray)
        t2 = time.perf_counter()
        live.push_frame(gray)
        host_ms["ar"].append((t1 - t0) * 1e3)
        host_ms["headless"].append((t2 - t1) * 1e3)

    cuda_orb.fused_orient_describe.launches = 0
    t0 = time.perf_counter()
    node, poses = ros_demo.replay(system, frames, seq.fps, on_frame)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = cuda_orb.fused_orient_describe.launches
    live.close()
    if not system.wait_mapping_idle(300):
        fail("periphery: the mapping worker did not become idle within 300 s")
    n = len(frames)
    lost = tracker.trajectory_lost_mask()
    ok_at = np.flatnonzero(~lost)
    first = int(ok_at[0]) if len(ok_at) else None
    ate = check_trajectory("periphery", tracker, seq, dict(first_ok=first)) \
        if first is not None else float("nan")
    published = check_published(live, live_dir, "periphery")
    png_same = np.array_equal(png.imread(os.path.join(viz_dir, f"frame_{n - 1:06d}.png")),
                              last["headless"])
    top = png.imread(os.path.join(viz_dir, "map_000030.png"))
    expected = n + tracker.rebuilt_frames + tracker.retracked_frames
    print(f"  frames {node.frames}, tracked and published {node.tracked} / {len(poses)} poses "
          f"from frame {first}, lost after it {np.flatnonzero(lost[first or 0:]).tolist()}; "
          f"ATE-RMSE {ate:.4f} m (limit {ATE_MAX_M}); keyframes {system.map.n_keyframes()}; "
          f"kernel launches {launches} (expected {expected}); {seconds / n * 1e3:.2f} ms a frame "
          f"with the viewers; AR plane "
          f"{'found, ' + str(ar_view.plane.n_inliers) + ' inliers' if ar_view.plane else 'none'}"
          f"; host ms a frame (median): ARViewer.update "
          f"{np.median(host_ms['ar']):.2f}, HeadlessViewer.update {np.median(host_ms['headless']):.2f}"
          f" (PNG written), LiveViewer render and JPEG publication "
          f"{published['render_ms_median']:.2f} on its thread ({published['rendered']} renders); "
          f"PNG read back equal: {png_same}, map PNG {top.shape}; latest_frame.jpg "
          f"{published['frame_psnr_db']:.2f} dB (limit {JPEG_PSNR_MIN_DB})", flush=True)
    system.shutdown()
    if node.frames != n or len(poses) != node.tracked or first is None or lost[first:].any():
        fail(f"periphery: {node.frames} frames, {node.tracked} tracked, {len(poses)} published, "
             f"lost {np.flatnonzero(lost).tolist()}")
    if not ate <= ATE_MAX_M:
        fail(f"periphery: ATE {ate} m")
    if launches != expected:
        fail(f"periphery: {launches} kernel launches, expected {expected}")
    if ar_view.plane is None:
        fail("periphery: the AR overlay found no plane")
    if not png_same or top.shape != (640, 640, 3):
        fail("periphery: the headless viewer's PNG files do not read back")
    return dict(launches=launches, frames=node.frames, tracked=node.tracked,
                poses_published=len(poses), first_ok=first, ate_m=ate,
                ms_per_frame=seconds / n * 1e3, plane_inliers=ar_view.plane.n_inliers,
                ar_host_ms_median=float(np.median(host_ms["ar"])),
                headless_host_ms_median=float(np.median(host_ms["headless"])),
                live=published, png_read_back_equal=png_same)


def drive_driver_viewer(tum_argv, tmp, n_frames) -> dict:
    """20: rgbd_tum --viewer on 18a's sequence."""
    out = os.path.join(tmp, "tum_viewer")
    os.makedirs(out)
    print(f"[driver viewer] rgbd_tum --viewer --viewer-dir on phase 18a's sequence", flush=True)
    system, ev, d = run_driver("driver viewer", rgbd_tum,
                               [*tum_argv, "--viewer", "--viewer-dir", out,
                                *outputs(tmp, "tum_viewer")], n_frames)
    files = sorted(os.listdir(out))
    frame = jpeg.imread(os.path.join(out, "latest_frame.jpg"))
    top = jpeg.imread(os.path.join(out, "latest_map.jpg"))
    print(f"  frames tracked {d['tracked']}/{n_frames} from frame {d['first_ok']}, lost after "
          f"{d['lost_after_init']}; ATE-RMSE {ev['ate_rmse_m']:.4f} m; {d['ms_per_frame']:.2f} ms "
          f"a frame with the viewer; published {files}: frame {frame.shape}, map {top.shape}",
          flush=True)
    if d["lost_after_init"] or not ev["ate_rmse_m"] <= TUM_DRIVER_ATE_MAX_M:
        fail(f"driver viewer: lost {d['lost_after_init']}, ATE {ev['ate_rmse_m']}")
    if frame.shape != (system.cfg.cam.height + STATUS_BAR_ROWS, system.cfg.cam.width, 3) \
            or top.shape != (640, 640, 3):
        fail(f"driver viewer: published images of shapes {frame.shape}, {top.shape}")
    return dict(d, published=files)


# ---- phase 21: the frame programs -------------------------------------------
FRAME_PROGRAM_REPLAYS = 10     # replays traced under torch.profiler
FRAME_STEP_STEREO_FRAMES = 120  # phase 12's drive cut for phase 21's readings


def staged_frame_inputs(tracker: Tracker, images) -> tuple:
    """The fused step's inputs for `images` on `tracker`'s applied state (its
    last frame's keypoints and device carry, its velocity, the local
    selection, the map mirror): what `Tracker._fused_dispatch` stages."""
    tracker.flush_frames()
    dev = tracker.device
    last = tracker.last_frame
    if tracker.state != TrackingState.OK or tracker.velocity is None \
            or tracker._local_ids is None:
        fail("frame programs: the tracker to stage from is not tracking")
    mir = tracker.map.device_mirror(dev)
    last_pid = tracker._last_pid_dev
    if last_pid is None:
        last_pid = torch.as_tensor(last.pt_ids).to(dev)
    as_dev = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype).to(dev)  # noqa: E731
    return (*(as_dev(im, torch.float32) for im in images),
            (as_dev(np.asarray(tracker.velocity, np.float32)),
             as_dev(np.asarray(last.tcw, np.float32))),
            last.kp, last_pid, as_dev(tracker._local_ids), as_dev(tracker._local_sel), 1.0,
            mir.pt_pos, mir.pt_desc, mir.pt_valid, mir.pt_normal, mir.pt_min_dist,
            mir.pt_max_dist)


def check_frame_program(name, make_program, tracker, images) -> dict:
    """Phase 21 for one sensor: the program captured on staged inputs, one
    replay against the eager step on the same inputs, ten replays traced."""

    from orbslam2_tpu_torch.tools import frame_step_ab

    args = staged_frame_inputs(tracker, images)
    prog = make_program(tracker.extractor, tracker.cam, tracker.cfg.orb.scale_factor,
                        tracker.cfg.orb.n_levels)
    cuda_orb.fused_orient_describe.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = prog(*args)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    if prog.captures != 1 or cuda_orb.fused_orient_describe.launches != 1:
        fail(f"frame programs: {name}: {prog.captures} graphs and "
             f"{cuda_orb.fused_orient_describe.launches} launches after the first call")
    held = prog._graphs[next(iter(prog._graphs))].describe_launches
    replay = prog(*args)
    torch.cuda.synchronize()
    if cuda_orb.fused_orient_describe.launches != 2 or prog.replays != 1 or held != 1:
        fail(f"frame programs: {name}: {cuda_orb.fused_orient_describe.launches} launches "
             f"after one replay ({held} held by the graph)")
    eager = prog.run(*args)             # the eager form: host reads, early stops
    eager_again = prog.run(*args)
    torch.cuda.synchronize()
    def differing(x, y) -> dict:
        """The fields of two steps' outputs that differ in a bit, with their
        largest difference."""
        out = {}
        for field, a in kernels._out_tensors(x).items():
            b = kernels._out_tensors(y)[field]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.shape != b.shape or not torch.equal(a, b):
                out[field] = float((kernels._out_tensors(x)[field].double()
                                    - kernels._out_tensors(y)[field].double()).abs().max())
        return out

    diffs = {f"{label}:{f}": d for label, other in (("eager", eager), ("warm-up", warm))
             for f, d in differing(replay, other).items()}
    eager_spread = differing(eager, eager_again)
    if diffs:
        fail(f"frame programs: {name}: the replay differs from the step ({diffs}); the "
             f"eager step against itself: {eager_spread or 'identical'}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        for _ in range(FRAME_PROGRAM_REPLAYS):
            prog(*args)
        torch.cuda.synchronize()
    c = frame_step_ab.window_counts(trace)
    graphs, describe = c["graphs"], c["describe"]
    if graphs != FRAME_PROGRAM_REPLAYS or describe != FRAME_PROGRAM_REPLAYS:
        fail(f"frame programs: {name}: {FRAME_PROGRAM_REPLAYS} replays traced {graphs} graph "
             f"launches and {describe} describe kernels")
    replay_ms = float(np.median([_timed(lambda: prog(*args), torch.cuda.synchronize)[1]
                                 for _ in range(5)]))
    eager_ms = float(np.median([_timed(lambda: prog.run(*args), torch.cuda.synchronize)[1]
                                for _ in range(5)]))
    graph_mem = torch.cuda.max_memory_allocated() - base_mem
    print(f"  {name}: captured in {capture_ms:.1f} ms (warm-up frame and capture), the replay "
          f"equal to the eager step bit for bit (pt_ids, is_outlier, visible, counts, tcw, "
          f"depth, ur, keypoints; the warm-up too); {FRAME_PROGRAM_REPLAYS} replays traced: "
          f"{graphs} graph launches, {describe} orient_describe_kernel, "
          f"{c['graph_kernels'] / FRAME_PROGRAM_REPLAYS:.0f} kernels inside a replay and "
          f"{c['launches'] / FRAME_PROGRAM_REPLAYS:.0f} outside it; a replay {replay_ms:.2f} ms, "
          f"the eager step {eager_ms:.2f} ms (host clock around a synchronised call); inliers "
          f"{int(replay.n_inliers)}, motion-model matches {int(replay.mm_matches)}; peak "
          f"memory {graph_mem / 2**20:.0f} MiB above the staged inputs (the graph's pool, "
          f"its buffers and the eager steps)", flush=True)
    return dict(capture_ms=capture_ms, replay_ms=replay_ms, eager_ms=eager_ms,
                peak_memory_above_staged_bytes=int(graph_mem),
                kernels_per_replay=c["graph_kernels"] / FRAME_PROGRAM_REPLAYS,
                launches_outside_per_replay=c["launches"] / FRAME_PROGRAM_REPLAYS,
                graph_launches=graphs, describe_kernels=describe,
                describe_per_replay=held, inliers=int(replay.n_inliers),
                eager_run_to_run=eager_spread)


def check_frame_programs(rgbd_system, seq, stereo_system, stereo_seq, stereo_frames,
                         mono_system, mono_seq, frames, smi_line) -> dict:
    """Phase 21: the RGB-D, stereo and mono programs captured on staged inputs
    from phases 14, 12 and 17a and held to the eager step; then phases 5, 12
    (cut) and 14 driven again by orbslam2_tpu_torch/tools/frame_step_ab.py
    for their per-frame readings."""
    from orbslam2_tpu_torch.tools import frame_step_ab

    print("[frame programs] each fused frame step as one CUDA graph (replay = eager step)",
          flush=True)
    out = {
        "rgbd": check_frame_program("rgbd 640x480 / 2000 / 8", kernels._fused_rgbd_program,
                                    rgbd_system.tracker, frames[-1]),
        "stereo": check_frame_program(
            "stereo 1241x376 / 1536 x 150 000", kernels._fused_stereo_program,
            stereo_system.tracker, stereo_frames[-1]),
        "mono": check_frame_program("mono 640x480 / 2000 / 8 (17a)", kernels._fused_mono_program,
                                    mono_system.tracker, (next_view(mono_seq, N_FRAMES_MONO),)),
    }
    readings = []

    def report(r):
        readings.append(r)
        w = r["window"]
        wait = r["fused_dev_ms"].get("median_ms", float("nan"))
        print(f"  {r['name']}: median {r['median_ms']:.2f} ms, p95 {r['p95_ms']:.2f} ms a frame; "
              f"fetch wait (fused_dev) median {wait:.3f} ms; window of {w['frames']} frames "
              f"from {w['first']}: {w['device_kernels_per_frame']:.0f} device kernels "
              f"({w['graph_kernels_per_frame']:.0f} inside graph replays), "
              f"{w['kernel_launches_per_frame']:.0f} kernel and "
              f"{w['graph_launches_per_frame']:.2f} graph launches, "
              f"{w['describe_kernels_per_frame']:.2f} describe kernels a frame, card busy "
              f"{w['busy_share'] * 100:.1f} %; peak memory {r['peak_memory_bytes'] / 2**20:.0f} "
              f"MiB; {r['graphs_captured']} graphs captured; {r['tracked']}/{r['frames']} "
              f"tracked, ATE {r['ate_m']:.4f} m; {r['seconds']:.1f} s | {smi_line}", flush=True)

    for r in frame_step_ab.rgbd_drives(frames, seq):
        report(r)
    report(frame_step_ab.stereo_drive(stereo_frames[:FRAME_STEP_STEREO_FRAMES], stereo_seq))
    out["readings"] = readings
    return out


# ---- phase 21b: the classic path's programs ---------------------------------
def classic_outputs(out) -> dict:
    """The tensors of a build's (kp, ur, depth) or a TrackStepResult by name."""
    if isinstance(out, kernels.TrackStepResult):
        return out._asdict()
    kp, ur, depth = out
    return {**{f"kp.{f}": x for f, x in zip(kernels._KP_FIELDS, kernels._kp_tensors(kp))},
            "ur": ur, "depth": depth}


def differing_outputs(x, y) -> dict:
    """The outputs of two runs of a classic program that differ in a bit,
    with their largest difference."""
    out = {}
    for field, a in classic_outputs(x).items():
        b = classic_outputs(y)[field]
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
                a.view(torch.int32) if a.dtype == torch.float32 else a,
                b.view(torch.int32) if b.dtype == torch.float32 else b):
            out[field] = float((a.double() - b.double()).abs().max()) \
                if a.shape == b.shape else float("nan")
    return out


def check_classic_program(name, prog, args, describe_held, smi_line) -> dict:
    """Phase 21b for one program: a new program (no graph) made for what
    `prog` was made for, captured on `args`, one replay against the eager
    step on the same inputs bit for bit (and against the warm-up), ten
    replays traced, the times and the peak memory."""
    from orbslam2_tpu_torch.tools import frame_step_ab

    fresh = copy.deepcopy(prog)
    cuda_orb.fused_orient_describe.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    warm = fresh(*args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    if fresh.captures != 1 or cuda_orb.fused_orient_describe.launches != describe_held:
        fail(f"classic programs: {name}: {fresh.captures} graphs and "
             f"{cuda_orb.fused_orient_describe.launches} describe launches after the first "
             f"call (expected 1 and {describe_held})")
    held = fresh._graphs[next(iter(fresh._graphs))].describe_launches
    replay = fresh(*args)
    torch.cuda.synchronize()
    if cuda_orb.fused_orient_describe.launches != 2 * describe_held or fresh.replays != 1 \
            or held != describe_held:
        fail(f"classic programs: {name}: {cuda_orb.fused_orient_describe.launches} describe "
             f"launches after one replay ({held} held by the graph, expected {describe_held})")
    eager = fresh.run(*args)             # the eager form: host reads, early stops
    eager_again = fresh.run(*args)
    torch.cuda.synchronize()
    diffs = {f"{label}:{f}": d for label, other in (("eager", eager), ("warm-up", warm))
             for f, d in differing_outputs(replay, other).items()}
    eager_spread = differing_outputs(eager, eager_again)
    if diffs:
        fail(f"classic programs: {name}: the replay differs from the step ({diffs}); the "
             f"eager step against itself: {eager_spread or 'identical'}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        for _ in range(FRAME_PROGRAM_REPLAYS):
            fresh(*args)
        torch.cuda.synchronize()
    c = frame_step_ab.window_counts(trace)
    if c["graphs"] != FRAME_PROGRAM_REPLAYS or \
            c["describe"] != FRAME_PROGRAM_REPLAYS * describe_held:
        fail(f"classic programs: {name}: {FRAME_PROGRAM_REPLAYS} replays traced {c['graphs']} "
             f"graph launches and {c['describe']} describe kernels")
    replay_ms = float(np.median([_timed(lambda: fresh(*args), torch.cuda.synchronize)[1]
                                 for _ in range(5)]))
    eager_ms = float(np.median([_timed(lambda: fresh.run(*args), torch.cuda.synchronize)[1]
                                for _ in range(5)]))
    peak = torch.cuda.max_memory_allocated() - base_mem
    pool = graph_pool_bytes(fresh)
    fresh.release()
    print(f"  {name}: first call {first_ms:.1f} ms (warm-up and capture; the capture "
          f"{fresh.capture_ms[0]:.1f} ms), the replay equal to the eager step bit for bit "
          f"({', '.join(classic_outputs(replay))}; the warm-up too); {held} describe launch"
          f"{'es' if held != 1 else ''} held by the graph; {FRAME_PROGRAM_REPLAYS} replays "
          f"traced: {c['graphs']} graph launches, {c['describe']} orient_describe_kernel, "
          f"{c['graph_kernels'] / FRAME_PROGRAM_REPLAYS:.0f} kernels inside a replay and "
          f"{c['launches'] / FRAME_PROGRAM_REPLAYS:.0f} outside it; a replay {replay_ms:.2f} "
          f"ms, the eager step {eager_ms:.2f} ms (host clock around a synchronised call); "
          f"peak memory {peak / 2**20:.0f} MiB above the staged inputs (the graph's pool, "
          f"its buffers and the eager steps); the graph's pool "
          f"{'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'} | {smi_line}",
          flush=True)
    return dict(first_call_ms=first_ms, capture_ms=fresh.capture_ms[0], replay_ms=replay_ms,
                eager_ms=eager_ms, peak_memory_above_staged_bytes=int(peak),
                graph_pool_bytes=pool,
                kernels_per_replay=c["graph_kernels"] / FRAME_PROGRAM_REPLAYS,
                launches_outside_per_replay=c["launches"] / FRAME_PROGRAM_REPLAYS,
                graph_launches=c["graphs"], describe_kernels=c["describe"],
                describe_per_replay=held, eager_run_to_run=eager_spread)


def graph_pool_bytes(prog):
    """The bytes of the caching allocator's segments in the memory pools of
    the program's graphs (what the program keeps for its owner's life), or
    None where this torch's memory snapshot does not say."""
    try:
        pools = {tuple(c.graph.pool()) for c in prog._graphs.values()}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools)
    except (AttributeError, KeyError, TypeError, RuntimeError):
        return None


def check_classic_programs(rgbd_system, frames, seq, stereo_system, stereo_frames,
                           mono_system, mono_seq, smi_line) -> dict:
    """Phase 21b: the classic tracking path's five programs. The builds of
    each sensor (frame.BuildProgram) on phase 14's, 12's and 17a's last
    images; the motion-model and local-map steps (kernels.MotionModelProgram
    and LocalMapProgram) on the inputs a classic-path frame staged: a copy of
    phase 14's tracker, its local selection dropped so that the next frame
    takes the classic path, tracks phase 5's last frame again through its
    programs (each captured there), and each program is held on the inputs
    of that call."""
    print("[classic programs] the classic path's frame builds and motion-model and "
          "local-map steps, each as one CUDA graph (replay = eager step)", flush=True)
    out = {}
    for kind, system, images in (
            ("rgbd", rgbd_system, frames[-1]), ("stereo", stereo_system, stereo_frames[-1]),
            ("mono", mono_system, (next_view(mono_seq, N_FRAMES_MONO),))):
        tr = system.tracker
        imgs = [torch.as_tensor(im, dtype=torch.float32).to(tr.device) for im in images]
        prog = frame_mod.BuildProgram(kind, tr.extractor, tr.cam)
        out[f"build {kind}"] = check_classic_program(
            f"build {kind} {tr.cam.width}x{tr.cam.height} / {tr.cfg.orb.n_features} / "
            f"{tr.cfg.orb.n_levels}", prog, imgs, 1, smi_line)
    rgbd_system.wait_mapping_idle()
    tr = copy_tracker(rgbd_system.tracker)
    # the next frame runs the classic path: the whole local selection goes,
    # as Tracker.reset drops it (a point the mapper merged since would else
    # be remapped in a selection without its padded ids)
    tr._local_ids = tr._local_sel = tr._local_pts = None
    tr._selection_fresh = False
    t0 = time.perf_counter()
    tcw = tr.track_rgbd(*frames[-1], len(frames) / seq.fps)
    classic_ms = (time.perf_counter() - t0) * 1e3
    progs = tr.classic_programs
    names = ("rgbd", "motion_model_step", "local_map_step")
    if tcw is None or any(name not in progs or progs[name].captures != 1 for name in names):
        fail(f"classic programs: the classic-path frame on a copy of phase 14's tracker: "
             f"tracked {tcw is not None}, programs "
             f"{ {k: p.captures for k, p in progs.items()} }")
    print(f"  a classic-path frame on a copy of phase 14's tracker: {classic_ms:.1f} ms with "
          f"its three captures ("
          f"{', '.join(f'{k} {progs[k].capture_ms[0]:.1f} ms' for k in names)})", flush=True)
    for name in names[1:]:
        prog = progs[name]
        staged = prog._unflatten([x.clone() for x in next(iter(prog._graphs.values())).sources])
        out[name] = check_classic_program(name, prog, staged, 0, smi_line)
    for prog in progs.values():
        prog.release()
    out["classic_frame_ms"] = classic_ms
    return out


SOLVE_PROGRAM_REPLAYS = 5        # replays held to the eager solve (phase 22)
PROGRAM_EAGER_TOL_M = 1e-9       # a replay against the eager solve on the card
PROGRAM_HOST_LAUNCHES_MAX = 40   # kernels the host launches a solve besides its graphs
TRACED_REPLAYS = 3
SENTINEL_BYTE = 0x5A


def _to(x, dev):
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, ba.BAProblem):
        return ba.BAProblem(*(t.to(dev) for t in x))
    return x


def check_solve_program(name, program, eager, args, kw, poses_of, smi_line) -> dict:
    """Phase 22 for one solve: a new program captures its graphs on the
    problem a drive solved, then replays it SOLVE_PROGRAM_REPLAYS times;
    every result is held to the eager solve on the card (camera centres
    within PROGRAM_EAGER_TOL_M: index_add_ sums by atomics, in another order
    each run) and to the eager solve on the CPU (phases 6 and 11's limit);
    one replay and one eager solve are traced."""

    from orbslam2_tpu_torch.tools import frame_step_ab

    sync = torch.cuda.synchronize
    cpu = poses_of(eager(*(_to(a, "cpu") for a in args),
                         **{k: _to(v, "cpu") for k, v in kw.items()}))
    eager(*args, **kw)                                        # warm-up
    eager_ms = []
    for _ in range(2):
        out, ms = _timed(lambda: eager(*args, **kw), sync)
        eager_ms.append(ms)
    ref = poses_of(out)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    first, first_ms = _timed(lambda: program(*args, **kw), sync)
    graph_mem = torch.cuda.max_memory_allocated() - base_mem
    # blocks a dropped buffer of the program would have freed go to these
    # sentinels; a replay that still wrote such a buffer would spoil them
    gc.collect()
    sentinels = [torch.full((512 * k,), SENTINEL_BYTE, dtype=torch.uint8, device=CARD)
                 for k in (1, 2, 4, 8, 16, 32, 64, 128) for _ in range(64)]
    results, replay_ms = [poses_of(first)], []
    for _ in range(SOLVE_PROGRAM_REPLAYS):
        out, ms = _timed(lambda: program(*args, **kw), sync)
        results.append(poses_of(out))
        replay_ms.append(ms)
    spoiled = int(torch.cat(sentinels).ne(SENTINEL_BYTE).sum())
    if spoiled:
        fail(f"solve programs: {name}: the replays wrote {spoiled} bytes of memory "
             f"allocated after the capture")
    if not all(np.isfinite(r).all() for r in results):
        fail(f"solve programs: {name}: a replay is not finite")
    d_eager = max(_centre_diff(r, ref) for r in results)
    d_cpu = max(_centre_diff(r, cpu) for r in results)
    d_eager_cpu = _centre_diff(ref, cpu)
    n_graphs = GRAPHS_PER_SOLVE[name]
    if program.captures != 1 or program.replays != SOLVE_PROGRAM_REPLAYS + 1 or \
            program.graph_launches != n_graphs * (SOLVE_PROGRAM_REPLAYS + 1):
        fail(f"solve programs: {name}: {program.captures} captures, {program.replays} "
             f"replays, {program.graph_launches} graph launches")
    traced = []        # one replay in each of TRACED_REPLAYS profiler sessions
    for _ in range(TRACED_REPLAYS):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
            program(*args, **kw)
            sync()
        traced.append(frame_step_ab.window_counts(trace))
    c = traced[0]
    kernels_traced = [t["graph_kernels"] for t in traced]
    eager_act = device_activity(lambda: eager(*args, **kw))
    print(f"  {name}: capture {program.capture_ms[0]:.1f} ms of graphs, the first solve "
          f"{first_ms:.1f} ms (its warm-up, capture and replay); a replay median "
          f"{np.median(replay_ms):.2f} ms (min {min(replay_ms):.2f}) against the eager solve "
          f"{min(eager_ms):.2f} ms (host clock around a synchronised call); camera centres: "
          f"replays vs the eager solve on the card up to {d_eager:.3e} m (limit "
          f"{PROGRAM_EAGER_TOL_M}), vs the CPU up to {d_cpu:.3e} m (limit "
          f"{LOOP_TRANSLATION_TOL_M}), the eager card vs the CPU {d_eager_cpu:.3e} m; one "
          f"replay traced {TRACED_REPLAYS} times: {c['graphs']} graph launches, kernels inside "
          f"them {kernels_traced} (one graph each time: a count that varies is the trace "
          f"dropping records), {c['launches']} kernels launched by the host, device busy "
          f"{c['device_ms']:.2f} ms; the eager solve: {eager_act[0]} kernels launched by "
          f"the host, busy {eager_act[2]:.2f} of {eager_act[3]:.2f} ms; peak memory "
          f"{graph_mem / 2**20:.0f} MiB above the problem (buffers and the graphs' pool) "
          f"| {smi_line}", flush=True)
    for t in traced:
        if t["graphs"] != n_graphs or t["launches"] > PROGRAM_HOST_LAUNCHES_MAX:
            fail(f"solve programs: {name}: a traced replay launched {t['graphs']} graphs "
                 f"(expected {n_graphs}) and {t['launches']} kernels from the host (at most "
                 f"{PROGRAM_HOST_LAUNCHES_MAX})")
    if d_eager > PROGRAM_EAGER_TOL_M:
        fail(f"solve programs: {name}: a replay is {d_eager} m from the eager solve")
    if d_cpu > LOOP_TRANSLATION_TOL_M:
        fail(f"solve programs: {name}: a replay is {d_cpu} m from the CPU")
    return dict(capture_ms=program.capture_ms[0], first_solve_ms=first_ms,
                replay_ms=float(np.median(replay_ms)), replay_ms_min=min(replay_ms),
                eager_ms=min(eager_ms), centre_diff_eager_m=d_eager, centre_diff_cpu_m=d_cpu,
                eager_vs_cpu_m=d_eager_cpu, graph_launches_per_solve=c["graphs"],
                kernels_per_solve=kernels_traced, host_launches_per_solve=c["launches"],
                replay_device_ms=c["device_ms"], eager_host_launches=eager_act[0],
                eager_device_busy_ms=eager_act[2], eager_wall_ms=eager_act[3],
                peak_memory_above_problem_bytes=int(graph_mem))


def check_concurrent_gbas(problem, kw, cam) -> dict:
    """Phase 22: two global BAs at once from two threads through one program
    (the second on a stream of its own, on a copy of the problem with its
    points moved by up to a centimetre): each equal to its own eager solve."""
    rng = np.random.default_rng(22)
    other = problem._replace(points=problem.points + torch.from_numpy(
        rng.uniform(-0.01, 0.01, tuple(problem.points.shape))).to(problem.points))
    problems = [problem, other]
    program = solve_program.BundleAdjustProgram(problem.poses.device, pcg=True)
    program(problem, cam, **kw)                               # capture
    eager = [ba.bundle_adjust_pcg(p, cam, **kw).poses.cpu().numpy() for p in problems]
    streams = [torch.cuda.current_stream(), torch.cuda.Stream()]
    start = threading.Barrier(2)
    got, errors = [None, None], []

    def solve(i):
        try:
            with torch.cuda.stream(streams[i]):
                start.wait()
                got[i] = program(problems[i], cam, **kw).poses.cpu().numpy()
        except Exception as e:            # raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=solve, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    if errors or any(th.is_alive() for th in threads):
        fail(f"solve programs: two global BAs at once failed or hung: {errors}")
    diffs = [_centre_diff(got[i], eager[i]) for i in range(2)]
    apart = _centre_diff(eager[0], eager[1])
    print(f"  two global BAs at once (two threads, two streams, one program): each against "
          f"its own eager solve {diffs[0]:.3e} m and {diffs[1]:.3e} m (limit "
          f"{PROGRAM_EAGER_TOL_M}); the two solves {apart:.3e} m apart; {program.replays} "
          f"replays, {program.captures} capture", flush=True)
    if max(diffs) > PROGRAM_EAGER_TOL_M:
        fail(f"solve programs: concurrent global BAs differ from their eager solves {diffs}")
    return dict(centre_diff_m=diffs, solves_apart_m=apart)


def _repad_obs(problem, slots: int):
    """`problem` with its valid observations (the first rows) padded to
    `slots` rows as the loop closer pads them (camera 0, point 0, invalid)."""
    n = int(problem.obs_valid.sum())
    rows = {}
    for f, fill in (("obs_cam", 0), ("obs_pt", 0), ("obs_uv", 0.0), ("obs_inv_sigma2", 1.0),
                    ("obs_stereo", False), ("obs_valid", False)):
        x = getattr(problem, f)
        pad = torch.full((slots - n, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        rows[f] = torch.cat([x[:n], pad])
    return problem._replace(**rows)


def check_gba_padding(problem, kw, cam, smi_line) -> dict:
    """Phase 22: phase 11's global BA with its observations padded to the
    bucket of each growth the loop closer could use (GBA_OBS_FLOOR times 2
    or 4 to a power) and unpadded: each through a new program (capture ms,
    replay ms, the replay's device-busy ms) and eagerly (device-busy ms),
    every padding's cameras within PROGRAM_EAGER_TOL_M of the unpadded
    solve's. The padding's cost per solve against a capture's, which a
    finer growth makes more often."""
    from orbslam2_tpu_torch.tools import frame_step_ab

    n = int(problem.obs_valid.sum())
    sizes = {"unpadded": n}
    for growth in (2, 4):
        sizes[f"growth {growth}"] = local_mapping.size_bucket(
            n, loop_closing.GBA_OBS_FLOOR, growth)
    out, ref = {}, None
    for label, slots in sizes.items():
        padded = _repad_obs(problem, slots)
        program = solve_program.BundleAdjustProgram(CARD, pcg=True)
        program(padded, cam, **kw)                             # capture
        replay_ms = []
        for _ in range(3):
            res, ms = _timed(lambda: program(padded, cam, **kw), torch.cuda.synchronize)
            replay_ms.append(ms)
        poses = res.poses.cpu().numpy()
        ref = poses if ref is None else ref
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
            program(padded, cam, **kw)
            torch.cuda.synchronize()
        replay_dev = frame_step_ab.window_counts(trace)["device_ms"]
        eager_busy = device_activity(lambda: ba.bundle_adjust_pcg(padded, cam, **kw))[2]
        diff = _centre_diff(poses, ref)
        out[label] = dict(slots=slots, capture_ms=program.capture_ms[0],
                          replay_ms=float(np.median(replay_ms)), replay_device_ms=replay_dev,
                          eager_device_busy_ms=eager_busy, centre_diff_unpadded_m=diff)
        print(f"  global BA, {n} observations in {slots} slots ({label}): capture "
              f"{program.capture_ms[0]:.1f} ms, a replay median {np.median(replay_ms):.2f} "
              f"ms, device busy {replay_dev:.2f} ms a replay and {eager_busy:.2f} ms an eager "
              f"solve; cameras vs unpadded {diff:.3e} m | {smi_line}", flush=True)
        if diff > PROGRAM_EAGER_TOL_M:
            fail(f"solve programs: the global BA padded to {slots} observation slots is "
                 f"{diff} m from the unpadded solve")
    return out


EG_PADDED_EDGES = (256, 1024, 4096, 8192)


def check_eg_padding(args, kw, smi_line) -> dict:
    """Phase 22: phase 11's essential graph with its edges padded to each of
    EG_PADDED_EDGES rows (the loop keyframe joined to itself, invalid), each
    through a new program: capture ms, replay ms, the replay's device-busy
    ms, the valid keyframes' camera centres within PROGRAM_EAGER_TOL_M of
    the first size's. What a larger edge bucket costs a solve, against the
    captures a smaller one makes as the map grows."""
    from orbslam2_tpu_torch.tools import frame_step_ab

    poses, kf_valid, kf_fixed, e_i, e_j, meas, e_valid = args
    n = int(e_valid.sum())
    anchor = int(e_i[n]) if n < len(e_i) else int(e_i[0])
    valid = kf_valid.cpu().numpy()
    out, ref = {}, None
    for slots in EG_PADDED_EDGES:
        if slots < n:
            continue
        pad = slots - n
        fill = torch.full((pad,), anchor, dtype=e_i.dtype, device=e_i.device)
        padded = (poses, kf_valid, kf_fixed, torch.cat([e_i[:n], fill]),
                  torch.cat([e_j[:n], fill]),
                  torch.cat([meas[:n], torch.eye(4, dtype=meas.dtype, device=meas.device)
                             .expand(pad, 4, 4)]),
                  torch.cat([e_valid[:n], torch.zeros(pad, dtype=torch.bool,
                                                      device=e_valid.device)]))
        program = solve_program.EssentialGraphProgram(CARD)
        program(*padded, **kw)                                  # capture
        replay_ms = []
        for _ in range(3):
            res, ms = _timed(lambda: program(*padded, **kw), torch.cuda.synchronize)
            replay_ms.append(ms)
        centres = res[0].cpu().numpy()[valid]
        ref = centres if ref is None else ref
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
            program(*padded, **kw)
            torch.cuda.synchronize()
        replay_dev = frame_step_ab.window_counts(trace)["device_ms"]
        diff = _centre_diff(centres, ref)
        out[str(slots)] = dict(edges=n, capture_ms=program.capture_ms[0],
                               replay_ms=float(np.median(replay_ms)),
                               replay_device_ms=replay_dev, centre_diff_m=diff)
        print(f"  essential graph, {n} edges in {slots} slots: capture "
              f"{program.capture_ms[0]:.1f} ms, a replay median {np.median(replay_ms):.2f} "
              f"ms, device busy {replay_dev:.2f} ms a replay; cameras vs "
              f"{EG_PADDED_EDGES[0]} slots {diff:.3e} m | {smi_line}", flush=True)
        if diff > PROGRAM_EAGER_TOL_M:
            fail(f"solve programs: the essential graph padded to {slots} edges is {diff} m "
                 f"from the same graph in fewer slots")
    return out


def check_solve_programs(ba_staged, ba_cam, loop_captured, loop_cam, smi_line) -> dict:
    """Phase 22: the local-BA problem of phase 6 and the essential-graph and
    global-BA problems of phase 11 through new programs on the card."""
    print("[solve programs] local BA, the essential graph and global BA as CUDA graphs of "
          "their parts, the LM step replayed once per step", flush=True)
    problem, pt_fixed = ba_staged
    args, kw = loop_captured.eg
    gba_problem, gba_kw = loop_captured.gba
    valid = args[1].cpu().numpy()
    out = {
        "local_ba": check_solve_program(
            "local_ba", solve_program.BundleAdjustProgram(CARD), ba.bundle_adjust,
            (problem, ba_cam), dict(point_fixed=pt_fixed),
            lambda r: r.poses.cpu().numpy(), smi_line),
        "essential_graph": check_solve_program(
            "essential_graph", solve_program.EssentialGraphProgram(CARD),
            pose_graph.optimize_essential_graph, args, kw,
            lambda r: r[0].cpu().numpy()[valid], smi_line),
        "gba": check_solve_program(
            "gba", solve_program.BundleAdjustProgram(CARD, pcg=True), ba.bundle_adjust_pcg,
            (gba_problem, loop_cam), gba_kw, lambda r: r.poses.cpu().numpy(), smi_line),
    }
    out["concurrent_gba"] = check_concurrent_gbas(gba_problem, gba_kw, loop_cam)
    out["gba_padding"] = check_gba_padding(gba_problem, gba_kw, loop_cam, smi_line)
    out["essential_graph_padding"] = check_eg_padding(args, kw, smi_line)
    return out


PHASE_LIMIT_S = 600      # the watchdog: a phase running longer than this
DEADLINE_S = 1150        # or past this time since the start dumps every
                         # thread's stack and exits non-zero
_START = time.monotonic()


def run_phase(fn, *args, **kw):
    """fn(*args, **kw) under the watchdog: if it has not returned within
    PHASE_LIMIT_S (or by DEADLINE_S after the start, whichever is sooner),
    faulthandler prints the stack of every thread and the process exits
    with code 1. A hang shows where it hangs instead of running on silently
    into the caller's time limit. Prints the phase's seconds and the
    seconds since the start when it returns."""
    limit = min(PHASE_LIMIT_S, DEADLINE_S - (time.monotonic() - _START))
    faulthandler.dump_traceback_later(max(limit, 30.0), exit=True)
    t0 = time.monotonic()
    try:
        out = fn(*args, **kw)
    finally:
        faulthandler.cancel_dump_traceback_later()
    print(f"[phase time] {getattr(fn, '__name__', 'phase')}: {time.monotonic() - t0:.1f} s, "
          f"{time.monotonic() - _START:.1f} s since the start", flush=True)
    return out


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
    # the CUDA kernel library (nvcc) and the map-graph engine (g++) at once
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cuda_build = pool.submit(cuda_orb.build_kernels, force=True, ptxas_verbose=True)
        native_build = pool.submit(native.build, force=True)
        lib_path, native_path = run_phase(lambda: (cuda_build.result(), native_build.result()))
    print(f"[build] {lib_path} and {native_path} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    cam = PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                        width=640, height=480, bf=40.0)
    orb_cfg = orb.ORBConfig(n_features=2000, n_levels=8)
    t0 = time.perf_counter()
    seq = SyntheticSequence(cam, n_frames=N_FRAMES, trajectory="shuttle",
                            seed=3, world="cluttered")
    frames = [seq.render(i) for i in range(N_FRAMES)]
    print(f"[render] {N_FRAMES} frames 640x480 on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phases 3 to 8 ----------------------------------------------------
    kernel = run_phase(check_kernel, orb.get_extractor(orb_cfg, (cam.height, cam.width)),
                       frames[0][0])
    # bench.py's bench_system geometry; async_mapping (the worker) and
    # vocabulary=None are the defaults
    cfg = SLAMConfig(cam=cam, orb=orb_cfg, th_depth=6.0, max_keyframes=64,
                     max_points=16384, local_point_cap=4096,
                     max_frames_between_kf=30, min_init_features=400,
                     pipelined_fetch=False, profile_stages=True)
    tracker_alone = run_phase(drive_tracker_alone, cfg, frames, seq)
    main_path, system, last_ba = run_phase(drive_main_path, cfg, frames, seq)
    ba_check = run_phase(check_ba_card_vs_cpu, last_ba, cam)
    search_check = run_phase(check_mapping_searches, system, cam, orb_cfg)
    dense = run_phase(drive_keyframe_dense, cfg, frames, seq)
    # ---- phases 9 to 11 ---------------------------------------------------
    place, place_system, captured, place_seq, place_frames, place_cam = \
        run_phase(drive_place_recognition, cam, orb_cfg)
    reloc = run_phase(check_relocalization, place_system, place_seq, place_frames)
    run_phase(place_system.shutdown)  # joins the worker and a GBA; raises a failure
    loop = run_phase(check_loop_card_vs_cpu, captured, place_system.vocabulary, place_cam)
    # ---- phases 12 and 13: stereo at KITTI geometry and capacity ----------
    stereo_kitti, stereo_system, stereo_seq, stereo_frames = run_phase(drive_stereo_kitti)
    stereo_parts = run_phase(check_stereo_parts, stereo_system, stereo_seq, stereo_frames)
    # ---- phase 14: the default configuration ------------------------------
    defaults_k1, defaults_system = run_phase(
        drive_defaults_rgbd, "defaults", defaults_config(cam, orb_cfg), frames, seq)
    defaults_k4, _ = run_phase(
        drive_defaults_rgbd, "defaults K=4", defaults_config(cam, orb_cfg, fetch_batch=4),
        frames, seq)
    defaults_repeated = run_phase(check_repeated_defaults, cam, orb_cfg, frames, seq)
    capture_after_drop = run_phase(check_capture_after_drop, cam, orb_cfg, frames, seq)
    defaults_stereo = run_phase(drive_defaults_stereo, stereo_seq, stereo_frames)
    # ---- phases 15 and 16: localization mode and the system API; backlog --
    localization = run_phase(check_localization, cam, orb_cfg, smi_line)
    reload = run_phase(check_map_reload, place_system, place_seq, place_frames)
    gba = run_phase(check_global_ba, defaults_system, seq)
    backlog = run_phase(drive_backlog, cam, orb_cfg, frames, seq, place_system.vocabulary)
    # ---- phase 17: monocular ----------------------------------------------
    mono, two_view_args, mono_a_system, mono_a_seq = run_phase(drive_mono, cam, orb_cfg)
    two_view = run_phase(check_two_view_card_vs_cpu, two_view_args)
    mono_loop, mono_system, mono_seq = run_phase(drive_mono_loop, cam, orb_cfg,
                                                 place_system.vocabulary)
    mono_reloc = run_phase(check_mono_relocalization, mono_system, mono_seq,
                           mono_loop["first_ok"])
    run_phase(mono_system.shutdown)
    replaced = run_phase(check_replaced_points, mono_a_system, mono_a_seq, N_FRAMES_MONO)
    run_phase(mono_a_system.shutdown)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- phase 18: the dataset drivers --------------------------------
        drivers, tum_argv = run_phase(drive_drivers, cam, orb_cfg, seq, frames, stereo_seq,
                                      stereo_frames, defaults_k1["ate_m"], tmp)
        # ---- phase 19: distributed global BA, batched multi-session ----
        gba_parallel = run_phase(check_distributed_gba, tmp)
        multi = run_phase(check_multi_session, smi_line)
        # ---- phase 20: the ROS-style node, the viewers, the AR overlay ----
        periphery = run_phase(drive_periphery, cam, orb_cfg, seq, frames,
                              place_system.vocabulary, tmp)
        driver_viewer = run_phase(drive_driver_viewer, tum_argv, tmp, N_FRAMES)
    # ---- phase 21: the frame programs -------------------------------------
    programs = run_phase(check_frame_programs, defaults_system, seq, stereo_system,
                         stereo_seq, stereo_frames, mono_a_system, mono_a_seq, frames,
                         smi_line)
    classic = run_phase(check_classic_programs, defaults_system, frames, seq, stereo_system,
                        stereo_frames, mono_a_system, mono_a_seq, smi_line)
    # ---- phase 22: the solve programs -------------------------------------
    solve_programs = run_phase(check_solve_programs, last_ba, cam, captured, place_cam,
                               smi_line)
    check_no_jax("after the drives")  # a lazy import on a drive shows here

    print(json.dumps({"kernels": [{
        "name": "fused_orient_describe", "route": "cuda",
        "source": "orbslam2_tpu_torch/csrc/orient_describe.cu",
        "replaces": "orbslam2_tpu/ops/pallas_orb.py:196",
        # one launch over one 640x480 frame's 8 levels (phase 3) and the
        # RGB-D main path's launches (phase 5), as in earlier slices, each
        # fused frame's launch inside its CUDA graph counted at its replay
        # (phase 21 traces one orient_describe_kernel a replay); the
        # stereo main path's launch over both images' 16 levels at 1241x376
        # (phases 12 and 13) under stereo_16_levels
        **kernel, "launches": main_path["launches"],
        "launches_per_frame": main_path["launches"] // N_FRAMES,
        "stereo_16_levels": {**stereo_parts.pop("describe16"),
                             "launches": stereo_kitti["launches"],
                             "launches_per_frame": stereo_kitti["launches_per_frame_build"]},
        "launches_by_path": {"defaults_rgbd": defaults_k1["launches"],
                             "defaults_rgbd_fetch_batch_4": defaults_k4["launches"],
                             "defaults_rgbd_repeated": defaults_repeated["launches"],
                             "defaults_stereo": defaults_stereo["launches"],
                             "localization": localization["launches"],
                             "backlog": backlog["launches"],
                             "mono": mono["launches"], "mono_loop": mono_loop["launches"],
                             "mono_relocalization": mono_reloc["launches"],
                             "mono_replaced_points": replaced["launches"],
                             "stereo_kitti": stereo_kitti["launches"],
                             "slam_system_with_mapping_worker": main_path["launches"],
                             "tracker_without_mapper": tracker_alone["launches"],
                             "keyframe_dense_mapped": dense["launches"],
                             "place_recognition": place["launches"],
                             "relocalization": reloc["launches"],
                             "driver_rgbd_tum": drivers["rgbd_tum"]["launches"],
                             "driver_stereo_kitti": drivers["stereo_kitti"]["launches"],
                             "driver_stereo_euroc": drivers["stereo_euroc"]["launches"],
                             "driver_mono_tum": drivers["mono_tum"]["launches"],
                             "vocabulary_corpus": drivers["vocabulary"]["launches"],
                             "multi_session_batched_step": multi["launches"],
                             "ros_node_rgbd_with_viewers": periphery["launches"],
                             "driver_rgbd_tum_viewer": driver_viewer["launches"]},
        # the batched multi-session step's launch over one table of 4
        # sessions' 4 levels (phase 19b; a step makes two)
        "multi_session_16_levels": {**multi.pop("describe"), "launches": multi["launches"],
                                    "launches_per_step": multi["launches_per_step"]},
        "main_path": main_path, "tracker_without_mapper": tracker_alone,
        "keyframe_dense_mapped": dense, "place_recognition": place,
        "relocalization": reloc, "loop_card_vs_cpu": loop,
        "stereo_kitti": stereo_kitti, "stereo_parts": stereo_parts,
        "local_ba_card_vs_cpu": ba_check,
        "mapping_searches_card_vs_cpu": search_check,
        "defaults": {"rgbd": defaults_k1, "rgbd_fetch_batch_4": defaults_k4,
                     "rgbd_repeated": defaults_repeated,
                     "capture_after_drop": capture_after_drop, "stereo": defaults_stereo},
        "localization": localization, "map_reload": reload, "global_ba": gba,
        "backlog": backlog, "mono": mono, "two_view_card_vs_cpu": two_view,
        "mono_loop": mono_loop, "mono_relocalization": mono_reloc,
        "replaced_points": replaced,
        "drivers": drivers, "distributed_gba": gba_parallel, "multi_session": multi,
        "periphery": periphery, "driver_viewer": driver_viewer,
        "frame_programs": programs, "classic_programs": classic,
        "solve_programs": solve_programs}]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
