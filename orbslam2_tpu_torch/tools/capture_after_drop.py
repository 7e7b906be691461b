#!/usr/bin/env python3
"""A dropped system's CUDA graphs collected while the next system captures.

    python3 orbslam2_tpu_torch/tools/capture_after_drop.py [--root DIR]
        [--natural N]

A ``torch.cuda.CUDAGraph`` destroyed on a thread that is capturing (its
``reset`` calls ``cudaGraphExecDestroy``, which a ``thread_local`` capture
refuses on its own thread) invalidates that capture: the capture then fails
with ``cudaErrorStreamCaptureInvalidated``. Python's cyclic collector frees
a dropped ``SLAMSystem``'s programs on whatever thread happens to allocate
when it runs, so a second system in one process could fail its first
capture. Two scenarios, each at phase 14's geometry (640x480 / 2000 / 8,
``SLAMConfig``'s defaults):

- ``drop_inside_capture`` (always): a first system is driven until it has
  captured its frame graph and a local-BA solve's graphs; its worker is
  stopped and the system dropped, all but its programs, which the collector
  then frees: the last reference goes inside the next system's first
  capture, under ``gc.set_threshold(1, 1, 1)``, so that the collector runs
  at once on the capturing thread. The capture must succeed and the
  programs must be freed after it.
- ``--natural N``: N more systems are each driven through the 60 frames,
  shut down and dropped, the next built and driven under
  ``gc.set_threshold(1, 1, 1)``, as a user building one system after
  another would.

``--root`` imports ``chip_smoke.py`` and the port from another tree (an
unpacked ``git archive`` of a parent commit). The last line is one JSON
object. Needs a GPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import traceback
import weakref

import torch

WARM_FRAMES = 30     # frames the first system tracks: a frame graph and a local BA
AFTER_FRAMES = 10    # frames the next system tracks


def _programs(system) -> list:
    """The system's programs that hold CUDA graphs (``SLAMSystem.programs``,
    spelt out: a parent tree may not have it)."""
    progs = list(system.tracker.frame_programs.values())
    progs.append(system.local_mapper.ba_program)
    if system.loop_closer is not None:
        progs += [system.loop_closer.eg_program, system.loop_closer.gba_program]
    return progs


def _graph_count(program) -> int:
    held = getattr(program, "_graphs", None)
    if held is not None:
        return len(held)
    return sum(len(c.graphs) for c in program._captured.values())


def drop_inside_capture(make_system, frames, fps) -> dict:
    """The first scenario above. `make_system()` -> a new SLAMSystem;
    `frames`: (gray, depth) pairs of one sequence. -> its readings; raises
    where a gate fails."""
    from orbslam2_tpu_torch.frontend import kernels

    first = make_system()
    n = 0
    while n < len(frames) and (not first.tracker.frame_programs
                               or first.local_mapper.ba_program.captures == 0
                               or n < WARM_FRAMES):
        first.track_rgbd(*frames[n], n / fps)
        n += 1
        if n >= WARM_FRAMES:
            first.wait_mapping_idle(300)
    first.tracker.flush_frames()
    first.wait_mapping_idle(300)
    progs = _programs(first)
    graphs = sum(_graph_count(p) for p in progs)
    if not first.tracker.frame_programs or first.local_mapper.ba_program.captures == 0:
        raise RuntimeError(f"the first system captured no frame graph or no local BA in "
                           f"{n} frames")
    # the worker's thread lets go of the mapper; no shutdown(): the collector,
    # not the system, is to free these graphs
    first.mapping_worker.stop()
    refs = [weakref.ref(p) for p in progs]
    del first
    gc.collect()                    # all of the first system but `progs`
    held = {"progs": progs}
    del progs
    state = dict(dropped_in_capture=False)

    orig_step = kernels.FrameProgram._step

    def step(self, inputs, extra):
        if held and torch.cuda.is_current_stream_capturing():
            # a fresh unreachable cycle: the youngest generation's next
            # collection frees it, and with it the first system's programs
            junk = [held.pop("progs")]
            junk.append(junk)
            del junk
            state["dropped_in_capture"] = True
        return orig_step(self, inputs, extra)

    second = make_system()
    threshold = gc.get_threshold()
    kernels.FrameProgram._step = step
    gc.set_threshold(1, 1, 1)
    error = None
    try:
        for i in range(AFTER_FRAMES):
            second.track_rgbd(*frames[i], i / fps)
        second.tracker.flush_frames()
    except Exception as e:          # noqa: BLE001 - reported and gated below
        error = f"{type(e).__name__}: {e}"[:400]
        traceback.print_exc()
    finally:
        kernels.FrameProgram._step = orig_step
        gc.set_threshold(*threshold)
    gc.collect()
    freed = sum(r() is None for r in refs)
    lost = int(second.tracker.trajectory_lost_mask().sum()) if error is None else None
    captures = sum(p.captures for p in second.tracker.frame_programs.values())
    try:
        second.shutdown()
    except Exception as e:          # noqa: BLE001
        error = error or f"shutdown: {type(e).__name__}: {e}"[:400]
    out = dict(graphs_dropped=graphs, programs_dropped=len(refs), programs_freed=freed,
               dropped_in_capture=state["dropped_in_capture"], capture_error=error,
               next_captures=captures, next_frames_lost=lost, warm_frames=n)
    out["ok"] = (error is None and state["dropped_in_capture"] and freed == len(refs)
                 and captures >= 1 and lost == 0)
    return out


def natural_drops(make_system, frames, fps, n_systems) -> dict:
    """The second scenario above. -> its readings."""
    threshold = gc.get_threshold()
    errors = []
    done = 0
    gc.set_threshold(1, 1, 1)
    try:
        for k in range(n_systems):
            system = make_system()
            try:
                for i, (gray, depth) in enumerate(frames):
                    system.track_rgbd(gray, depth, i / fps)
                system.shutdown()
                done += 1
            except Exception as e:  # noqa: BLE001 - counted
                errors.append(f"system {k}: {type(e).__name__}: {e}"[:400])
                traceback.print_exc()
            del system
    finally:
        gc.set_threshold(*threshold)
    return dict(systems=n_systems, completed=done, errors=errors)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the tree to import (default: this repository)")
    p.add_argument("--natural", type=int, default=0, metavar="N",
                   help="also drive N systems one after another, each dropped")
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("capture_after_drop.py needs a GPU")
    sys.path.insert(0, os.path.abspath(a.root))
    import chip_smoke
    from orbslam2_tpu_torch.ops import cuda_orb
    from orbslam2_tpu_torch.slammap import native

    cuda_orb.build_kernels(force=True)
    native.build(force=True)
    cam = chip_smoke.PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                                   width=640, height=480, bf=40.0)
    orb_cfg = chip_smoke.orb.ORBConfig(n_features=2000, n_levels=8)
    seq = chip_smoke.SyntheticSequence(cam, n_frames=chip_smoke.N_FRAMES,
                                       trajectory="shuttle", seed=3, world="cluttered")
    frames = [seq.render(i) for i in range(chip_smoke.N_FRAMES)]

    def make_system():
        return chip_smoke.SLAMSystem(chip_smoke.defaults_config(cam, orb_cfg),
                                     chip_smoke.Sensor.RGBD)

    result = {"root": os.path.abspath(a.root)}
    try:
        result["drop_inside_capture"] = drop_inside_capture(make_system, frames, seq.fps)
    except Exception as e:          # noqa: BLE001 - reported
        traceback.print_exc()
        result["drop_inside_capture"] = dict(ok=False, error=f"{type(e).__name__}: {e}"[:400])
    print(f"drop inside capture: {result['drop_inside_capture']}", flush=True)
    if a.natural:
        result["natural"] = natural_drops(make_system, frames, seq.fps, a.natural)
        print(f"natural drops: {result['natural']}", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
