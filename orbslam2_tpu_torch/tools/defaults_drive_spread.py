#!/usr/bin/env python3
"""The spread of chip_smoke.py phase 14's defaults drive over repeated drives
on one card, with a record of every frame.

    python3 orbslam2_tpu_torch/tools/defaults_drive_spread.py [RUNS] [--root DIR]
        [--set KEY=VALUE ...] [--out FILE] [--tag TAG]

Phase 14's first drive (phase 5's 60 frames at 640x480 / 2000 / 8 with every
``SLAMConfig`` default: the pipelined fetch, the mapping worker) is driven
RUNS times (default 6) in this process, each with a new SLAMSystem, through
the script's own ``drive_defaults_rgbd`` with its ATE gate switched off, so
that a drive that ends far off is counted instead of ending the run. The
drive depends on the order in which the worker and the tracker meet, so its
ATE spreads. ``--root`` imports ``chip_smoke.py`` and the port from another
tree (an unpacked ``git archive`` of a parent commit), to compare two trees
on one card. ``--set fetch_batch=4`` (or ``async_mapping=false``,
``pipelined_fetch=false``, ...) changes one ``SLAMConfig`` field of every
drive. ``--hold-ba KF@FRAME`` forces one order of the worker and the
tracker: the local BA of keyframe slot KF is written back after frame FRAME
is dispatched and before frame FRAME + 1 is (the worker waits after its
solve, the tracker before that dispatch), so that FRAME + 1 is dispatched
chained off a frame solved against the map before the BA moved it.

Every applied frame is recorded (the tracker's and the local mapper's methods
are wrapped for this process; nothing of the port changes): the position
error of the live pose at apply and of the pose ``full_trajectory_twc``
rebuilds at the end, both against the ground truth anchored at the first
tracked frame; the state; the motion model's matches and inliers and the
final inliers; whether the frame was tracked again, built again or
revalidated; whether its dispatch chained off a frame in flight; ``ref_kf``;
and the keyframes, local BAs (written back or dropped, with the largest
keyframe move), fuses and culls that landed since the frame before. Each
drive prints one line with its ATE and the first frame whose live and
rebuilt poses are past 0.05 and 0.10 m; ``--out`` writes every drive's
records as one JSON line each. A drive that raises (a failed capture) is
counted and the run goes on; so is a drive that fails one of the script's
gates (a frame lost), with its records. The last line is one JSON object.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import threading
import time
import traceback

import numpy as np
import torch

FAR_M = 0.10
NEAR_M = 0.05


class GateFailed(Exception):
    """A gate of chip_smoke.py's drive failed (its fail(), raised here)."""


def _parse_set(items) -> dict:
    out = {}
    for item in items:
        key, _, raw = item.partition("=")
        low = raw.strip().lower()
        if low in ("true", "false"):
            out[key] = low == "true"
        elif low == "none":
            out[key] = None
        else:
            try:
                out[key] = int(raw)
            except ValueError:
                out[key] = float(raw)
    return out


class Recorder:
    """Per-frame records of the drive in progress, from wrapped methods of
    the tracker, the local mapper and the map (installed once per process,
    recording only while a drive is on)."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.events: list = []
        self.frames: list = []
        self.dispatch: dict = {}
        self.apply_info: dict = {}
        self.t0 = time.perf_counter()
        self.hold = None                # (keyframe slot, frame) of --hold-ba
        self.hold_state: dict = {}

    def start(self) -> None:
        self.on = True
        self.events, self.frames = [], []
        self.dispatch, self.apply_info = {}, {}
        self.t0 = time.perf_counter()
        self.hold_state = dict(dispatched=threading.Event(), written=threading.Event(),
                               forced=False)

    def event(self, kind, **kw) -> None:
        if not self.on:
            return
        with self.lock:
            t_ms = round((time.perf_counter() - self.t0) * 1e3, 3)
            self.events.append(dict(kind=kind, t_ms=t_ms,
                                    thread=threading.current_thread().name, **kw))

    def install(self, tracking, local_mapping, mapstate, solve_program) -> None:
        rec = self
        Tracker, LocalMapper, MapState = tracking.Tracker, local_mapping.LocalMapper, \
            mapstate.MapState
        hold_wait_s = 30.0
        local = threading.local()

        def wrap(cls, name, before=None, after=None):
            orig = getattr(cls, name)

            @functools.wraps(orig)
            def inner(self, *a, **kw):
                ctx = before(self, *a, **kw) if (before and rec.on) else None
                out = orig(self, *a, **kw)
                if after and rec.on:
                    after(self, ctx, out, *a, **kw)
                return out
            setattr(cls, name, inner)

        def dispatch_before(tr, kind, imgs_d, timestamp, frame_id=None, chain_off_pipe=True):
            if rec.hold is not None and frame_id is None \
                    and tr.frame_counter == rec.hold[1] + 1:
                # the held BA lands before this dispatch
                rec.hold_state["written"].wait(hold_wait_s)
            chained = bool(chain_off_pipe and (tr._pending or tr._inflight))
            return dict(chained=chained, again=frame_id is not None,
                        last_applied=None if tr.last_frame is None else tr.last_frame.frame_id,
                        kf_frame=tr.last_kf_frame_id)

        def dispatch_after(tr, ctx, out, *a, **kw):
            fid = out["frame_id"]
            if rec.hold is not None and fid == rec.hold[1]:
                rec.hold_state["dispatched"].set()
            rec.dispatch.setdefault(fid, []).append(ctx)
            rec.event("dispatch", frame=fid, **ctx)

        def fused_apply_before(tr, r, fetched):
            rec.apply_info[r["frame_id"]] = dict(mm_matches=int(fetched[4]),
                                                 mm_inliers=int(fetched[5]),
                                                 fused_inliers=int(fetched[6]))

        def record_after(tr, ctx, out, fr, lost):
            counts = (tr.retracked_frames, tr.rebuilt_frames, tr.revalidated_frames)
            prev = rec.frames[-1]["_counts"] if rec.frames else (0, 0, 0)
            with rec.lock:
                events, rec.events = rec.events, []
            rec.frames.append(dict(
                frame=int(fr.frame_id), lost=bool(lost), state=tr.state.name,
                tcw=np.asarray(fr.tcw, np.float64).tolist(), ref_kf=int(tr.ref_kf),
                inliers=int(tr.matches_inliers), **rec.apply_info.pop(fr.frame_id, {}),
                tracked_again=counts[0] - prev[0], built_again=counts[1] - prev[1],
                revalidated=counts[2] - prev[2],
                chained=[d["chained"] for d in rec.dispatch.pop(fr.frame_id, [])],
                keyframes=int(tr.map.n_keyframes()), events=events, _counts=counts))

        def new_kf_after(tr, ctx, out, fr):
            rec.event("keyframe", frame=int(fr.frame_id), kf=int(tr.ref_kf))

        def retrack_before(tr, r):
            rec.event("tracked_again", frame=int(r["frame_id"]))

        def process_kf_before(lm, kf, backlog=False):
            rec.event("map_kf_start", kf=int(kf), backlog=bool(backlog))
            return dict(lm.counts)

        def process_kf_after(lm, before, out, kf, backlog=False):
            diff = {k: v - before[k] for k, v in lm.counts.items() if v != before[k]}
            rec.event("map_kf_end", kf=int(kf), **diff)

        def ba_apply_before(lm, apply_ctx, new_poses, new_points, inlier):
            cam_slot, cam_fixed = apply_ctx[0], apply_ctx[1]
            moved = {}
            for c, i in cam_slot.items():
                if not cam_fixed[i] and lm.map.kf_valid[c]:
                    a = np.linalg.inv(lm.map.kf_pose[c])[:3, 3]
                    b = np.linalg.inv(new_poses[i])[:3, 3]
                    moved[int(c)] = float(np.linalg.norm(a - b))
            rec.event("local_ba_write",
                      moved_m={k: round(v, 4) for k, v in sorted(moved.items())},
                      max_move_m=max(moved.values(), default=0.0))

        def local_ba_before(lm, kf, w):
            local.kf = int(kf)
            return lm.counts["ba_dropped"]

        def ba_solved(prog, ctx, out, *a, **kw):
            if rec.hold is not None and getattr(local, "kf", None) == rec.hold[0] \
                    and not rec.hold_state["written"].is_set():
                # written back once FRAME is dispatched (map lock not held)
                rec.hold_state["forced"] = not rec.hold_state["dispatched"].is_set()
                rec.hold_state["dispatched"].wait(hold_wait_s)

        def ba_written(lm, ctx, out, *a, **kw):
            if rec.hold is not None and getattr(local, "kf", None) == rec.hold[0]:
                rec.hold_state["written"].set()

        def local_ba_after(lm, dropped, out, kf, w):
            if lm.counts["ba_dropped"] != dropped:
                rec.event("local_ba_dropped", kf=int(kf))

        def replace_before(m, pairs):
            rec.event("fuse", merged=len(pairs))

        def erase_kf_before(m, kf):
            rec.event("cull", kf=int(kf))

        wrap(Tracker, "_fused_dispatch", dispatch_before, dispatch_after)
        wrap(Tracker, "_fused_apply", fused_apply_before)
        wrap(Tracker, "_record_trajectory", after=record_after)
        wrap(Tracker, "_create_new_keyframe", after=new_kf_after)
        wrap(Tracker, "_retrack_sync", retrack_before)
        wrap(LocalMapper, "process_keyframe", process_kf_before, process_kf_after)
        wrap(LocalMapper, "_local_ba_apply", ba_apply_before, ba_written)
        wrap(LocalMapper, "_local_ba", local_ba_before, local_ba_after)
        wrap(solve_program.BundleAdjustProgram, "__call__", after=ba_solved)
        wrap(MapState, "replace_points", replace_before)
        wrap(MapState, "erase_keyframe", erase_kf_before)


def _errors(twc: np.ndarray, gt_twc: np.ndarray, first: int) -> np.ndarray:
    """Position error of each pose against the ground truth, both anchored
    at frame `first` (the estimate moved rigidly onto the truth there)."""
    align = gt_twc[first] @ np.linalg.inv(twc[first])
    est = np.einsum("ij,njk->nik", align, twc)
    return np.linalg.norm(est[:, :3, 3] - gt_twc[:, :3, 3], axis=1)


def _first_past(err: np.ndarray, frames: list, limit: float):
    past = np.flatnonzero(err > limit)
    return int(frames[past[0]]) if len(past) else None


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("runs", type=int, nargs="?", default=6)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the tree to import (default: this repository)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="a SLAMConfig field of every drive (repeatable)")
    p.add_argument("--out", help="write each drive's frame records as a JSON line here")
    p.add_argument("--tag", default="", help="a name printed on every line")
    p.add_argument("--hold-ba", metavar="KF@FRAME",
                   help="write keyframe KF's local BA back between the dispatches of "
                        "FRAME and FRAME + 1")
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("defaults_drive_spread.py measures phase 14 on a GPU only")
    sys.path.insert(0, os.path.abspath(a.root))
    import chip_smoke
    from orbslam2_tpu_torch.backend import solve_program
    from orbslam2_tpu_torch.frontend import local_mapping, tracking
    from orbslam2_tpu_torch.ops import cuda_orb
    from orbslam2_tpu_torch.slammap import mapstate, native

    cuda_orb.build_kernels(force=True)
    native.build(force=True)
    chip_smoke.ATE_MAX_M = float("inf")

    def gate(msg):                   # a failed gate ends the drive, not the run
        raise GateFailed(msg)

    chip_smoke.fail = gate
    made = []
    make_system = chip_smoke.SLAMSystem

    def making(*args, **kw):
        made.append(make_system(*args, **kw))
        return made[-1]

    chip_smoke.SLAMSystem = making
    overrides = _parse_set(a.set)
    rec = Recorder()
    rec.install(tracking, local_mapping, mapstate, solve_program)
    if a.hold_ba:
        rec.hold = tuple(int(x) for x in a.hold_ba.split("@"))
    cam = chip_smoke.PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                                   width=640, height=480, bf=40.0)
    orb_cfg = chip_smoke.orb.ORBConfig(n_features=2000, n_levels=8)
    seq = chip_smoke.SyntheticSequence(cam, n_frames=chip_smoke.N_FRAMES,
                                       trajectory="shuttle", seed=3, world="cluttered")
    frames = [seq.render(i) for i in range(chip_smoke.N_FRAMES)]
    gt_twc = np.stack([np.linalg.inv(seq.poses[i]) for i in range(chip_smoke.N_FRAMES)])
    out_file = open(a.out, "a") if a.out else None
    runs = []
    tag = a.tag or os.path.basename(os.path.abspath(a.root))
    for k in range(a.runs):
        rec.start()
        made.clear()
        failed_gate = None
        try:
            chip_smoke.drive_defaults_rgbd(
                "defaults", chip_smoke.defaults_config(cam, orb_cfg, **overrides), frames, seq)
        except GateFailed as e:
            failed_gate = str(e)
        except Exception as e:                       # noqa: BLE001 - counted, run goes on
            rec.on = False
            runs.append(dict(error=f"{type(e).__name__}: {e}"[:300]))
            print(f"[{tag}] run {k}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)
            traceback.print_exc()
            continue
        rec.on = False
        system = made[-1]
        tracker = system.tracker
        system.shutdown()
        rebuilt = tracker.full_trajectory_twc()
        lost = tracker.trajectory_lost_mask()
        frs = rec.frames
        ids = [f["frame"] for f in frs]
        live = np.stack([np.linalg.inv(np.array(f["tcw"])) for f in frs])
        first = int(np.flatnonzero(~lost)[0])
        i_first = ids.index(first)
        err_live = _errors(live, gt_twc[ids], i_first)
        err_rebuilt = _errors(rebuilt, gt_twc, first)[ids]
        for f, el, er in zip(frs, err_live, err_rebuilt):
            f.update(err_live_m=float(el), err_rebuilt_m=float(er))
            f.pop("_counts")
            f.pop("tcw")
        ate = chip_smoke.ate_rmse(rebuilt[first:], gt_twc[first:len(rebuilt)])
        summary = dict(
            failed_gate=failed_gate, lost_frames=np.flatnonzero(lost).tolist(),
            held_ba=rec.hold_state["written"].is_set() if rec.hold else None,
            hold_forced=rec.hold_state["forced"] if rec.hold else None,
            ate_m=ate, tracked=int((~lost).sum()), keyframes=int(system.map.n_keyframes()),
            retracked_frames=tracker.retracked_frames, rebuilt_frames=tracker.rebuilt_frames,
            remapped_ids=tracker.remapped_ids,
            first_live_past_010=_first_past(err_live, ids, FAR_M),
            first_rebuilt_past_010=_first_past(err_rebuilt, ids, FAR_M),
            first_live_past_005=_first_past(err_live, ids, NEAR_M),
            first_rebuilt_past_005=_first_past(err_rebuilt, ids, NEAR_M),
            max_live_m=float(err_live.max()), max_rebuilt_m=float(err_rebuilt.max()))
        runs.append(summary)
        print(f"[{tag}] run {k}: ATE {ate:.4f} m, {summary['tracked']} tracked (lost "
              f"{summary['lost_frames']}), {summary['keyframes']} keyframes, "
              f"{summary['retracked_frames']} tracked again; "
              f"first live/rebuilt past {FAR_M} m: {summary['first_live_past_010']}/"
              f"{summary['first_rebuilt_past_010']}, past {NEAR_M} m: "
              f"{summary['first_live_past_005']}/{summary['first_rebuilt_past_005']}; "
              f"max live {summary['max_live_m']:.4f} m, rebuilt {summary['max_rebuilt_m']:.4f} m"
              f"; BA held {summary['held_ba']} (waited {summary['hold_forced']}), "
              f"{summary['rebuilt_frames']} built again; gate {failed_gate}", flush=True)
        if out_file is not None:
            out_file.write(json.dumps(dict(tag=tag, run=k, set=overrides, **summary,
                                           frames=frs)) + "\n")
            out_file.flush()
        del system
    far = sum(1 for r in runs if r.get("ate_m", 0.0) > FAR_M)
    failed = sum(1 for r in runs if "error" in r)
    gated = sum(1 for r in runs if r.get("failed_gate"))
    print(json.dumps({"root": os.path.abspath(a.root), "tag": tag, "set": overrides,
                      "drives": len(runs), "far": far, "failed": failed, "failed_gate": gated,
                      "ate_m": [r.get("ate_m") for r in runs], "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
