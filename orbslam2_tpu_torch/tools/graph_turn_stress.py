#!/usr/bin/env python3
"""Whether a caller's profiler stops and device waits between its calls can
meet a CUDA graph launched by another thread.

A thread marked as the port's own (``graph_capture.background()``, as the
mapping worker and a GBA thread are) replays a graph of 400 small kernels in
a loop, on a stream of its own. The main thread plays a caller: a 4 ms call
into the port (``graph_capture.entry()``), then, between calls,
``torch.cuda.synchronize()`` and a ``torch.profiler`` started and stopped,
`--stops` times. With ``gated`` each replay takes a ``graph_capture.turn()``,
as the solve programs' replays on those threads do, so it runs only inside
a call; with ``ungated`` it replays whenever it is ready. Each mode runs in
a subprocess of its own with a time limit (`--timeout` seconds): a mode that
does not end in time hung, and is killed.

    python3 orbslam2_tpu_torch/tools/graph_turn_stress.py [--stops 300] [--timeout 150]

Prints each mode's last lines and, as the last line, one JSON object with
each run's outcome (ended or hung), profiler stops and graph launches.
Needs a GPU; no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))  # the repository root

MODES = ("gated", "ungated", "gated")
KERNELS = 400
CALL_S = 0.004


def run_mode(mode: str, stops: int) -> None:
    """One mode in this process; prints one JSON line when it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orbslam2_tpu_torch.utils import graph_capture

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on a GPU only")
    x = torch.zeros(1 << 16, device="cuda")

    def part():
        for _ in range(KERNELS):
            x.add_(1.0)

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        part()                                        # warm-up
    graph = graph_capture.capture({"g": part}, side)[0]["g"]
    torch.cuda.synchronize()
    stop, launched = threading.Event(), [0]

    def port_thread():
        graph_capture.background()
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            while not stop.is_set():
                if mode == "gated":
                    with graph_capture.turn():
                        graph.replay()
                else:
                    graph.replay()
                launched[0] += 1
                stream.synchronize()

    worker = threading.Thread(target=port_thread, daemon=True)
    worker.start()
    t0 = time.perf_counter()
    for _ in range(stops):
        with graph_capture.entry():
            time.sleep(CALL_S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    stop.set()
    with graph_capture.entry():                       # let a waiting turn end
        worker.join(10)
    print(json.dumps({"mode": mode, "profiler_stops": stops, "graph_launches": launched[0],
                      "seconds": time.perf_counter() - t0}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stops", type=int, default=300)
    ap.add_argument("--timeout", type=float, default=150.0)
    ap.add_argument("--mode", choices=("gated", "ungated"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode:
        run_mode(args.mode, args.stops)
        return
    runs = []
    for mode in MODES:
        cmd = [sys.executable, os.path.abspath(__file__), "--mode", mode,
               "--stops", str(args.stops)]
        try:
            r = subprocess.run(cmd, timeout=args.timeout, capture_output=True, text=True)
            lines = r.stdout.strip().splitlines()
            print(r.stdout[-1000:], r.stderr[-1000:], flush=True)
            ended = r.returncode == 0 and bool(lines)
            runs.append({"mode": mode, "outcome": "ended" if ended else f"rc {r.returncode}",
                         **(json.loads(lines[-1]) if ended else {})})
        except subprocess.TimeoutExpired:
            runs.append({"mode": mode, "outcome": f"hung (killed after {args.timeout} s)"})
        print(f"{mode}: {runs[-1]['outcome']}", flush=True)
    print(json.dumps({"runs": runs}), flush=True)


if __name__ == "__main__":
    main()
