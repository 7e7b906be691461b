"""Per-stage timing instrumentation, and a kernel's own time on the card.

Own copy of the ``StageTimer`` of ``orbslam2_tpu/utils/profiling.py``:
named-stage wall-clock statistics (median/mean/p95), usable as a context
manager around pipeline stages. The tracker carries one as ``tracker.stats``
(off by default; enable with ``SLAMConfig.profile_stages``). Stages time the
host clock: work queued on a CUDA device is included only where the stage
ends in a fetch or a synchronisation.

``device_trace`` writes a Chrome trace of everything run in its scope
(``torch.profiler``; the drivers' ``--device-trace``). ``event_ms``,
``kernel_device_ms`` and ``queued_ms`` time work on a CUDA device (``torch``
is imported inside them). ``event_ms`` is paced by the host
wherever the host sends work more slowly than the card finishes it; the
other two give the card's own time; ``kernel_device_ms`` can flush the L2
cache before every call.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


class StageTimer:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "n": int(a.size),
                "median_ms": float(np.median(a) * 1e3),
                "mean_ms": float(a.mean() * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        rows = sorted(self.summary().items(),
                      key=lambda kv: -kv[1]["total_s"])
        if not rows:
            return "(no stage samples)"
        lines = [f"{'stage':<24}{'n':>6}{'median':>9}{'mean':>9}{'p95':>9}{'total':>9}"]
        for name, s in rows:
            lines.append(f"{name:<24}{s['n']:>6}{s['median_ms']:>8.1f}m"
                         f"{s['mean_ms']:>8.1f}m{s['p95_ms']:>8.1f}m"
                         f"{s['total_s']:>8.2f}s")
        return "\n".join(lines)

    def reset(self) -> None:
        self.samples.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` over the scope: host (CPU) activity, and the CUDA
    device's where a card is present; on exit a Chrome trace
    ``trace_<pid>_<ns>.json`` (chrome://tracing, Perfetto) is written into
    ``log_dir``. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn``, by CUDA events around a loop of
    ``reps`` calls, after a warm-up. Host-paced for short kernels."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


L2_FLUSH_BYTES = 256 << 20   # over five times the H100's 50 MB L2


def kernel_device_ms(fn, reps: int, kernel_name: str, tries: int = 3,
                     flush_l2: bool = False):
    """Mean device milliseconds of one kernel whose name contains
    ``kernel_name``, over ``reps`` calls of ``fn``: its durations as
    ``torch.profiler`` traced them on the card. -> (ms per kernel, kernels
    traced); (None, 0) where no trace of ``tries`` held device time for the
    name. The trace may drop events, so the caller multiplies by the launches
    it knows a call makes rather than trusting the count.

    With ``flush_l2`` every call follows a write of ``L2_FLUSH_BYTES``, so
    that the kernel finds its inputs in device memory and not in L2 (the
    write's own kernel has another name and is not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4 if flush_l2 else 0, dtype=torch.float32,
                        device="cuda")
    for _ in range(3):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush_l2:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for e in prof.key_averages():
            if kernel_name in e.key and e.device_type.name != "CPU":
                total_us += getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0.0))
                count += e.count
        if count > 0 and total_us > 0.0:
            return total_us / count / 1e3, count
    return None, 0


def device_activity(fn):
    """One call of ``fn`` under ``torch.profiler``. -> (kernel launches the
    host made, operations the card ran (kernels, copies, fills), the sum of
    their device milliseconds, the call's wall milliseconds). The device sum
    over the wall time is the share of the call the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ops = 0
    device_us = 0.0
    for e in prof.key_averages():
        if e.device_type.name == "CPU":
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                         "cuLaunchKernelEx"):
                launches += e.count
        else:
            ops += e.count
            device_us += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    return launches, ops, device_us / 1e3, wall_ms


def queued_ms(fn, reps: int, hold_cycles: int = 100_000_000) -> float:
    """Device milliseconds per call of ``fn`` without the host's pace: the
    calls are queued behind a spin kernel of ``hold_cycles`` clock cycles
    (about 50 ms) that outlasts their sending, so the events around them see
    the card run them back to back. Includes the gaps between launches.
    Raises if the host took longer to send the calls than the spin lasted."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(hold_cycles)
    end.record()
    torch.cuda.synchronize()
    hold_ms = start.elapsed_time(end)

    t0 = time.perf_counter()
    torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    send_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if send_ms >= hold_ms:
        raise RuntimeError(f"the host took {send_ms:.2f} ms to send {reps} calls, "
                           f"the spin kernel held the card {hold_ms:.2f} ms")
    return start.elapsed_time(end) / reps
