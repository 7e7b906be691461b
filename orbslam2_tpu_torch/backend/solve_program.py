"""The backend solves as programs: local BA, global BA and the essential
graph, each a set of CUDA graphs of its parts, the LM step replayed once per
step.

Counterpart of the JAX package's jitted ``bundle_adjust``,
``bundle_adjust_pcg`` (``backend/ba.py``) and ``optimize_essential_graph``
(``backend/pose_graph.py``), whose LM loops are ``lax.scan`` over a step
compiled once. A program captures each part of its solve once per key (the
shapes and dtypes of the inputs and the solve's settings, as ``jax.jit``
traces once per shape and static argument): for BA the reset, the prologue
and the step of the Huber phase and of the plain phases, and the epilogue
(``ba._RobustLM``); for the essential graph its setup and its step
(``pose_graph._EssentialGraph``). A solve copies its inputs into the graphs'
buffers, replays the parts in the solve's order with no host read between
them, and returns copies of the state tensors.

Only the step is captured, not the whole solve: an unrolled essential graph
would be one graph of about 58 000 nodes, which takes seconds to capture,
under the loop closer's map lock the first time. A step graph holds about a
twentieth of that and is replayed once per LM step.

On the CPU a program is the eager solve (the module functions, looked up at
each call). On a card the first solve for a key warms each part up on the
program's own side stream (library handles and workspaces are made outside
the capture), captures the parts there through ``utils/graph_capture.py``
(``thread_local``: the tracker and the other solves go on launching work
on their threads meanwhile; on the mapping worker's or a GBA thread the
capture waits until a caller is inside one of the port's calls, since a
caller may wait for the whole device between its calls), then replays. A
capture or a replay that fails raises; nothing falls back to the eager
solve. A replay's graph launches on those threads likewise wait for a
caller's call (a profiler stopped between calls hung once while the worker
launched a graph). A program's buffers are not reentrant: a solve holds the program's
lock from copy-in to clone-out, so two global BAs on two threads take
turns, and the lock is never held while waiting for the map lock. The
distributed BA (``parallel/dist_ba.py``) stays eager: its all-reduces
cannot be captured.

``release()`` frees a program's graphs after its last solve's replay, under
``utils/graph_capture.py``'s rules (``SLAMSystem.shutdown`` releases every
program of the system); a later solve captures again. Each program counts
``captures`` (keys captured), ``replays`` (solves replayed) and
``graph_launches``, and keeps for each capture its
milliseconds (``capture_ms``), the milliseconds it waited for a caller's
call (``held_ms``) and the thread that captured (``capture_threads``), and
for each replay the milliseconds its launches waited (``replay_held_ms``).
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
from typing import Tuple

import torch

from orbslam2_tpu_torch.backend import ba, pose_graph
from orbslam2_tpu_torch.backend.ba import BAProblem, BAResult
from orbslam2_tpu_torch.utils import graph_capture


@dataclasses.dataclass
class _Captured:
    """The graphs of one key: their input buffers, each part's graph, the
    parts one solve replays in order, the state tensors it returns, and the
    parts themselves, whose objects own every state tensor the graphs read
    and write (made outside the capture, so the allocator would hand a
    dropped one to other tensors while the graphs still write it)."""
    inputs: list
    graphs: dict
    schedule: list
    outputs: tuple
    parts: dict


def _signature(flat) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in flat)


class _Program:
    """Capture and replay, shared by the solve programs. A subclass gives
    the inputs as one list of tensors and `build(inputs) -> (parts,
    schedule, outputs)`: the parts as named callables over buffers made
    from `inputs`, the names one solve runs in order, and the state
    tensors it returns."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._captured: dict = {}
        self._stream = None
        self._pool = None
        self._done = None
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.graph_launches = 0
        self.capture_ms: list = []
        self.held_ms: list = []
        self.replay_held_ms: list = []
        self.capture_threads: list = []

    def release(self) -> None:
        """Free every key's graphs after the last solve's replay
        (``graph_capture.release``); the next solve of a key captures again,
        into a new memory pool."""
        with self._lock:
            captured, self._captured = self._captured, {}
            graph_capture.release(
                [g for c in captured.values() for g in c.graphs.values()], self._done)
            self._pool = None

    def _run(self, key, flat, build) -> tuple:
        with self._lock, torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            if self._done is None:
                self._done = torch.cuda.Event()
            else:
                # the last solve may have run on another thread's stream
                current.wait_event(self._done)
            captured = self._captured.get(key)
            if captured is None:
                captured = self._capture(key, flat, build)
            else:
                for dst, src in zip(captured.inputs, flat):
                    dst.copy_(src)
            with graph_capture.turn() as held_ms:
                for name in captured.schedule:
                    captured.graphs[name].replay()
            self.replay_held_ms.append(held_ms)
            self.graph_launches += len(captured.schedule)
            self.replays += 1
            out = tuple(x.clone() for x in captured.outputs)
            self._done.record(current)
            return out

    def _capture(self, key, flat, build) -> _Captured:
        # buffers on the current stream, which replays them
        inputs = [x.clone() for x in flat]
        parts, schedule, outputs = build(inputs)
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
        side, current = self._stream, torch.cuda.current_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for part in parts.values():      # warm-up
                part()
        graphs, held_ms, capture_ms = graph_capture.capture(parts, side, self._pool)
        current.wait_stream(side)
        self.held_ms.append(held_ms)
        self.capture_ms.append(capture_ms)
        self.capture_threads.append(threading.current_thread().name)
        captured = _Captured(inputs, graphs, schedule, outputs, parts)
        self._captured[key] = captured
        self.captures += 1
        return captured


class BundleAdjustProgram(_Program):
    """``ba.bundle_adjust`` (local BA, the dense Schur solve) or, with
    `pcg=True`, ``ba.bundle_adjust_pcg`` (global BA) as a program, called
    with that function's arguments (on one device: `reduce` stays
    ``ba._local``)."""

    def __init__(self, device, pcg: bool = False):
        super().__init__(device)
        self.pcg = pcg

    def _eager(self):
        return ba.bundle_adjust_pcg if self.pcg else ba.bundle_adjust

    def key(self, *args, **kw) -> tuple:
        """What a capture depends on: the inputs' shapes and dtypes, the
        camera and the solve's settings."""
        a = _bind(_BA_SIGNATURES[self.pcg], args, kw)
        return self._key(a, self._flat(a))

    def _key(self, a, flat) -> tuple:
        if a.get("reduce", ba._local) is not ba._local:
            raise ValueError("a distributed BA (reduce) cannot be a program")
        return (self.pcg, _signature(flat), a["cam"], tuple(a["phase_iters"]), a["lam0"],
                a.get("pcg_iters"))

    def __call__(self, *args, **kw) -> BAResult:
        if self.device.type != "cuda":
            return self._eager()(*args, **kw)
        a = _bind(_BA_SIGNATURES[self.pcg], args, kw)
        flat = self._flat(a)
        return BAResult(*self._run(self._key(a, flat), flat,
                                   functools.partial(self._build, a=a)))

    @staticmethod
    def _flat(a) -> list:
        """The problem's tensors (indices as int64) and `point_fixed`."""
        problem, fixed = a["problem"], a["point_fixed"]
        if fixed is None:
            fixed = torch.zeros(problem.points.shape[0], dtype=torch.bool,
                                device=problem.points.device)
        return [*problem._replace(obs_cam=problem.obs_cam.long(),
                                  obs_pt=problem.obs_pt.long()), fixed]

    def _build(self, inputs, a):
        problem, cam = BAProblem(*inputs[:-1]), a["cam"]
        if self.pcg:
            solve = ba._pcg_solve(cam, problem.poses.shape[0], problem.points.shape[0],
                                  a["pcg_iters"])
        else:
            solve = ba._dense_solve(cam)
        lm = ba._RobustLM(problem, cam, inputs[-1], a["lam0"], solve)
        parts = {"reset": lm.reset}
        schedule = ["reset"]
        for phase, iters in enumerate(a["phase_iters"]):
            huber = phase == 0
            name = "huber" if huber else "plain"
            parts.setdefault(f"prologue_{name}", functools.partial(lm.prologue, huber))
            parts.setdefault(f"step_{name}", functools.partial(lm.step, huber))
            parts.setdefault("epilogue", lm.epilogue)
            schedule += [f"prologue_{name}"] + [f"step_{name}"] * iters + ["epilogue"]
        return parts, schedule, (lm.poses, lm.points, lm.active, lm.cost)


class EssentialGraphProgram(_Program):
    """``pose_graph.optimize_essential_graph`` as a program, called with its
    arguments."""

    def key(self, *args, **kw) -> tuple:
        """What a capture depends on: the inputs' shapes and dtypes and the
        solve's settings."""
        a = _bind(_EG_SIGNATURE, args, kw)
        return self._key(a, self._flat(a))

    @staticmethod
    def _key(a, flat) -> tuple:
        return _signature(flat), a["fix_scale"], a["iters"]

    def __call__(self, *args, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.device.type != "cuda":
            return pose_graph.optimize_essential_graph(*args, **kw)
        a = _bind(_EG_SIGNATURE, args, kw)
        flat = self._flat(a)

        def build(inputs):
            graph = pose_graph._EssentialGraph(*inputs, a["fix_scale"])
            return ({"setup": graph.setup, "step": graph.step},
                    ["setup"] + ["step"] * a["iters"], (graph.p, graph.c))

        return self._run(self._key(a, flat), flat, build)

    @staticmethod
    def _flat(a) -> list:
        poses = a["poses"]
        return [poses, a["kf_valid"], a["kf_fixed"], a["edges_i"].long(),
                a["edges_j"].long(), a["edges_meas"].to(poses.dtype), a["edges_valid"]]


def _bind(signature: inspect.Signature, args, kw) -> dict:
    bound = signature.bind(*args, **kw)
    bound.apply_defaults()
    return bound.arguments


# the eager functions' signatures, taken once: a wrapper put in their place
# (a test's spy) changes what the CPU path calls, not how a call is read
_BA_SIGNATURES = {False: inspect.signature(ba.bundle_adjust),
                  True: inspect.signature(ba.bundle_adjust_pcg)}
_EG_SIGNATURE = inspect.signature(pose_graph.optimize_essential_graph)
