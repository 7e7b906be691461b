"""CUDA graph capture and replay beside other threads, and when each may run.

A wait for the whole device (``torch.cuda.synchronize()``, and
``torch.profiler`` as it stops, which calls it) fails with "operation not
permitted when stream is capturing" while any stream of the process is
capturing a CUDA graph, whichever thread captures.
``capture_error_mode="thread_local"`` lets the other threads launch work
and copy, not wait for the device. And a profiler's stop on one thread hung
for good (its wait for the device never returned) while another thread
launched a graph (``CUDAGraph.replay``).

So the port keeps two rules, both here:

- ``capture`` is the one way the port captures (the tracker's frame
  programs, ``frontend/kernels.py``; the solve programs,
  ``backend/solve_program.py``). It captures with ``capture_begin`` and
  ``capture_end``, which wait for nothing: ``torch.cuda.graph`` would wait
  for the whole device first, and so break a capture on another thread.
  No code of the port waits for the whole device.
- A caller of the port may wait for the whole device, or start and stop a
  profiler, between its calls. So a capture or a replay on a thread the
  port started (``background()``: the mapping worker, a global-BA thread)
  takes a ``turn()``: it waits until a caller is inside one of the port's
  calls (``entry()``: the tracker's track calls and ``flush_frames``, the
  system's methods, the worker's queue and waits), and that call does not
  return before the turn has ended. A turn on any other thread is its
  caller's own, inside its call, and runs at once.

A turn holds no lock of the port and waits for nothing but the interpreter,
so a call may wait for one whatever it holds.

No graph is destroyed inside a capture. A ``torch.cuda.CUDAGraph`` frees its
executable graph when it is reset or collected (``cudaGraphExecDestroy``),
which a ``thread_local`` capture refuses on its own thread: the capture is
invalidated and fails ("operation failed due to a previous error during
capture"). Python's cyclic collector runs on whichever thread allocates when
it is due, so it could free a dropped system's programs on a thread that is
capturing. So the collector is off while any capture of the process is open
(its state comes back when the last one closes, on error too), and a
program's graphs are freed by ``release``: after their last replay has run,
in a turn, and while no capture is open (``SLAMSystem.shutdown`` releases
every program of the system).
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Tuple

_state = threading.Condition()
_calls = 0          # callers inside a call of the port
_waiting = 0        # turns on the port's threads waiting for a call
_captures = 0       # turns running
_open = 0           # captures open (the collector is off while any is)
_collector_was_on = False
_thread = threading.local()


def background() -> None:
    """Marks the current thread as one the port started: its turns wait for
    a caller's call."""
    _thread.background = True


@contextlib.contextmanager
def entry():
    """A caller's call into the port (also a decorator, ``@entry()``):
    turns on the port's own threads run while it is open. The last call to
    close lets every turn waiting for a call run, and waits for them to
    end, before it returns."""
    global _calls
    with _state:
        _calls += 1
        _state.notify_all()
    try:
        yield
    finally:
        with _state:
            if _calls == 1:
                while _waiting or _captures:
                    _state.wait()
            _calls -= 1


@contextlib.contextmanager
def turn():
    """A capture's or a replay's turn under the rules above. -> (yields) the
    milliseconds it waited for a caller's call."""
    global _waiting, _captures
    t0 = time.perf_counter()
    with _state:
        if getattr(_thread, "background", False):
            _waiting += 1
            try:
                while not _calls:
                    _state.wait()
            finally:
                _waiting -= 1
        _captures += 1
    try:
        yield (time.perf_counter() - t0) * 1e3
    finally:
        with _state:
            _captures -= 1
            _state.notify_all()


@contextlib.contextmanager
def _collector_off():
    """No automatic collection while the block runs on any thread; the
    collector's state before the first open block comes back when the last
    one closes, whatever the block raised."""
    global _open, _collector_was_on
    with _state:
        if _open == 0:
            _collector_was_on = gc.isenabled()
            gc.disable()
        _open += 1
    try:
        yield
    finally:
        with _state:
            _open -= 1
            if _open == 0:
                if _collector_was_on:
                    gc.enable()
                _state.notify_all()


def capture(parts: Dict[str, Callable[[], object]], stream, pool=None
            ) -> Tuple[dict, float, float]:
    """Each of `parts` captured as one ``torch.cuda.CUDAGraph`` on `stream`
    (into the memory pool `pool`, a new one when None), in order, under
    the rules above. The caller has warmed each part up on `stream`, so that
    library handles and workspaces exist before the capture.
    -> (the graphs by name, the ms the capture waited for a caller's call,
    the ms it took)."""
    import torch

    with turn() as held_ms, torch.cuda.stream(stream):
        t0 = time.perf_counter()
        graphs = {}
        with _collector_off():
            for name, part in parts.items():
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    part()
                finally:
                    graph.capture_end()
                graphs[name] = graph
        return graphs, held_ms, (time.perf_counter() - t0) * 1e3


def release(graphs, after=None) -> None:
    """Free `graphs` (``torch.cuda.CUDAGraph``) under the rules above: once
    the event `after` (recorded behind their last replay; None when there
    was none) has completed, in a turn, and while no capture of the process
    is open. A freed graph cannot be replayed: its owner captures again."""
    graphs = list(graphs)
    if not graphs:
        return
    with turn():
        if after is not None:
            after.synchronize()
        with _state:
            while _open:
                _state.wait()
            for graph in graphs:
                graph.reset()
