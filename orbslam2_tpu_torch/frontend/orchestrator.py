"""Background mapping worker.

Counterpart of ``orbslam2_tpu/frontend/orchestrator.py`` (``MappingWorker``;
loop closing, the worker's second stage there, is not ported yet). The
reference runs LocalMapping as a persistent thread fed by a mutex-guarded
keyframe queue, with tracking holding the map lock per frame. Here one
daemon thread consumes a keyframe queue and runs the local mapper; the
tracker keeps the per-frame work on the caller's thread and hands keyframes
off without blocking. The tracker's re-entrant map lock, which the local
mapper shares, plays the role of the reference's map mutex: the tracker
holds it while it reads or writes the map, the mapper around each stage's
host reads and writes.

One deliberate difference from the JAX package: its worker prints a stage's
exception and goes on. This worker keeps the first exception, maps no
further keyframe, and raises it again from ``insert_keyframe``,
``wait_idle`` and ``stop``: a mapper that fails on the card fails the run
instead of leaving the tracker on a map that is no longer refined.
"""
from __future__ import annotations

import atexit
import queue
import threading
import weakref
from typing import Optional


class MappingWorker:
    def __init__(self, local_mapper):
        self.local_mapper = local_mapper
        self.queue: "queue.Queue" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        # serializes idle-flag transitions against enqueues: without it the
        # worker's empty-poll could mark idle between the tracker's
        # _idle.clear() and queue.put(), and wait_idle() would report idle
        # with a keyframe queued
        self._idle_lock = threading.Lock()
        self.error: Optional[Exception] = None
        local_mapper.pending_fn = lambda: not self.queue.empty()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                         name="mapping-worker")
        self._thread.start()
        # join the thread before interpreter teardown: a daemon thread in the
        # middle of a device call when the runtime goes away can abort the
        # process. Registered weakly, so a worker that was stopped can be
        # collected; _join() is idempotent.
        ref = weakref.ref(self)
        atexit.register(lambda: ref() is not None and ref()._join())

    # ------------------------------------------------------------------
    def insert_keyframe(self, kf: int) -> None:
        """Tracking -> mapping handoff (LocalMapping::InsertKeyFrame)."""
        self._raise_if_failed()
        with self._idle_lock:
            self._idle.clear()
            self.queue.put(kf)

    def queue_size(self) -> int:
        return self.queue.qsize()

    def idle(self) -> bool:
        """Local mapping is caught up (the reference's AcceptKeyFrames true
        and queue empty)."""
        return self._idle.is_set()

    def accept_keyframes(self) -> bool:
        """Do not pile up keyframes faster than the worker drains them."""
        return self.queue.qsize() < 3

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until the queue is drained and the last keyframe mapped.
        -> False on timeout. Raises the worker's first exception."""
        ok = self._idle.wait(timeout)
        self._raise_if_failed()
        return ok

    def stop(self, timeout: float = 60.0) -> None:
        """Map what is queued, end and join the thread, then raise the
        worker's first exception if any. Idempotent."""
        self._join(timeout)
        self._raise_if_failed()

    def _join(self, timeout: float = 60.0) -> None:
        if self._thread.is_alive():
            self.queue.put(None)
            self._thread.join(timeout)

    def _raise_if_failed(self) -> None:
        if self.error is not None:
            raise RuntimeError("the mapping worker failed") from self.error

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                break
            if self.error is None:
                try:
                    # the local mapper manages its own lock scope; with a
                    # backlog its stages turn atomic, which throttles the
                    # tracker until mapping catches up
                    self.local_mapper.process_keyframe(
                        item, backlog=self.queue.qsize() > 0)
                except Exception as e:  # kept; raised on the caller's thread
                    self.error = e
            with self._idle_lock:
                if self.queue.empty():
                    self._idle.set()
