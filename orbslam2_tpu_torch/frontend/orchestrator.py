"""Background mapping and loop-closing worker.

Counterpart of ``orbslam2_tpu/frontend/orchestrator.py`` (``MappingWorker``).
The reference runs LocalMapping and LoopClosing as persistent threads fed by
mutex-guarded keyframe queues, with tracking holding the map lock per frame.
Here one daemon thread consumes a keyframe queue and runs the two stages in
order: the local mapper, then (with a vocabulary) the loop closer, the
latter under the map lock and inside a ``loop_closing`` stage of the
mapper's StageTimer. The tracker keeps the per-frame work on the caller's
thread and hands keyframes off without blocking. The tracker's re-entrant
map lock, which the local mapper and the loop closer share, plays the role
of the reference's map mutex: the tracker holds it while it reads or writes
the map, the mapper around each stage's host reads and writes.

One deliberate difference from the JAX package: its worker prints a stage's
exception and goes on. This worker keeps the first exception, maps no
further keyframe, and raises it again from ``insert_keyframe``,
``wait_idle`` and ``stop``: a mapper that fails on the card fails the run
instead of leaving the tracker on a map that is no longer refined.

With ``sync_mapping`` (a monocular system unless ``mono_async_mapping``) the
local mapping runs inline in ``insert_keyframe``, on the tracker's thread
under its map lock, and only the loop stage is left to the worker: the
reference never queues a monocular keyframe behind a busy mapper, because
triangulation is monocular's only source of points and the next frame must
track against them.

A second difference: a keyframe that local mapping culled before its loop
stage skips the loop closer here. The JAX worker passes it on, and its loop
closer detects loops from the dead keyframe and adds it to the keyframe
database after culling erased it, where it can come back as a loop or
relocalization candidate (then skipped) until its slot is reused.
"""
from __future__ import annotations

import atexit
import queue
import threading
import weakref
from typing import Optional

import numpy as np

from orbslam2_tpu_torch.utils import graph_capture


class MappingWorker:
    def __init__(self, local_mapper, loop_closer=None, map_lock=None,
                 sync_mapping: bool = False):
        """`loop_closer`: run after the local mapper on every keyframe handed
        off with word ids, under `map_lock` (the tracker's).
        `sync_mapping`: map each keyframe inline in `insert_keyframe` and
        leave only the loop stage to the worker."""
        self.local_mapper = local_mapper
        self.loop_closer = loop_closer
        self.map_lock = map_lock if map_lock is not None else threading.RLock()
        self.sync_mapping = sync_mapping
        self.queue: "queue.Queue" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        # serializes idle-flag transitions against enqueues: without it the
        # worker's empty-poll could mark idle between the tracker's
        # _idle.clear() and queue.put(), and wait_idle() would report idle
        # with a keyframe queued
        self._idle_lock = threading.Lock()
        self.error: Optional[Exception] = None
        # inline mapping has nothing queued behind it: the loop-stage backlog
        # never skips a local BA
        local_mapper.pending_fn = (lambda: False) if sync_mapping else \
            (lambda: not self.queue.empty())
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
    def insert_keyframe(self, kf: int, word_ids: Optional[np.ndarray] = None) -> None:
        """Tracking -> mapping handoff (LocalMapping::InsertKeyFrame);
        `word_ids` (the keyframe's BoW words) go to the loop closer. With
        `sync_mapping` the keyframe is mapped here, on the caller's thread,
        and a failure raises here."""
        self._raise_if_failed()
        mapped = False
        if self.sync_mapping:
            self.local_mapper.process_keyframe(kf)
            mapped = True
        with self._idle_lock:
            self._idle.clear()
            self.queue.put((kf, word_ids, mapped))

    # the caller's calls: the worker's captures and graph launches run while
    # one is open (utils/graph_capture.py), so a caller that polls or waits
    # for the worker lets it go on
    @graph_capture.entry()
    def queue_size(self) -> int:
        return self.queue.qsize()

    @graph_capture.entry()
    def idle(self) -> bool:
        """Local mapping is caught up (the reference's AcceptKeyFrames true
        and queue empty). Inline mapping is always caught up: the loop-stage
        backlog does not hold back keyframe insertion, as the reference's
        loop-closing queue never does."""
        return self.sync_mapping or self._idle.is_set()

    @graph_capture.entry()
    def accept_keyframes(self) -> bool:
        """Do not pile up keyframes faster than the worker drains them."""
        return self.queue.qsize() < 3

    @graph_capture.entry()
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

    @graph_capture.entry()
    def _join(self, timeout: float = 60.0) -> None:
        if self._thread.is_alive():
            self.queue.put(None)
            self._thread.join(timeout)

    def _raise_if_failed(self) -> None:
        if self.error is not None:
            raise RuntimeError("the mapping worker failed") from self.error

    # ------------------------------------------------------------------
    def _run(self) -> None:
        graph_capture.background()
        while True:
            item = self.queue.get()
            if item is None:
                break
            kf, word_ids, mapped = item
            if self.error is None:
                try:
                    # the local mapper manages its own lock scope; with a
                    # backlog its stages turn atomic, which throttles the
                    # tracker until mapping catches up
                    if not mapped:
                        self.local_mapper.process_keyframe(
                            kf, backlog=self.queue.qsize() > 0)
                    if self.loop_closer is not None and word_ids is not None:
                        with self.local_mapper.stats.stage("loop_closing"), \
                                self.map_lock:
                            # local mapping may have culled the keyframe;
                            # then it stays out of the keyframe database
                            if self.loop_closer.map.kf_valid[kf]:
                                self.loop_closer.process_keyframe(kf, word_ids)
                except Exception as e:  # kept; raised on the caller's thread
                    self.error = e
            with self._idle_lock:
                if self.queue.empty():
                    self._idle.set()
