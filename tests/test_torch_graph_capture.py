"""When a CUDA graph capture or replay may run (``utils/graph_capture.py``):
a turn on one of the port's own threads waits for a caller's call into the
port, and that call returns only after the turn has ended, so a caller that
waits for the whole device or stops a profiler between its calls never
meets one. The rules are host-side and run here on the CPU; the graphs
themselves run on a card (chip_smoke.py phases 9 and 22)."""
import threading

import pytest

from orbslam2_tpu_torch.utils import graph_capture

WAIT_S = 5.0
SETTLE_S = 0.2


def _port_thread_capture(started: threading.Event, release: threading.Event,
                         done: threading.Event) -> threading.Thread:
    def run():
        graph_capture.background()
        with graph_capture.turn():
            started.set()
            release.wait(WAIT_S)
        done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_a_port_thread_takes_its_turn_only_inside_a_call_which_waits_for_it():
    started, release, done = threading.Event(), threading.Event(), threading.Event()
    worker = _port_thread_capture(started, release, done)
    assert not started.wait(SETTLE_S), "a turn ran with no call open"
    returned = threading.Event()

    def call():           # a call shorter than the capture's wake-up
        with graph_capture.entry():
            pass
        returned.set()

    caller = threading.Thread(target=call, daemon=True)
    caller.start()
    assert started.wait(WAIT_S), "a call opened and the turn did not run"
    assert not returned.wait(SETTLE_S), "the call returned while the turn ran"
    release.set()
    assert returned.wait(WAIT_S) and done.wait(WAIT_S)
    worker.join(WAIT_S)
    caller.join(WAIT_S)
    assert not worker.is_alive() and not caller.is_alive()
    assert graph_capture._calls == graph_capture._captures == graph_capture._waiting == 0


@pytest.mark.parametrize("inside_a_call", [False, True])
def test_a_callers_own_turn_runs_at_once(inside_a_call):
    """A turn on a thread the port did not start (the caller's, or a
    program used on its own) runs at once, inside a call or not."""
    ran = []
    if inside_a_call:
        with graph_capture.entry(), graph_capture.turn() as held_ms:
            ran.append(held_ms)
    else:
        with graph_capture.turn() as held_ms:
            ran.append(held_ms)
    assert len(ran) == 1 and ran[0] < 1e3
    assert graph_capture._calls == graph_capture._captures == 0


def test_nested_calls_and_a_decorated_method_keep_the_count():
    class Api:
        @graph_capture.entry()
        def outer(self):
            return self.inner() + graph_capture._calls

        @graph_capture.entry()
        def inner(self):
            return graph_capture._calls

    assert Api().outer() == 2 + 1
    assert graph_capture._calls == 0
