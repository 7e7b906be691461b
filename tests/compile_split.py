"""A pytest plugin that splits the time of the port's parity tests: per test,
its seconds (fixtures included), the JAX package's compile seconds (tracing
and lowering, and XLA's backend compile, from ``jax.monitoring``), the
seconds spent rendering synthetic frames (either package's
``SyntheticSequence.render`` and ``render_stereo``), and the two sides of
every ``torch_port_helpers.beside`` call (the JAX package's run on its
thread, the port's on the caller's).

    PYTHONPATH=tests python -m pytest tests/test_torch_*.py -p compile_split \\
        --compile-split=split.jsonl [the tier-1 command's other options]

writes one JSON line per test to the file (each worker of ``-n`` appends
its own lines). Without ``--compile-split`` the plugin does nothing.

    python3 tests/compile_split.py split.jsonl

prints the sums by test file, slowest first, as one JSON line."""
import json
import threading
import time

import pytest

_COMPILE_EVENTS = {
    "/jax/core/compile/jaxpr_trace_duration": "trace",
    "/jax/core/compile/jaxpr_to_mlir_module_duration": "trace",
    "/jax/core/compile/backend_compile_duration": "backend",
}


class _Split:
    def __init__(self, path):
        self.path = path
        self.lock = threading.Lock()
        self.clear()

    def clear(self):
        self.sums = dict(trace=0.0, backend=0.0, render=0.0)
        self.beside = []

    def add(self, key, seconds):
        with self.lock:
            self.sums[key] += seconds

    def on_event(self, event, seconds, **_):
        if event in _COMPILE_EVENTS:
            self.add(_COMPILE_EVENTS[event], seconds)

    def timed(self, key, fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.add(key, time.perf_counter() - t0)
        return wrapped

    def wrap_beside(self, beside):
        def timed_beside(first, second):
            sides = {}

            def side(name, fn):
                def run():
                    t0 = time.perf_counter()
                    try:
                        return fn()
                    finally:
                        sides[name] = round(time.perf_counter() - t0, 3)
                return run
            out = beside(side("jax", first), side("port", second))
            with self.lock:
                self.beside.append(sides)
            return out
        return timed_beside


def pytest_addoption(parser):
    parser.addoption("--compile-split", default=None,
                     help="append each test's time split as JSON lines to this file")


@pytest.hookimpl(trylast=True)
def pytest_sessionstart(session):
    path = session.config.getoption("--compile-split")
    if not path:
        return
    # imported here, after tests/conftest.py has set the JAX platform
    import jax.monitoring
    import torch_port_helpers
    from orbslam2_tpu.io import synthetic as jsynthetic
    from orbslam2_tpu_torch.io import synthetic as tsynthetic

    split = _Split(path)
    jax.monitoring.register_event_duration_secs_listener(split.on_event)
    for module in (jsynthetic, tsynthetic):
        cls = module.SyntheticSequence
        for name in ("render", "render_stereo"):
            setattr(cls, name, split.timed("render", getattr(cls, name)))
    torch_port_helpers.beside = split.wrap_beside(torch_port_helpers.beside)
    session.config._compile_split = split


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    split = getattr(item.config, "_compile_split", None)
    if split is None:
        yield
        return
    with split.lock:
        split.clear()
    t0 = time.perf_counter()
    yield
    seconds = time.perf_counter() - t0
    with split.lock:
        rec = dict(id=item.nodeid, s=round(seconds, 3),
                   **{k: round(v, 3) for k, v in split.sums.items()},
                   beside=list(split.beside))
    with open(split.path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def summarize(path):
    """-> {test file: the summed seconds, JAX tracing and lowering (a trace
    nested in another's is counted in both), XLA's backend compile,
    rendering, and the beside sides, over its tests}, slowest file first."""
    files = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            name = rec["id"].split("::")[0]
            tot = files.setdefault(name, dict(s=0.0, trace=0.0, backend=0.0, render=0.0,
                                              jax_side=0.0, port_side=0.0, cases=0))
            tot["cases"] += 1
            for key in ("s", "trace", "backend", "render"):
                tot[key] += rec[key]
            for sides in rec["beside"]:
                tot["jax_side"] += sides.get("jax", 0.0)
                tot["port_side"] += sides.get("port", 0.0)
    order = sorted(files, key=lambda name: -files[name]["s"])
    return {name: {k: round(v, 1) for k, v in files[name].items()} for name in order}


if __name__ == "__main__":
    import sys
    print(json.dumps(summarize(sys.argv[1])))
