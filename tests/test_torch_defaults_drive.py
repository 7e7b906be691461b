"""The defaults drive's two faults, held on the CPU.

A local BA written back while a pipelined frame is in flight moves the map
under it: the frame was solved against points that have moved since, and
the frame chained off it is predicted from that pose. ORB-SLAM2 holds the
map for the whole of a frame, so none of its frames straddles a BA; the
tracker voids such a frame and dispatches it again against the moved map,
as it does after a loop correction, and tracks the frames chained off it
again (``Tracker._apply_one``). The schedule the card showed (phase 14's
far drives: the BA landed between the dispatch of a frame and that of the
frame chained off it) is forced here with a rigid move of the whole map
between two track calls, at the test geometry (320x240 / 800 / 4, mapping
inline so that the order of frames is fixed): the drive must come out as
the same drive in the moved map.

A CUDA graph destroyed on a thread that is capturing invalidates the
capture. ``utils/graph_capture.py`` keeps Python's collector off while a
capture is open, and ``SLAMSystem.shutdown`` releases every program's
graphs; a stand-in for ``torch.cuda.CUDAGraph`` records, when it is freed,
whether a capture was open on its thread. The graphs themselves run on a
card (``chip_smoke.py`` phase 14, ``tools/capture_after_drop.py``)."""
import gc
import threading

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.backend import solve_program
from orbslam2_tpu_torch.frontend import frame, kernels
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.place.pretrained import get_default_vocabulary
from orbslam2_tpu_torch.system import Sensor, SLAMSystem
from orbslam2_tpu_torch.utils import graph_capture

CAM = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
DROPPED_GRAPHS = 12      # a dropped system's local-BA graphs: 6 parts at 2 sizes
N_FRAMES = 16
MOVE_AFTER = 7           # the map moves after this track call, its frame in flight
MOVE_T = (0.12, -0.05, 0.15)   # the move: 0.2 m and 3 degrees, a large local BA's
MOVE_DEG = 3.0
SAME_DRIVE_M = 0.005     # a pose in the moved drive against the same pose moved


def _config(**kw):
    return SLAMConfig(cam=CAM, orb=ORBConfig(n_features=800, n_levels=4), th_depth=4.0,
                      max_keyframes=64, max_points=8192, local_point_cap=2048,
                      max_frames_between_kf=10, min_init_features=300, **kw)


def _move() -> np.ndarray:
    """The rigid move S of the world: x' = S x."""
    a = np.deg2rad(MOVE_DEG)
    s = np.eye(4)
    s[:3, :3] = [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]]
    s[:3, 3] = MOVE_T
    return s


def _move_map(system, s: np.ndarray) -> None:
    """Every keyframe and point moved by S, as a local BA writes back: under
    the map lock, the points marked for the device mirror."""
    m = system.map
    with system.tracker.map_lock:
        kf = m.kf_valid
        m.kf_pose[kf] = (m.kf_pose[kf].astype(np.float64) @ np.linalg.inv(s)).astype(np.float32)
        pt = m.pt_valid
        m.pt_pos[pt] = (m.pt_pos[pt].astype(np.float64) @ s[:3, :3].T + s[:3, 3]).astype(
            np.float32)
        m.mark_all_pts_dirty()


@pytest.fixture(scope="module")
def forward():
    seq = SyntheticSequence(CAM, N_FRAMES, "forward", seed=1)
    return [seq.render(i) for i in range(N_FRAMES)]


def _drive(frames, move=None):
    """A pipelined drive (fetch_batch 1) with mapping inline; with `move`
    the map moves after track call MOVE_AFTER. -> (camera-to-world poses
    rebuilt at the end, lost mask, keyframes, motion-model matches by
    fused frame, the tracker)."""
    system = SLAMSystem(_config(async_mapping=False), Sensor.RGBD, device="cpu")
    tracker = system.tracker
    mm = {}
    apply = tracker._fused_apply

    def recorded(rec, fetched):
        mm[rec["frame_id"]] = int(fetched[4])
        return apply(rec, fetched)

    tracker._fused_apply = recorded
    for i, (gray, depth) in enumerate(frames):
        system.track_rgbd(gray, depth, i / 30.0)
        if move is not None and i == MOVE_AFTER:
            assert tracker._inflight is not None, "no frame in flight at the move"
            _move_map(system, move)
    out = (tracker.full_trajectory_twc(), tracker.trajectory_lost_mask(),
           system.map.n_keyframes(), mm, tracker)
    system.shutdown()
    return out


def test_a_frame_solved_before_a_move_of_the_map_is_solved_again(forward):
    """The map moved rigidly between two track calls, with a frame in flight
    that was solved before the move and a frame chained off it dispatched
    after: the drive is the same drive in the moved map. The frame in flight
    is dispatched again against the moved map (one frame built again) and
    the frame chained off it tracked again; their motion models find the
    same matches as the drive without the move."""
    s = _move()
    est, lost, n_kf, mm, tracker = _drive(forward)
    moved_est, moved_lost, moved_kf, moved_mm, moved_tracker = _drive(forward, s)
    assert not lost.any() and not moved_lost.any()
    gap = np.linalg.norm(moved_est[:, :3, 3] - (s @ est)[:, :3, 3], axis=1)
    assert gap.max() < SAME_DRIVE_M, gap
    after = [f for f in sorted(mm) if f > MOVE_AFTER]
    assert after and all(abs(moved_mm[f] - mm[f]) <= 0.02 * mm[f] for f in after), \
        [(f, mm[f], moved_mm.get(f)) for f in after]
    assert moved_kf == n_kf
    assert tracker.rebuilt_frames == 0 and moved_tracker.rebuilt_frames == 1
    assert moved_tracker.retracked_frames == tracker.retracked_frames + 1


class StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: capture_begin/end open and
    close a capture on the calling thread; ``reset`` (which the destructor
    calls, as torch's does) records whether a capture was open on the
    thread that freed the graph, and a freed graph refuses to replay."""
    open_on = threading.local()
    freed: list = []

    def __init__(self):
        self.live = True

    @classmethod
    def capturing(cls) -> bool:
        return getattr(cls.open_on, "n", 0) > 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        StubGraph.open_on.n = getattr(StubGraph.open_on, "n", 0) + 1

    def capture_end(self):
        StubGraph.open_on.n -= 1

    def replay(self):
        if not self.live:
            raise RuntimeError("replay of a freed graph")

    def reset(self):
        if self.live:
            self.live = False
            StubGraph.freed.append(StubGraph.capturing())

    def __del__(self):
        self.reset()


class StubEvent:
    """Stands in for the event behind a program's last replay."""

    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append("replay done")


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    StubGraph.freed = []
    yield StubGraph
    gc.collect()


def test_no_collection_frees_a_graph_inside_a_capture(stub):
    """A dropped system's graphs, unreachable only through a cycle that the
    collector finds while a capture is open, are freed after the capture,
    not inside it, with the collector due at every allocation."""
    dropped = {"graphs": [StubGraph() for _ in range(DROPPED_GRAPHS)]}
    inside = []

    def part():
        junk = [dropped.pop("graphs")]
        junk.append(junk)
        del junk
        # allocations that stay: the collector is due after each
        held = [[] for _ in range(1000)]
        inside.append((len(stub.freed), gc.isenabled()))
        del held

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graphs, _, _ = graph_capture.capture({"step": part}, None)
    finally:
        gc.set_threshold(*threshold)
    assert inside == [(0, False)], "a graph was freed inside the capture"
    assert gc.isenabled() and graph_capture._open == 0
    gc.collect()
    assert stub.freed == [False] * DROPPED_GRAPHS
    assert list(graphs) == ["step"]


@pytest.mark.parametrize("collector_on", [True, False])
def test_the_collectors_state_comes_back_after_a_failed_capture(stub, collector_on):
    """A part that raises fails the capture (the error reaches the caller)
    and leaves the collector as it was; two captures open at once on two
    threads keep it off until the second closes."""
    was = gc.isenabled()
    (gc.enable if collector_on else gc.disable)()
    try:
        with pytest.raises(ZeroDivisionError):
            graph_capture.capture({"ok": lambda: None, "bad": lambda: 1 / 0}, None)
        assert gc.isenabled() == collector_on and graph_capture._open == 0

        inside, leave = threading.Event(), threading.Event()

        def long_part():
            inside.set()
            leave.wait(5.0)

        other = threading.Thread(target=graph_capture.capture,
                                 args=({"step": long_part}, None), daemon=True)
        other.start()
        assert inside.wait(5.0)
        graph_capture.capture({"step": lambda: None}, None)
        assert not gc.isenabled(), "the collector came back while a capture was open"
        leave.set()
        other.join(5.0)
        assert gc.isenabled() == collector_on and graph_capture._open == 0
    finally:
        (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("vocabulary", [False, True])
def test_shutdown_releases_the_graphs_of_every_program(stub, vocabulary):
    """``SLAMSystem.shutdown`` frees each program's graphs after its last
    replay, outside any capture; a program used afterwards captures again
    and never replays a freed graph."""
    cfg = SLAMConfig(cam=CAM, orb=ORBConfig(n_features=800, n_levels=4), th_depth=4.0,
                     max_keyframes=64, max_points=8192, local_point_cap=2048)
    system = SLAMSystem(cfg, Sensor.RGBD, device="cpu",
                        vocabulary=get_default_vocabulary() if vocabulary else None)
    log = []
    tracker = system.tracker
    tracker.frame_programs["rgbd"] = kernels.FrameProgram("rgbd", tracker.extractor, CAM, 1.2, 4)
    # the classic path's programs: the frame build, the motion-model and
    # local-map steps
    tracker.classic_programs.update(
        rgbd=frame.BuildProgram("rgbd", tracker.extractor, CAM),
        motion_model_step=kernels.MotionModelProgram(CAM, 1.2, 4),
        local_map_step=kernels.LocalMapProgram(CAM, 1.2, 4))
    steps = [*tracker.frame_programs.values(), *tracker.classic_programs.values()]
    for prog in steps:
        prog._graphs[("key",)] = kernels._Captured(StubGraph(), [], None, 1, [])
        prog._done = StubEvent(log)
    solves = [p for p in system.programs() if isinstance(p, solve_program._Program)]
    expected = (3 if vocabulary else 2)
    assert len(solves) == expected and len(system.programs()) == expected + len(steps)
    assert all(any(p is q for q in system.programs()) for p in steps)
    graphs = [p._graphs[("key",)].graph for p in steps]
    for prog in solves:
        parts = {"reset": StubGraph(), "step": StubGraph()}
        prog._captured[("key",)] = solve_program._Captured([], parts, ["reset", "step"],
                                                           (), {})
        prog._done = StubEvent(log)
        prog._pool = object()
        graphs += parts.values()
    system.shutdown()
    assert all(not g.live for g in graphs) and stub.freed == [False] * len(graphs)
    assert log == ["replay done"] * (len(steps) + len(solves))
    assert all(p._graphs == {} for p in steps) and all(p._captured == {} for p in solves)
    assert all(p._pool is None for p in solves), "a new capture takes a new pool"
    with pytest.raises(RuntimeError, match="freed"):
        graphs[0].replay()
