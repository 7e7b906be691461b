"""Local mapping of the port against the JAX package's, on the CPU.

One JAX SLAMSystem (synchronous mapping, no vocabulary) drives 13 frames of
a rendered sequence at 320x240 / 800 features / 4 levels with a keyframe
every third frame, on its classic per-frame path (the fused frame program
would add its compile time to the suite, and only the map matters here). Just before its last ``process_keyframe`` the map is written with the
JAX package's ``MapState.save``; the file is loaded into a JAX and a port
MapState (the carry-across route of
test_torch_mapstate.py::test_saved_map_loads_into_the_other_package), the
mapper's probation set is copied to both, and both mappers process that
keyframe: triangulation, fusion, local BA and culling.

Tolerances: float32 noise moves a few triangulation and fuse decisions at
their gates, and each decision feeds the next stage, so counts agree within
a handful: points created within max(3, 5 %), observations added and points
merged by fusion within max(5, 5 %); keyframes culled equal; after local BA
every keyframe's camera centre within 1e-3 m.

The optimistic-concurrency paths are driven on the port alone: a map change
between staging and applying a triangulation or a fuse makes the stage
return "conflict" and rerun atomically, with the same result as an
undisturbed run; a pose correction during the BA solve drops its write-back.
"""
import numpy as np
import pytest
import torch

from orbslam2_tpu.frontend import local_mapping as jlm
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.slammap import mapstate as jms
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu.frontend.tracking import SLAMConfig as JConfig
from orbslam2_tpu_torch.frontend import kernels as tkernels, local_mapping as tlm
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.ops import orb as torb
from orbslam2_tpu_torch.slammap import mapstate as tms

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), TCamera(**CAM_KW)
SF, NL = 1.2, 4
N_FRAMES = 13


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("local_mapping") / "before_last.npz")
    cfg = JConfig(cam=JCAM, orb=JORBConfig(n_features=800, n_levels=NL), th_depth=4.0,
                  max_keyframes=32, max_points=8192, local_point_cap=2048,
                  min_init_features=300, force_kf_every=3, fused_frame=False,
                  async_mapping=False, pipelined_fetch=False)
    system = JSystem(cfg, JSensor.RGBD)
    mapper = system.local_mapper
    process = mapper.process_keyframe
    last = {}

    def save_then_process(kf, backlog=False):
        mapper.map.save(path)
        last.update(kf=int(kf), recent=dict(mapper._recent))
        return process(kf, backlog)

    mapper.process_keyframe = save_then_process
    seq = SyntheticSequence(JCAM, n_frames=N_FRAMES, trajectory="lateral", seed=1)
    for i in range(N_FRAMES):
        gray, depth = seq.render(i)
        assert system.track_rgbd(gray, depth, i / 30.0) is not None
    system.shutdown()
    assert system.map.n_keyframes() >= 4
    return dict(path=path, **last)


def _count_calls(obj, name, counter, weight=lambda *a: 1):
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        counter[name] = counter.get(name, 0) + weight(*args)
        return fn(*args, **kw)
    setattr(obj, name, wrapped)


def _port_mapper(staged):
    m = tms.MapState.load(staged["path"])
    mapper = tlm.LocalMapper(m, TCAM, tlm.LocalMapperConfig(scale_factor=SF, n_levels=NL),
                             device="cpu")
    mapper._recent = dict(staged["recent"])
    return mapper


def _centres(m):
    ids = np.flatnonzero(m.kf_valid)
    return {int(k): np.linalg.inv(m.kf_pose[k])[:3, 3] for k in ids}


@pytest.fixture(scope="module")
def processed(staged):
    mj = jms.MapState.load(staged["path"])
    jmapper = jlm.LocalMapper(mj, JCAM, jlm.LocalMapperConfig(scale_factor=SF, n_levels=NL))
    jmapper._recent = dict(staged["recent"])
    jcount = {}
    _count_calls(mj, "add_observation", jcount)
    _count_calls(mj, "replace_points", jcount, weight=lambda pairs: len(pairs))
    tmapper = _port_mapper(staged)
    before = dict(pt_counter=mj._pt_counter, n_kf=mj.n_keyframes(),
                  centres=_centres(mj))
    jmapper.process_keyframe(staged["kf"])
    tmapper.process_keyframe(staged["kf"])
    return dict(mj=mj, mt=tmapper.map, jcount=jcount, tcount=tmapper.counts,
                before=before, tmapper=tmapper)


def test_points_created_match_jax(processed):
    p = processed
    created_j = p["mj"]._pt_counter - p["before"]["pt_counter"]
    created_t = p["mt"]._pt_counter - p["before"]["pt_counter"]
    assert created_j > 0 and created_t == p["tcount"]["points_created"]
    assert abs(created_t - created_j) <= max(3, 0.05 * created_j)


def test_fusion_matches_jax(processed):
    p = processed
    obs_j = p["jcount"].get("add_observation", 0)
    merged_j = p["jcount"].get("replace_points", 0)
    assert obs_j + merged_j > 0
    assert abs(p["tcount"]["obs_fused"] - obs_j) <= max(5, 0.05 * obs_j)
    assert abs(p["tcount"]["points_merged"] - merged_j) <= max(5, 0.05 * merged_j)
    assert abs(p["mt"].n_points() - p["mj"].n_points()) <= max(5, 0.01 * p["mj"].n_points())


def test_keyframes_culled_and_poses_after_local_ba_match_jax(processed):
    p = processed
    assert p["tcount"]["ba_applied"] == 1 and p["tcount"]["ba_dropped"] == 0
    assert p["mt"].n_keyframes() == p["mj"].n_keyframes()
    assert p["before"]["n_kf"] - p["mt"].n_keyframes() == p["tcount"]["kf_culled"]
    cj, ct = _centres(p["mj"]), _centres(p["mt"])
    assert cj.keys() == ct.keys()
    moved = max(np.linalg.norm(ct[k] - p["before"]["centres"][k]) for k in ct)
    assert moved > 1e-5          # the BA moved a free keyframe
    for k in cj:
        assert np.linalg.norm(ct[k] - cj[k]) < 1e-3, k
    assert p["mt"].change_index == p["mj"].change_index


def test_fuse_points_into_targets_matches_jax(staged):
    """Loop closing's form of the fuse: one candidate set into every target."""
    mj = jms.MapState.load(staged["path"])
    jmapper = jlm.LocalMapper(mj, JCAM, jlm.LocalMapperConfig(scale_factor=SF, n_levels=NL))
    tmapper = _port_mapper(staged)
    kf = staged["kf"]
    targets = [int(k) for k in np.flatnonzero(mj.kf_valid) if k != kf]
    pts = np.unique(mj.kf_pt[kf])
    pts = pts[pts >= 0]
    jmapper._fuse_points_into_targets(pts, targets)
    tmapper._fuse_points_into_targets(pts, targets)
    assert (tmapper.map.kf_pt == mj.kf_pt).mean() > 0.999
    assert abs(tmapper.map.n_points() - mj.n_points()) <= 3


def test_kf_keypoints_are_fresh_tensors(staged):
    mapper = _port_mapper(staged)
    m, kf = mapper.map, staged["kf"]
    kp = tlm.kf_keypoints(m, kf, "cpu")
    np.testing.assert_array_equal(kp.xy.numpy(), m.kf_kp_xy[kf])
    np.testing.assert_array_equal(kp.octave.numpy(), m.kf_kp_octave[kf])
    np.testing.assert_array_equal(kp.desc.numpy().view(np.uint32), m.kf_kp_desc[kf])
    assert (kp.size == 1).all() and kp.valid.dtype == torch.bool
    ex = torb.get_extractor(torb.ORBConfig(n_features=800, n_levels=NL), (240, 320), "cpu")
    shared = ex.extract_with_pyramid(kp.xy.new_zeros(240, 320))[0]
    kp.octave += 1
    kp.size += 1
    assert int(shared.octave.max()) < NL and (shared.size > 0).all()
    assert kp.octave.data_ptr() != shared.octave.data_ptr()
    np.testing.assert_array_equal(m.kf_kp_octave[kf] + 1, kp.octave.numpy())


STAGES = {"triangulate": ("_create_new_map_points", tlm, "triangulate_neighbors"),
          "fuse": ("_search_in_neighbors", tkernels, "fuse_targets")}


def _disturb_search(monkeypatch, mapper, module, name):
    """Make the stage's unlocked search edit the map's observations once, as
    a keyframe the tracker inserts meanwhile would."""
    search = getattr(module, name)
    disturbed = []

    def search_then_edit(*args, **kw):
        out = search(*args, **kw)
        if not disturbed:
            disturbed.append(True)
            mapper.map.touch_obs()
        return out

    monkeypatch.setattr(module, name, search_then_edit)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_conflict_applies_nothing_and_the_atomic_rerun_matches(staged, stage, monkeypatch):
    """A map change between staging and applying makes the apply refuse
    ("conflict", nothing written); the atomic rerun then gives what an
    undisturbed stage gives."""
    fn, module, name = STAGES[stage]
    kf = staged["kf"]
    calm = _port_mapper(staged)
    w = tlm.covisibility.weight_matrix(calm.map)
    assert getattr(calm, fn)(kf, w) is None
    mapper = _port_mapper(staged)
    kf_pt, counter = mapper.map.kf_pt.copy(), mapper.map._pt_counter
    _disturb_search(monkeypatch, mapper, module, name)
    assert getattr(mapper, fn)(kf, w) == "conflict"
    np.testing.assert_array_equal(mapper.map.kf_pt, kf_pt)
    assert mapper.map._pt_counter == counter
    assert getattr(mapper, fn)(kf, tlm.covisibility.weight_matrix(mapper.map),
                               atomic=True) is None
    np.testing.assert_array_equal(mapper.map.kf_pt, calm.map.kf_pt)
    np.testing.assert_array_equal(mapper.map.pt_valid, calm.map.pt_valid)
    assert mapper.counts == calm.counts


def test_process_keyframe_reruns_a_conflicting_stage(staged, processed, monkeypatch):
    mapper = _port_mapper(staged)
    _disturb_search(monkeypatch, mapper, tlm, "triangulate_neighbors")
    mapper.process_keyframe(staged["kf"])
    calm = processed["tmapper"]
    assert mapper.counts["conflicts"] == 1
    assert {k: v for k, v in mapper.counts.items() if k != "conflicts"} \
        == {k: v for k, v in calm.counts.items() if k != "conflicts"}
    np.testing.assert_array_equal(mapper.map.kf_pt, calm.map.kf_pt)


def test_correction_during_local_ba_drops_the_write_back(staged, monkeypatch):
    mapper = _port_mapper(staged)
    solve = tlm.ba.bundle_adjust
    seen = {}

    def solve_during_correction(*args, **kw):
        out = solve(*args, **kw)
        seen["poses"] = mapper.map.kf_pose.copy()
        mapper.map.correction_gen += 1    # a loop correction lands mid-solve
        return out

    monkeypatch.setattr(tlm.ba, "bundle_adjust", solve_during_correction)
    mapper.process_keyframe(staged["kf"])
    assert mapper.counts["ba_dropped"] == 1 and mapper.counts["ba_applied"] == 0
    np.testing.assert_array_equal(mapper.map.kf_pose, seen["poses"])


@pytest.mark.parametrize("why", ["interrupt", "pending"])
def test_interrupt_and_backlog_skip_the_local_ba(staged, why):
    """InterruptBA (the tracker asked for a keyframe while mapping ran) skips
    the local BA and keyframe culling; a queued keyframe (CheckNewKeyFrames)
    also skips fusion."""
    mapper = _port_mapper(staged)
    if why == "interrupt":
        mapper.interrupt_ba = True
    else:
        mapper.pending_fn = lambda: True
    mapper.stats.enabled = True
    mapper.process_keyframe(staged["kf"])
    assert mapper.counts["ba_skipped"] == 1 and mapper.counts["ba_applied"] == 0
    # each cause has its own counter
    assert mapper.counts["ba_interrupted"] == (why == "interrupt")
    assert mapper.counts["ba_backlog"] == (why == "pending")
    assert not mapper.interrupt_ba
    ran = set(mapper.stats.summary())
    assert "local_ba" not in ran and "kf_culling" not in ran and "triangulate" in ran
    assert ("fuse" in ran) == (why == "interrupt")
