"""The port's native map-graph engine (orbslam2_tpu_torch/slammap/native.py,
built from native/mapgraph.cpp into orbslam2_tpu_torch/_build/) against its
numpy plain versions, on random maps with invalid keyframes that still hold
observation rows, invalid points that are still observed, empty rows, and one
map at full KITTI capacity (1536 keyframes x 150 000 points, few live).

Tolerances: every integer output (weights, index, counts, shares,
representative descriptors, reference keyframes) is identical; the viewing
normal and the scale band are float32 in the engine and mixed float32 /
float64 in numpy, so they agree to rtol 1e-5 (a few float32 ulps through a
normalisation and a power)."""
import copy
import os

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)
from orbslam2_tpu_torch.slammap import covisibility, native, point_stats
from orbslam2_tpu_torch.slammap.mapstate import MapCapacity, MapState

PKG = os.path.dirname(os.path.abspath(native.__file__))
BUILD_DIR = os.path.join(os.path.dirname(PKG), "_build")

# (keyframe capacity, point capacity, keypoint slots, live keyframes,
#  live points): small, mid-size, and full KITTI capacity with a few live
MAPS = {
    "small": (24, 600, 64, 14, 400),
    "mid": (96, 8192, 400, 40, 5000),
    "kitti_capacity": (1536, 150_000, 2000, 30, 4000),
}


def random_map(name: str) -> MapState:
    k_cap, p_cap, n, n_kf, n_pts = MAPS[name]
    rng = np.random.default_rng(sorted(MAPS).index(name) + 5)
    m = MapState(MapCapacity(k_cap, p_cap, n))
    kfs = rng.choice(k_cap, n_kf + 4, replace=False)
    live_kfs, dead_kfs = kfs[:n_kf], kfs[n_kf:]
    pts = rng.choice(p_cap, n_pts, replace=False)
    m.pt_valid[pts] = True
    m.pt_valid[pts[:n_pts // 20]] = False       # erased, yet still observed
    for i, kf in enumerate(kfs):
        m.kf_valid[kf] = kf in live_kfs
        if i % 7 == 3:
            continue                             # an empty row
        n_obs = int(rng.integers(1, min(n, n_pts) // 2))
        # one observation of a point per keyframe, as the map keeps it
        m.kf_pt[kf, rng.choice(n, n_obs, replace=False)] = rng.choice(pts, n_obs, replace=False)
    # keyframe poses, keypoints; points with a position and a reference
    ang = rng.uniform(-np.pi, np.pi, k_cap)
    c, s = np.cos(ang), np.sin(ang)
    m.kf_pose[:, 0, 0], m.kf_pose[:, 0, 2], m.kf_pose[:, 2, 0], m.kf_pose[:, 2, 2] = c, s, -s, c
    m.kf_pose[:, :3, 3] = rng.normal(0, 2, (k_cap, 3))
    m.kf_kp_octave[kfs] = rng.integers(0, 8, (len(kfs), n))
    m.kf_kp_desc[kfs] = rng.integers(0, 2 ** 32, (len(kfs), n, 8), dtype=np.uint32)
    m.pt_pos[pts] = rng.normal(0, 5, (n_pts, 3)).astype(np.float32)
    # reference keyframe: an observer, a dead keyframe, or none
    m.pt_ref_kf[pts] = rng.choice(np.concatenate([live_kfs, dead_kfs, [-1]]), n_pts)
    assert len(dead_kfs) and (m.kf_pt[dead_kfs] >= 0).any()
    return m


@pytest.fixture(scope="module", params=sorted(MAPS))
def rmap(request):
    return request.param, random_map(request.param)


def test_the_library_is_built_into_the_ports_build_directory():
    native.load()
    path = native.loaded_path()
    assert os.path.dirname(os.path.abspath(path)) == os.path.abspath(BUILD_DIR)
    assert os.path.basename(path) == "libmapgraph.so"
    assert native.load().mg_abi_version() == native.ABI_VERSION
    assert os.path.basename(native.SOURCE) == "mapgraph.cpp"


def test_covis_weights_equal_the_plain_product(rmap):
    _, m = rmap
    w = covisibility.weight_matrix(m)
    assert w.dtype == np.int32 and w.shape == (m.cap.max_keyframes,) * 2
    np.testing.assert_array_equal(w, covisibility.weight_matrix_plain(m))
    assert w.sum() > 0 and (np.diag(w) == 0).all()
    dead = ~m.kf_valid
    assert not w[dead].any() and not w[:, dead].any()


def test_observation_index_equals_the_plain_index(rmap):
    _, m = rmap
    got = native.invert_obs_slots(m.kf_pt, m.kf_valid, m.cap.max_points)
    want = m._obs_index_plain()
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert int(got[0][-1]) == int(((m.kf_pt >= 0) & m.kf_valid[:, None]).sum())


def test_point_obs_count_equals_the_plain_count(rmap):
    _, m = rmap
    got = m._point_obs_count_impl()
    np.testing.assert_array_equal(got, m._point_obs_count_plain())
    assert got.dtype == np.int64 and got.max() > 1


def test_frame_share_equals_the_plain_share(rmap):
    _, m = rmap
    rng = np.random.default_rng(3)
    observed = np.unique(m.kf_pt[m.kf_valid & (m.kf_pt >= 0).any(1)])
    observed = observed[observed >= 0]
    pts = rng.choice(observed, min(300, len(observed)), replace=False)
    pts = np.concatenate([pts, pts[:5]])           # a point listed twice counts twice
    offsets, obs_kf, _ = m.obs_index()
    got = native.share_from_index(offsets, obs_kf, pts, m.cap.max_keyframes)
    np.testing.assert_array_equal(got, covisibility.frame_share_plain(m, pts))
    assert got.sum() > 0


def test_update_point_stats_matches_the_plain_update(rmap):
    name, m = rmap
    rng = np.random.default_rng(4)
    pts = np.concatenate([np.flatnonzero(m.pt_valid), np.flatnonzero(~m.pt_valid)[:50]])
    pts = rng.permutation(pts)[:1500]
    a, b = copy.deepcopy(m), copy.deepcopy(m)
    native.update_point_stats(a, pts, 1.2, 8)
    # the plain version reads observations through the plain index
    b._obs_index_cache = (b.obs_gen, b._obs_index_plain())
    point_stats.update_points(b, pts, 1.2, 8)
    np.testing.assert_array_equal(a.pt_desc, b.pt_desc)
    np.testing.assert_array_equal(a.pt_ref_kf, b.pt_ref_kf)
    for f in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    # the update really ran: multi-observation points and moved references
    counts = m._point_obs_count_plain()
    assert (counts[pts] > 1).sum() > 10, name
    assert (a.pt_ref_kf != m.pt_ref_kf).any()
    assert (a.pt_desc[pts] != m.pt_desc[pts]).any()


def test_map_queries_take_the_native_path(monkeypatch):
    m = random_map("small")
    calls = []
    for name in ("covis_weights", "invert_obs_slots", "point_obs_count",
                 "share_from_index", "update_point_stats"):
        fn = getattr(native, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(native, name, spy)
    w = covisibility.weight_matrix(m)
    pids = np.full(m.cap.n_features, -1, np.int32)
    pids[:40] = np.flatnonzero(m.pt_valid)[:40]
    local, ref = covisibility.local_keyframes(m, pids, w)
    m.point_obs_count()
    m.update_point_descriptor_and_normal(np.flatnonzero(m.pt_valid), 1.2, 8)
    assert calls == ["covis_weights", "invert_obs_slots", "share_from_index",
                     "point_obs_count", "update_point_stats"]
    assert ref >= 0 and len(local)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int f( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "build" / "libmapgraph.so"))
    with pytest.raises(RuntimeError, match="error"):
        native.build(force=True)
    assert not os.path.exists(native.LIB_PATH)


def test_concurrent_builds_leave_a_whole_library(tmp_path, monkeypatch):
    """Several builds at once (pytest workers at first use) each write a
    temporary file and rename it into place: the library loads after."""
    import ctypes
    import threading

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libmapgraph.so"))
    errors = []

    def build():
        try:
            native.build(force=True)
        except RuntimeError as e:       # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errors and not any(th.is_alive() for th in threads)
    assert sorted(os.listdir(tmp_path)) == ["libmapgraph.so"]
    assert ctypes.CDLL(native.LIB_PATH).mg_abi_version() == native.ABI_VERSION
