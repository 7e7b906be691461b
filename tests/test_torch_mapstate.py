"""The cases of tests/test_mapstate.py on the port's own MapState,
covisibility, point statistics and device mirror; each query is also held
against the JAX package's MapState driven the same way, and a map saved by
either package loads into the other."""
import numpy as np
import pytest
import torch

from orbslam2_tpu.slammap import covisibility as jcov
from orbslam2_tpu.slammap import mapstate as jms
from orbslam2_tpu.slammap import point_stats as jstats
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.slammap import covisibility as tcov
from orbslam2_tpu_torch.slammap import mapstate as tms
from orbslam2_tpu_torch.slammap import point_stats as tstats
from orbslam2_tpu_torch.slammap.device_map import DeviceKFStore, DeviceMapMirror

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)


def make_map(mod, n_kf=4, n_pts=50, n_feat=64):
    m = mod.MapState(mod.MapCapacity(max_keyframes=8, max_points=128, n_features=n_feat))
    rng = np.random.default_rng(0)
    kfs = []
    for k in range(n_kf):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(size=3) * 0.3
        kfs.append(m.add_keyframe(
            pose=pose, timestamp=float(k), frame_id=k,
            kp_xy=rng.uniform(0, 300, (n_feat, 2)).astype(np.float32),
            kp_octave=rng.integers(0, 4, n_feat).astype(np.int32),
            kp_angle=np.zeros(n_feat, np.float32),
            kp_response=np.ones(n_feat, np.float32),
            kp_desc=rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint32),
            kp_valid=np.ones(n_feat, bool),
            kp_ur=np.full(n_feat, -1, np.float32),
            kp_depth=np.full(n_feat, -1, np.float32)))
    pts = [m.add_point(rng.normal(size=3).astype(np.float32) + [0, 0, 4],
                       rng.integers(0, 2**32, 8, dtype=np.uint32), kfs[0], 0)
           for _ in range(n_pts)]
    return m, kfs, pts


def both():
    return make_map(tms), make_map(jms)


def observe(m, kfs, pts):
    for i in range(20):
        m.add_observation(kfs[0], i, pts[i])
        m.add_observation(kfs[1], i, pts[i])
    for i in range(5):
        m.add_observation(kfs[2], 30 + i, pts[i])


# a batched vector norm sums its three squares in another order than the
# per-point dot product: the last float32 bit of a distance may differ
FLOAT_NOISE_FIELDS = ("pt_normal", "pt_min_dist", "pt_max_dist")


def assert_same_map(a, b):
    for f in tms.MapState._SAVE_FIELDS:
        if f in FLOAT_NOISE_FIELDS:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-6,
                                       atol=1e-7, err_msg=f)
        else:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a._kf_free == b._kf_free and a._pt_free == b._pt_free
    assert a.kf_loop_edges == b.kf_loop_edges


@pytest.fixture(autouse=True)
def numpy_branch(monkeypatch):
    # hold the port against the JAX package's numpy branch, the one it copies
    monkeypatch.setenv("ORBSLAM2_TPU_NATIVE", "0")


class TestMapState:
    def test_allocation_and_counts(self):
        (m, kfs, pts), (mj, _, _) = both()
        assert m.n_keyframes() == 4 and m.n_points() == 50
        assert m.free_point_slots() == 78 and m.free_keyframe_slots() == 4
        np.testing.assert_array_equal(m.keyframe_ids(), mj.keyframe_ids())
        assert_same_map(m, mj)

    def test_observations(self):
        (m, kfs, pts), (mj, _, _) = both()
        for mm in (m, mj):
            mm.add_observation(kfs[0], 3, pts[0])
            mm.add_observation(kfs[1], 5, pts[0])
        obs = m.point_observations(pts[0])
        assert (kfs[0], 3) in obs and (kfs[1], 5) in obs
        assert obs == mj.point_observations(pts[0])
        assert m.point_obs_count()[pts[0]] == 2
        np.testing.assert_array_equal(m.point_obs_count(), mj.point_obs_count())
        for a, b in zip(m.obs_index(), mj.obs_index()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(m.incidence(), mj.incidence())

    def test_erase_point_clears_observations(self):
        (m, kfs, pts), (mj, _, _) = both()
        for mm in (m, mj):
            mm.add_observation(kfs[0], 3, pts[0])
            mm.erase_point(pts[0])
        assert not m.pt_valid[pts[0]]
        assert (m.kf_pt[kfs[0]] != pts[0]).all()
        assert_same_map(m, mj)

    def test_replace_point_redirects(self):
        (m, kfs, pts), (mj, _, _) = both()
        for mm in (m, mj):
            mm.add_observation(kfs[0], 3, pts[0])
            mm.add_observation(kfs[1], 5, pts[0])
            mm.add_observation(kfs[1], 7, pts[1])  # kf1 already sees pts[1]
            mm.replace_point(pts[0], pts[1])
        assert not m.pt_valid[pts[0]]
        # kf0 redirected; kf1 kept its existing observation of pts[1]
        assert m.kf_pt[kfs[0], 3] == pts[1]
        assert m.kf_pt[kfs[1], 5] == -1
        assert m.kf_pt[kfs[1], 7] == pts[1]
        assert_same_map(m, mj)

    def test_erase_keyframe_reparents(self):
        (m, kfs, pts), (mj, _, _) = both()
        for mm in (m, mj):
            mm.kf_parent[kfs[1]] = kfs[0]
            mm.kf_parent[kfs[2]] = kfs[1]
            order = int(mm.kf_order[kfs[1]])
            mm.erase_keyframe(kfs[1])
        assert m.kf_parent[kfs[2]] == kfs[0]
        assert not m.kf_valid[kfs[1]]
        # the culled keyframe's pose is still recovered through its parent
        np.testing.assert_allclose(m.resolve_kf_pose(kfs[1], order),
                                   mj.resolve_kf_pose(kfs[1], order))
        assert m.resolve_kf_pose(kfs[1], order + 99) is None
        assert_same_map(m, mj)

    def test_slot_reuse(self):
        m, kfs, pts = make_map(tms)
        m.erase_point(pts[0])
        new = m.add_point(np.zeros(3, np.float32), np.zeros(8, np.uint32), kfs[0], 9)
        assert new == pts[0]

    def test_slots_handed_out_match_jax_through_merges_and_erasures(self):
        """The previous-life record kept for the replacement lookup does not
        touch the slot order: on a scripted sequence of hand-outs, merges
        (chains and repeats among them) and erasures both packages hand out
        the same slots at every step, and end with the same map."""
        (m, kfs, pts), (mj, _, _) = both()
        rng = np.random.default_rng(1)
        pos = rng.normal(size=(6, 3)).astype(np.float32)
        desc = rng.integers(0, 2**32, (6, 8), dtype=np.uint32)
        steps = [
            lambda mm: mm.replace_points([(pts[3], pts[4]), (pts[7], pts[8])]),
            lambda mm: [mm.add_point(pos[0], desc[0], kfs[1], 5)],   # slot pts[7]
            lambda mm: mm.add_points_batch(pos[:3], desc[:3], kfs[2], 6).tolist(),
            lambda mm: mm.replace_points([(pts[10], pts[11]), (pts[11], pts[12])]),
            lambda mm: mm.erase_points(np.array([pts[20], pts[4]])),
            lambda mm: [mm.add_point(pos[1], desc[1], kfs[1], 7)],
            lambda mm: mm.replace_points([(pts[7], pts[12])]),   # step 1's point, merged
            lambda mm: mm.add_points_batch(pos, desc, kfs[3], 8).tolist(),
            lambda mm: [mm.add_point(pos[2], desc[2], kfs[0], 9)],
        ]
        for mm in (m, mj):
            observe(mm, kfs, pts)
        for i, step in enumerate(steps):
            got, want = step(m), step(mj)
            assert got == want and m._pt_free == mj._pt_free, i
        # slot pts[7], handed out in steps 1 and 7, records step 1's point
        # (stamp 50), merged into pts[12]
        assert m.pt_prev_stamp[pts[7]] == 50 and m.pt_prev_replaced[pts[7]] == pts[12]
        assert_same_map(m, mj)

    def test_points_batch_and_statistics(self):
        (m, kfs, pts), (mj, _, _) = both()
        rng = np.random.default_rng(3)
        pos = rng.normal(size=(10, 3)).astype(np.float32) + [0, 0, 5]
        desc = rng.integers(0, 2**32, (10, 8), dtype=np.uint32)
        for mm in (m, mj):
            new = mm.add_points_batch(pos, desc, kfs[1], 7)
            mm.kf_pt[kfs[1], :10] = new
            mm.kf_pt[kfs[2], 5:15] = new
            mm.kf_pt[kfs[3], 8:18] = new
            mm.touch_obs()
            mm.update_point_descriptor_and_normal(new, 1.2, 8)
            # points seen by one keyframe only, as a keyframe spawns them
            lone = mm.add_points_batch(pos[:6] + 1.0, desc[:6], kfs[3], 8)
            mm.kf_pt[kfs[3], 30:36] = lone
            mm.touch_obs()
            mm.update_point_descriptor_and_normal(np.concatenate([lone, new[:2]]), 1.2, 8)
            mm.increase_visible(new)
            mm.increase_found(new[:3])
        assert_same_map(m, mj)
        assert (m.pt_max_dist[new] > 0).all()
        np.testing.assert_allclose(np.linalg.norm(m.pt_normal[new], axis=1), 1, atol=1e-5)
        np.testing.assert_array_equal(m.found_ratio(), mj.found_ratio())
        np.testing.assert_array_equal(
            tstats.hamming_np(desc[:5], desc[5:]), jstats.hamming_np(desc[:5], desc[5:]))

    def test_capacity_is_enforced(self):
        m, kfs, pts = make_map(tms)
        got = m.add_points_batch(np.zeros((200, 3), np.float32),
                                 np.zeros((200, 8), np.uint32), kfs[0], 1)
        assert len(got) == 78 and m.free_point_slots() == 0
        with pytest.raises(RuntimeError):
            m.add_point(np.zeros(3, np.float32), np.zeros(8, np.uint32), kfs[0], 1)

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_saved_map_loads_into_the_other_package(self, tmp_path, writer):
        (m, kfs, pts), (mj, _, _) = both()
        for mm in (m, mj):
            observe(mm, kfs, pts)
            mm.kf_loop_edges[kfs[2]].add(kfs[0])
            mm.erase_point(pts[40])
        path = str(tmp_path / "map.npz")
        if writer == "jax":
            mj.save(path)
            loaded = tms.MapState.load(path)
        else:
            m.save(path)
            loaded = jms.MapState.load(path)
        assert_same_map(loaded, m)
        assert loaded._kf_counter == m._kf_counter and loaded._pt_counter == m._pt_counter
        assert loaded.kf_kp_desc.dtype == np.uint32


class TestCovisibility:
    def test_weight_matrix(self):
        (m, kfs, pts), (mj, _, _) = both()
        observe(m, kfs, pts), observe(mj, kfs, pts)
        w = tcov.weight_matrix(m)
        assert w[kfs[0], kfs[1]] == 20
        assert w[kfs[1], kfs[2]] == 5
        assert w[kfs[0], kfs[0]] == 0
        np.testing.assert_array_equal(w, jcov.weight_matrix(mj))

    def test_weight_matrix_on_a_seeded_map(self):
        """The float32 product equals the JAX package's integer weights bit
        for bit on a map with random observations."""
        (m, kfs, pts), (mj, _, _) = both()
        rng = np.random.default_rng(3)
        for k in kfs:
            slots = rng.choice(64, 40, replace=False)
            pids = rng.choice(len(pts), 40, replace=False)
            for mm in (m, mj):
                mm.kf_pt[k, slots] = np.array(pts)[pids]
                mm.touch_obs()
        m.erase_point(pts[7]), mj.erase_point(pts[7])
        w = tcov.weight_matrix(m)
        assert w.dtype == np.int32 and w.max() > 15
        np.testing.assert_array_equal(w, jcov.weight_matrix(mj))

    def test_covisible_neighbors_threshold(self):
        m, kfs, pts = make_map(tms)
        observe(m, kfs, pts)
        w = tcov.weight_matrix(m)
        assert list(tcov.covisible_neighbors(w, kfs[0])) == [kfs[1]]  # kf2 below 15
        # below threshold everywhere -> single best kept
        assert len(tcov.covisible_neighbors(w, kfs[2])) == 1
        np.testing.assert_array_equal(tcov.best_covisible(w, kfs[0], 10),
                                      jcov.best_covisible(w, kfs[0], 10))

    def test_spanning_parent(self):
        m, kfs, pts = make_map(tms)
        observe(m, kfs, pts)
        w = tcov.weight_matrix(m)
        tcov.assign_spanning_parent(m, w, kfs[1])
        assert m.kf_parent[kfs[1]] == kfs[0]
        # parent must be an earlier keyframe
        tcov.assign_spanning_parent(m, w, kfs[0])
        assert m.kf_parent[kfs[0]] == -1

    def test_local_keyframes_and_points(self):
        (m, kfs, pts), (mj, _, _) = both()
        observe(m, kfs, pts), observe(mj, kfs, pts)
        w = tcov.weight_matrix(m)
        frame_pts = np.array(pts[:10], np.int64)
        local, ref = tcov.local_keyframes(m, frame_pts, w)
        local_j, ref_j = jcov.local_keyframes(mj, frame_pts, w)
        assert ref in (kfs[0], kfs[1]) and ref == ref_j
        np.testing.assert_array_equal(local, local_j)
        assert {kfs[0], kfs[1]}.issubset(set(local.tolist()))
        np.testing.assert_array_equal(tcov.local_points(m, local),
                                      jcov.local_points(mj, local_j))
        none, ref = tcov.local_keyframes(m, np.full(4, -1), w)
        assert len(none) == 0 and ref == -1

    def test_essential_edges(self):
        m, kfs, pts = make_map(tms)
        m.kf_parent[kfs[1]] = kfs[0]
        m.kf_loop_edges[kfs[2]].add(kfs[0])
        edges = tcov.essential_edges(m, tcov.weight_matrix(m))
        assert (kfs[0], kfs[1]) in edges and (kfs[0], kfs[2]) in edges


class TestDeviceMapMirror:
    def test_dirty_row_sync(self):
        m, kfs, pts = make_map(tms)
        mir = DeviceMapMirror("cpu")
        mir.sync(m)
        assert mir.n_full_uploads == 1
        np.testing.assert_allclose(mir.pt_pos.numpy(), m.pt_pos)
        assert mir.pt_desc.dtype == torch.int32
        np.testing.assert_array_equal(convert.desc_to_numpy(mir.pt_desc), m.pt_desc)
        # idempotent when clean
        mir.sync(m)
        assert mir.n_full_uploads == 1 and mir.n_row_uploads == 0
        # dirty a few rows -> row upload, values match
        m.pt_pos[pts[3]] = [9, 9, 9]
        m.mark_pts_dirty([pts[3]])
        new_pt = m.add_point(np.array([1, 2, 3], np.float32),
                             np.full(8, 0xFFFFFFFF, np.uint32), kfs[0], 5)
        mir.sync(m)
        assert mir.n_row_uploads == 1 and mir.n_full_uploads == 1
        np.testing.assert_allclose(mir.pt_pos.numpy()[pts[3]], [9, 9, 9])
        np.testing.assert_allclose(mir.pt_pos.numpy()[new_pt], [1, 2, 3])
        assert bool(mir.pt_valid[new_pt]) and (mir.pt_desc[new_pt] == -1).all()
        # erase -> validity propagates
        m.erase_point(pts[0])
        mir.sync(m)
        assert not bool(mir.pt_valid[pts[0]])
        # bulk rewrite -> full upload
        m.pt_pos[:] += 1.0
        m.mark_all_pts_dirty()
        mir.sync(m)
        assert mir.n_full_uploads == 2
        np.testing.assert_allclose(mir.pt_pos.numpy(), m.pt_pos)

    def test_sync_replaces_and_never_rewrites(self):
        """Tensors taken before a sync stay as they were (a thread that took
        them under the map lock keeps a snapshot), on the CPU as well."""
        m, kfs, pts = make_map(tms)
        mir = m.device_mirror("cpu")
        before = mir.pt_pos
        kept = before.clone()
        m.pt_pos[pts[3]] = [9, 9, 9]
        m.mark_pts_dirty([pts[3]])
        m.pt_pos[pts[4]] = [7, 7, 7]      # host write without a sync
        m.device_mirror("cpu")
        assert torch.equal(before, kept) and mir.pt_pos is not before
        np.testing.assert_allclose(mir.pt_pos.numpy()[pts[3]], [9, 9, 9])
        assert not np.allclose(mir.pt_pos.numpy()[pts[4]], [7, 7, 7])

    def test_mirror_survives_map_clear(self):
        m, kfs, pts = make_map(tms)
        mir = m.device_mirror("cpu")
        assert m.device_mirror("cpu") is mir and bool(mir.pt_valid.any())
        gen = mir.gen
        m.clear()  # fresh generation; the mirror must resync, not alias stale
        assert m.pt_dirty_gen != gen
        assert not m.device_mirror("cpu").pt_valid.any()
        with pytest.raises(AttributeError):
            mir.no_such_field


class TestDeviceKFStore:
    def test_matches_jax_store_and_uploads_rows_once(self):
        (m, kfs, _), (mj, _, _) = both()
        store = m.device_kf_store("cpu")
        jstore = mj.device_kf_store()
        assert m.device_kf_store("cpu") is store
        for f, a in store.arrays.items():
            want = np.asarray(jstore.arrays[f])
            got = convert.desc_to_numpy(a) if f == "kf_kp_desc" else a.numpy()
            np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(store.pose.numpy(), np.asarray(jstore.pose))
        assert store.arrays["kf_kp_desc"].dtype == torch.int32
        # a new keyframe: one row upload; a pose change: fresh poses only
        held = store.arrays["kf_kp_xy"]
        rng = np.random.default_rng(1)
        for mm in (m, mj):
            k = mm.add_keyframe(
                pose=np.eye(4, dtype=np.float32), timestamp=9.0, frame_id=9,
                kp_xy=np.full((64, 2), 5.0, np.float32),
                kp_octave=np.ones(64, np.int32), kp_angle=np.zeros(64, np.float32),
                kp_response=np.ones(64, np.float32),
                kp_desc=rng.integers(0, 2**32, (64, 8), dtype=np.uint32),
                kp_valid=np.ones(64, bool), kp_ur=np.full(64, -1, np.float32),
                kp_depth=np.full(64, 2.0, np.float32))
            mm.kf_pose[kfs[1], :3, 3] = [1.0, 2.0, 3.0]
        m.device_kf_store("cpu")
        jstore = mj.device_kf_store()
        assert store.n_row_uploads == 1 and store.arrays["kf_kp_xy"] is not held
        assert (held[k] == 0).all()           # the snapshot kept its rows
        np.testing.assert_array_equal(store.arrays["kf_kp_xy"].numpy(),
                                      np.asarray(jstore.arrays["kf_kp_xy"]))
        np.testing.assert_array_equal(store.pose.numpy()[kfs[1], :3, 3], [1, 2, 3])
        store.sync(m)
        assert store.n_row_uploads == 1       # nothing dirty: no upload
        assert DeviceKFStore("cpu").device.type == "cpu"
