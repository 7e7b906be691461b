"""The port's replacement table and where a frame's ids are brought up to
date with it, on small hand-made maps (no drive, no JAX package):
``MapState.pt_replaced`` / ``resolve_replaced`` (MapPoint::mpReplaced and
its lookup) and ``Tracker._check_replaced`` (Tracking::CheckReplacedInLastFrame,
extended to the one-frame-lagged local selection). The drives that show the
repair against the JAX package are in tests/test_torch_mono.py; the
temporal points after a relocalization are in tests/test_torch_localization.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from orbslam2_tpu_torch.frontend.tracking import Tracker
from orbslam2_tpu_torch.ops.orb import DESC_WORDS
from orbslam2_tpu_torch.slammap.mapstate import MapCapacity, MapState

N_POINTS = 8


def _map():
    """A map of 8 points (ids 0-7, stamps 0-7) -> (map, the stamp after)."""
    m = MapState(MapCapacity(max_keyframes=4, max_points=16, n_features=8))
    for i in range(N_POINTS):
        assert m.add_point(np.full(3, i, np.float32), np.zeros(DESC_WORDS, np.uint32), 0, 0) == i
    return m, m._pt_counter


def _new_point(m):
    return m.add_point(np.ones(3, np.float32), np.ones(DESC_WORDS, np.uint32), 0, 1)


def _chain(m):
    m.replace_points([(0, 1)])
    m.replace_points([(1, 2)])        # a later call: 0 -> 1 -> 2


def _cycle(m):
    m.replace_points([(4, 5), (5, 4)])   # one call: 4 keeps, 5 -> 4


def _handed_out_again(m):
    m.replace_points([(3, 2)])
    assert _new_point(m) == 3         # the free list hands the victim out first


def _handed_out_by_batch(m):
    m.replace_points([(3, 2)])
    assert m.add_points_batch(np.ones((1, 3), np.float32), np.ones((1, DESC_WORDS), np.uint32),
                              0, 1).tolist() == [3]


def _handed_out_twice(m):
    m.replace_points([(3, 2)])
    assert _new_point(m) == 3
    m.erase_point(3)
    assert _new_point(m) == 3         # the life the snapshot meant is two back


def _erased_then_handed_out(m):
    m.erase_point(6)
    assert _new_point(m) == 6


def _snapshot_after_the_reuse(m):
    _handed_out_again(m)
    return m._pt_counter              # 3 is the new point to this holder


def _reused_then_merged_again(m):
    _handed_out_again(m)
    m.replace_points([(3, 4)])        # the new life of slot 3 merged as well


def _merged_again_after_a_later_snapshot(m):
    _handed_out_again(m)
    snap = m._pt_counter
    m.replace_points([(3, 4)])
    return snap


def _chain_through_a_slot_handed_out_again(m):
    m.replace_points([(0, 1)])
    m.replace_points([(1, 2)])
    assert _new_point(m) == 1         # 0's chain passes through slot 1


def _erased(m):
    m.erase_point(6)


def _table_cycle(m):
    """A cycle in the table itself (replace_points never writes one): the
    lookup ends within the capacity."""
    m.replace_points([(6, 7)])
    m.pt_valid[7] = False
    m.pt_replaced[7], m.pt_replaced_stamp[7] = 6, m.pt_stamp[6]


# change -> (ids resolved, how many through a previous life, how many lost to
# a slot handed out twice, what the slot of the next new point resolves to)
@pytest.mark.parametrize("change, want, reused, lost, then", [
    (_chain, {0: 2, 1: 2, 2: 2, 3: 3}, 0, 0, 2),
    (_cycle, {4: 4, 5: 4}, 0, 0, 4),
    (_handed_out_again, {3: 2, 2: 2}, 1, 0, -1),
    (_handed_out_by_batch, {3: 2, 2: 2}, 1, 0, -1),
    (_handed_out_twice, {3: -1, 2: 2}, 0, 1, -1),
    (_erased_then_handed_out, {6: -1, 7: 7}, 0, 0, -1),
    (_snapshot_after_the_reuse, {3: 3, 2: 2}, 0, 0, -1),
    (_reused_then_merged_again, {3: 2, 4: 4}, 1, 0, -1),
    (_merged_again_after_a_later_snapshot, {3: 4, 2: 2}, 0, 0, 4),
    (_chain_through_a_slot_handed_out_again, {0: 2, 1: 2, 2: 2}, 2, 0, 2),
    (_erased, {6: -1, 7: 7}, 0, 0, -1),
    (_table_cycle, {6: -1, 7: -1}, 0, 0, -1),
], ids=["chain", "cycle", "handed_out_again", "handed_out_by_batch", "handed_out_twice",
        "erased_then_handed_out", "snapshot_after_the_reuse", "reused_then_merged_again",
        "merged_again_after_a_later_snapshot", "chain_through_a_reused_slot", "erased",
        "table_cycle"])
def test_resolve_replaced(change, want, reused, lost, then):
    m, snap = _map()
    snap = change(m) or snap
    ids = np.array(list(want) + [-1], np.int32)
    got, n_reused, n_lost = m.resolve_replaced(ids, snap)
    assert got.dtype == np.int32
    assert got.tolist() == list(want.values()) + [-1]
    assert (n_reused, n_lost) == (reused, lost)
    # a point made after the snapshot is no id the snapshot's holder had:
    # its slot resolves to the life the holder meant by it, or to -1 where
    # the slot was new to the holder or is now handed out twice
    new = _new_point(m)
    assert m.resolve_replaced(np.array([new]), snap)[0].tolist() == [then] != [new]


def test_the_table_is_reset_by_clear_and_not_saved(tmp_path):
    m, _ = _map()
    _chain(m)
    _new_point(m)
    assert m.pt_replaced[0] == 1 and m.pt_prev_replaced[1] == 2 and m.pt_prev_stamp[1] == 1
    table = ("pt_replaced", "pt_replaced_stamp", "pt_prev_stamp", "pt_prev_replaced",
             "pt_prev_replaced_stamp")
    path = str(tmp_path / "map.npz")
    m.save(path)
    assert not set(table) & set(np.load(path).files)    # the JAX package's format
    loaded = MapState.load(path)
    m.clear()
    for f in table:
        assert (getattr(loaded, f) == -1).all() and (getattr(m, f) == -1).all(), f


def _tracker(m, snap, last_ids, local):
    """A Tracker shell holding only what _check_replaced reads."""
    tr = object.__new__(Tracker)
    tr.map, tr.remapped_ids, tr.reused_slot_ids, tr.replacements_lost = m, 0, 0, 0
    tr.last_frame = SimpleNamespace(pt_ids=np.array(last_ids, np.int32), pt_stamp=snap)
    cap = 6
    tr._local_pts = np.array(local, np.int64)
    tr._local_ids = np.zeros(cap, np.int32)
    tr._local_ids[:len(local)] = local
    tr._local_sel = np.arange(cap) < len(local)
    tr._local_stamp = snap
    tr._last_pid_dev = "carry"
    return tr


def test_check_replaced_remaps_the_last_frame_and_the_selection():
    m, snap = _map()
    m.replace_points([(1, 2), (3, 4)])
    m.erase_point(5)
    assert _new_point(m) == 5         # erased, then handed out again
    tr = _tracker(m, snap, [1, -1, 3, 6, 5], [1, 3, 4, 5, 6])
    tr._check_replaced()
    assert tr.last_frame.pt_ids.tolist() == [2, -1, 4, 6, -1]
    assert tr.remapped_ids == 2 and tr._last_pid_dev is None
    # 1 -> 2 takes 1's place in the candidate order; 3 -> 4 is in the list
    # already, and slot 5 now holds another point: both deselected
    assert tr._local_pts.tolist() == [2, 3, 4, 5, 6]
    assert tr._local_ids[:5].tolist() == [2, 3, 4, 5, 6]
    assert tr._local_sel.tolist() == [True, False, True, False, True, False]
    assert tr.last_frame.pt_stamp == tr._local_stamp == m._pt_counter
    # brought up to date, the ids stand: a second call changes nothing
    tr._check_replaced()
    assert tr.last_frame.pt_ids.tolist() == [2, -1, 4, 6, -1] and tr.remapped_ids == 2
    assert (tr.reused_slot_ids, tr.replacements_lost) == (0, 0)


def test_check_replaced_follows_a_reused_slots_previous_life():
    """Merged points whose slots are handed out again before the next frame
    resolve to their replacements in the last frame and the selection, and
    are counted; a slot handed out twice is lost, and counted."""
    m, snap = _map()
    m.replace_points([(1, 2), (3, 4)])
    assert [_new_point(m), _new_point(m)] == [3, 1]
    m.replace_points([(5, 6)])
    assert _new_point(m) == 5
    m.erase_point(5)
    assert _new_point(m) == 5         # the merged life of slot 5 is two back
    tr = _tracker(m, snap, [1, -1, 3, 7, 5], [1, 3, 4, 5, 6])
    tr._check_replaced()
    assert tr.last_frame.pt_ids.tolist() == [2, -1, 4, 7, -1]
    assert tr.remapped_ids == 2 and tr._last_pid_dev is None
    # last frame: 1 and 3 resolved, 5 lost; selection: the same three ids
    assert (tr.reused_slot_ids, tr.replacements_lost) == (4, 2)
    assert tr._local_pts.tolist() == [2, 3, 4, 5, 6]
    assert tr._local_sel.tolist() == [True, False, True, False, True, False]
    tr._check_replaced()
    assert (tr.reused_slot_ids, tr.replacements_lost, tr.remapped_ids) == (4, 2, 2)
    assert tr.last_frame.pt_ids.tolist() == [2, -1, 4, 7, -1]


def test_an_erased_point_keeps_the_device_carry():
    """The device step reads an erased id as no point already: the carry
    stays, and the host's id becomes -1."""
    m, snap = _map()
    m.erase_point(2)
    tr = _tracker(m, snap, [1, 2, 3], [1, 2, 3])
    tr._check_replaced()
    assert tr.last_frame.pt_ids.tolist() == [1, -1, 3]
    assert tr._last_pid_dev == "carry" and tr.remapped_ids == 0
    assert tr._local_sel[:3].tolist() == [True, False, True]
