"""Place recognition of the port against the JAX package, on the CPU: the
vocabulary descent, BoW vectors and scores, and the keyframe database's
candidate lists.

Word ids must be identical, ties included: the JAX package takes the child
with the largest {-1,+1} product (the lowest index on a tie, dead children
never); a different tie rule would change the words and every score after
them. The descriptors are those of a rendered 640x480 frame with 2000
features on 8 levels (extracted by the port on the CPU), plus crafted sets
whose every descent step ties. Candidate lists of the keyframe database
must be identical too; scores agree to float32 rounding (1e-6).
"""
import filecmp
import os

import numpy as np
import pytest
import torch

import orbslam2_tpu.place.pretrained as jpretrained
from orbslam2_tpu.place import vocabulary as jvoc
from orbslam2_tpu.slammap.keyframe_db import KeyFrameDatabase as JKFDB
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig, ORBExtractor
from orbslam2_tpu_torch.place import pretrained, vocabulary
from orbslam2_tpu_torch.slammap.keyframe_db import KeyFrameDatabase

from torch_port_helpers import j, n, t

TIERS = ("k10l3_lp", "k10l4_lp", "k10l3")


@pytest.fixture(scope="module")
def frame_desc():
    """Descriptors (uint32 words) and validity of a rendered 640x480 frame,
    2000 features on 8 levels."""
    cam = PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0, width=640,
                        height=480, bf=40.0)
    gray, _ = SyntheticSequence(cam, n_frames=2, trajectory="shuttle", seed=3,
                                world="cluttered").render(0)
    kp = ORBExtractor(ORBConfig(n_features=2000, n_levels=8), (480, 640), "cpu")(
        t(gray, torch.float32))
    return convert.desc_to_numpy(kp.desc), n(kp.valid)


@pytest.mark.parametrize("tier", TIERS)
def test_vocabulary_data_is_the_jax_packages(tier):
    name = f"default_voc_{tier}.npz"
    ours = os.path.join(os.path.dirname(pretrained.__file__), "data", name)
    theirs = os.path.join(os.path.dirname(jpretrained.__file__), "data", name)
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_pretrained_tiers():
    assert pretrained.get_default_vocabulary().n_words == 1000
    assert pretrained.get_large_vocabulary().n_words == 10000
    assert pretrained.get_default_vocabulary("gaussian").n_words == 1000
    # no 10 000-word tree for the Gaussian pattern: the default one
    assert pretrained.get_large_vocabulary("gaussian").n_words == 1000


def _jax_voc(voc):
    return jvoc.Vocabulary(k=voc.k, levels=voc.levels, centers=voc.centers,
                           word_weights=voc.word_weights, n_words=voc.n_words)


@pytest.mark.parametrize("tier", ["k10l3_lp", "k10l4_lp"])
def test_transform_matches_jax_on_a_rendered_frame(frame_desc, tier):
    desc, valid = frame_desc
    voc = vocabulary.load_vocabulary(os.path.join(
        os.path.dirname(pretrained.__file__), "data", f"default_voc_{tier}.npz"))
    ids_t = n(voc.transform_packed(convert.desc_from_numpy(desc), t(valid)))
    ids_j = np.asarray(_jax_voc(voc).transform_packed(j(desc), j(valid)))
    assert valid.sum() > 1000
    np.testing.assert_array_equal(ids_t, ids_j)
    assert (ids_t[~valid] == -1).all()
    # BoW vector and L1 score of two halves of the frame
    a, b = ids_t[:1000], ids_t[1000:]
    jv = _jax_voc(voc)
    np.testing.assert_allclose(voc.bow_vector(a), jv.bow_vector(a), atol=1e-7)
    assert abs(voc.score_l1(voc.bow_vector(a), voc.bow_vector(b))
               - jv.score_l1(jv.bow_vector(a), jv.bow_vector(b))) < 1e-6


def test_transform_ties_go_to_the_lowest_child():
    """A tree in which descent steps tie: children 0 and 1 of every node
    share a centre, child 2 is dead, child 3 is random; each level-1 node's
    twin children carry their parent's centre. A descriptor on a level-0
    centre then ties at both levels and must take child 0 at each, in both
    packages; random descriptors must never land on a twin or a dead child."""
    rng = np.random.default_rng(0)
    k = 4
    c0 = rng.choice([-1, 1], size=(k, 256)).astype(np.int8)
    c0[1], c0[2] = c0[0], 0
    c1 = rng.choice([-1, 1], size=(k * k, 256)).astype(np.int8)
    c1[0::k], c1[1::k], c1[2::k] = c0, c0, 0
    voc = convert.vocabulary_from_numpy(k, 2, [c0, c1], np.ones(k * k, np.float32), k * k)
    bits = np.concatenate([c0[[0, 1, 3]] > 0,
                           rng.integers(0, 2, (60, 256)).astype(bool)]).astype(np.uint8)
    words = np.packbits(bits, axis=1, bitorder="little").view("<u4")
    valid = np.ones(len(words), bool)
    valid[-3:] = False
    ids_t = n(voc.transform_packed(convert.desc_from_numpy(words), t(valid)))
    ids_j = np.asarray(_jax_voc(voc).transform_packed(j(words), j(valid)))
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(ids_t[:3], [0, 0, 12])
    assert not np.isin(ids_t[valid] % k, [1, 2]).any()
    assert not np.isin(ids_t[valid] // k, [1, 2]).any()


def _database(seed):
    """A keyframe database over the 1000-word tree: 12 keyframes on three
    scenes (words drawn around a scene's own word set), a covisibility
    matrix chaining neighbours, one slot erased."""
    rng = np.random.default_rng(seed)
    voc = pretrained.get_default_vocabulary()
    scenes = [rng.choice(1000, 300, replace=False) for _ in range(3)]
    kf_words = [np.where(rng.uniform(size=400) < 0.8,
                         rng.choice(scenes[kf % 3], 400),
                         rng.integers(0, 1000, 400)) for kf in range(12)]
    w = np.zeros((16, 16), np.int32)
    for kf in range(11):
        w[kf, kf + 1] = w[kf + 1, kf] = 30 - 2 * kf
    w[0, 6] = w[6, 0] = 20
    dbs = [JKFDB(_jax_voc(voc), 16), KeyFrameDatabase(voc, 16)]
    for db in dbs:
        for kf, words in enumerate(kf_words):
            db.add(kf, words)
        db.erase(9)
    return voc, dbs, w, rng, scenes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keyframe_database_candidates_match_jax(seed):
    voc, (db_j, db_t), w, rng, scenes = _database(seed)
    np.testing.assert_array_equal(db_t.wids, db_j.wids)
    np.testing.assert_allclose(db_t.wts, db_j.wts, atol=1e-7)

    class NoMap:
        pass
    for kf in (11, 10, 7):
        q = db_t.dense_bow(kf)
        np.testing.assert_allclose(q, db_j.dense_bow(kf), atol=1e-7)
        recent = np.abs(np.arange(16) - kf) <= 2
        for min_score in (0.0, 0.02, 0.05):
            got = db_t.detect_loop_candidates(kf, min_score, w, NoMap(),
                                              exclude_mask=recent, query_bow=q)
            want = db_j.detect_loop_candidates(kf, min_score, w, NoMap(),
                                               exclude_mask=recent, query_bow=q)
            assert got == want
    for scene in range(3):
        query = rng.choice(scenes[scene], 300)
        got = db_t.detect_reloc_candidates(query, w)
        assert got == db_j.detect_reloc_candidates(query, w)
        assert got and got[0] % 3 == scene
    np.testing.assert_allclose(db_t.score_against_all(q), db_j.score_against_all(q),
                               atol=1e-6)


def test_keyframe_database_from_numpy():
    voc, (db_j, _), w, _, _ = _database(3)
    db = convert.keyframe_db_from_numpy(voc, db_j.wids, db_j.wts, db_j.valid)
    np.testing.assert_array_equal(db.wids, db_j.wids)
    assert db.detect_reloc_candidates(db_j.wids[4][db_j.wids[4] >= 0], w) \
        == db_j.detect_reloc_candidates(db_j.wids[4][db_j.wids[4] >= 0], w)
    db.wids[0] = -1                                 # a copy, not a view
    assert (db_j.wids[0] >= 0).any()
