"""Vocabulary training of the port against the JAX package, on the CPU.

``train_vocabulary`` must give the JAX package's tree bit for bit: the same
centres at every level and the same idf weights, for the same corpus and
seed. The assignments are float32 products of {-1, +1} bits (exact), the
majority votes integer counts, and the host's random stream is drawn in the
JAX package's order (the fit_cap subsample, the seeds, a row for each empty
cluster), so any difference is a fault, not rounding. Also: the npz format
both ways, the vocabulary tiers, ``force_retrain`` writing into the data
directory (pointed at a temporary one), and the int8 centre tables on the
device giving the word ids of a float32 descent.
"""
import os
import warnings

import numpy as np
import pytest
import torch

from orbslam2_tpu.place import vocabulary as jvoc
from orbslam2_tpu_torch.place import pretrained, vocabulary

from torch_port_helpers import n


def _corpus(n_clusters, per_cluster, flip, seed=0):
    """Packed uint32 descriptors drawn around random centres, each bit
    flipped with probability ``flip``."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 2, (n_clusters, 256)).astype(np.uint8)
    bits = np.repeat(centres, per_cluster, axis=0)
    bits ^= (rng.uniform(size=bits.shape) < flip).astype(np.uint8)
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


CASES = {
    # k=10 depth 2, every node a clustering of tens of rows
    "k10_l2": dict(corpus=(30, 40, 0.1), k=10, levels=2, seed=3),
    # k=4 depth 3
    "k4_l3": dict(corpus=(20, 30, 0.15), k=4, levels=3, seed=5),
    # 3 distinct rows, 5 copies each: 10 seeds from 15 rows leave children
    # that no row is nearest to, which take a random row of the node
    "empty_clusters": dict(corpus=(3, 5, 0.0), k=10, levels=2, seed=1),
    # the rounds on 150 of each node's rows, the assignment in chunks of 64
    "fit_cap_and_chunks": dict(corpus=(25, 24, 0.12), k=6, levels=2, seed=9,
                               fit_cap=150, assign_chunk=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_vocabulary_matches_jax(case):
    kw = dict(CASES[case])
    corpus = _corpus(*kw.pop("corpus"))
    theirs = jvoc.train_vocabulary(corpus, **kw)
    ours = vocabulary.train_vocabulary(corpus, device="cpu", **kw)
    assert (ours.k, ours.levels, ours.n_words) == (theirs.k, theirs.levels, theirs.n_words)
    for a, b in zip(ours.centers, theirs.centers):
        assert a.dtype == b.dtype == np.int8
        np.testing.assert_array_equal(a, b)
    assert ours.word_weights.dtype == np.float32
    np.testing.assert_array_equal(ours.word_weights, theirs.word_weights)
    if case == "empty_clusters":
        # nodes with fewer rows than k leave dead slots; the first level's
        # children all hold one of the three rows
        assert (ours.centers[1] == 0).all(axis=1).any()


def test_a_corpus_as_the_ports_tensor():
    corpus = _corpus(12, 10, 0.1, seed=2)
    a = vocabulary.train_vocabulary(corpus, k=5, levels=2, seed=4, device="cpu")
    b = vocabulary.train_vocabulary(torch.from_numpy(corpus.view(np.int32)), k=5, levels=2,
                                    seed=4, device="cpu")
    for x, y in zip(a.centers, b.centers):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.word_weights, b.word_weights)


def test_save_and_load_across_packages(tmp_path):
    corpus = _corpus(20, 20, 0.1, seed=6)
    ours = vocabulary.train_vocabulary(corpus, k=4, levels=2, seed=2, device="cpu")
    vocabulary.save_vocabulary(ours, str(tmp_path / "ours.npz"))
    back = jvoc.load_vocabulary(str(tmp_path / "ours.npz"))
    jvoc.save_vocabulary(back, str(tmp_path / "theirs.npz"))
    again = vocabulary.load_vocabulary(str(tmp_path / "theirs.npz"))
    for voc in (back, again):
        assert (voc.k, voc.levels, voc.n_words) == (ours.k, ours.levels, ours.n_words)
        for a, b in zip(voc.centers, ours.centers):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(voc.word_weights, ours.word_weights)


def test_vocabulary_tiers(tmp_path, monkeypatch):
    """The largest tree in the data directory: the shipped one today is the
    10 000-word tree; a depth-5 tree of the pattern is taken first, and one
    of the other pattern with a warning."""
    assert pretrained.get_best_vocabulary().n_words == 10000
    assert pretrained.get_best_vocabulary("gaussian").n_words == 1000
    tiny = vocabulary.train_vocabulary(_corpus(8, 8, 0.1), k=2, levels=2, seed=0,
                                       device="cpu")
    monkeypatch.setattr(pretrained, "_DATA", str(tmp_path))
    vocabulary.save_vocabulary(tiny, str(tmp_path / "default_voc_k10l5.npz"))
    with pytest.warns(UserWarning, match="different descriptor pattern"):
        assert pretrained.get_best_vocabulary().n_words == 4
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pretrained.get_best_vocabulary("gaussian").n_words == 4
    vocabulary.save_vocabulary(tiny, str(tmp_path / "default_voc_k10l6_lp.npz"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pretrained.get_best_vocabulary().n_words == 4


def test_force_retrain_writes_into_the_data_directory(tmp_path, monkeypatch):
    """get_default_vocabulary(force_retrain=True) trains the default tree
    (k=10, depth 3, seed 7) on the corpus and saves it into ``_DATA``, here a
    temporary directory: the shipped file is left as it was. The corpus is
    replaced by a small one: extracting the 12 textures on the CPU takes
    about 15 s (chip_smoke.py phase 18e extracts and trains it on the card)."""
    shipped = os.path.join(pretrained._DATA, "default_voc_k10l3_lp.npz")
    before = os.path.getmtime(shipped)
    corpus = torch.from_numpy(_corpus(40, 25, 0.1, seed=8).view(np.int32))
    calls = []

    def small_corpus(device, pattern_kind):
        calls.append((str(device), pattern_kind))
        return corpus

    monkeypatch.setattr(pretrained, "default_training_corpus", small_corpus)
    monkeypatch.setattr(pretrained, "_DATA", str(tmp_path))
    voc = pretrained.get_default_vocabulary(force_retrain=True, device="cpu")
    assert calls == [("cpu", "learned")]
    written = tmp_path / "default_voc_k10l3_lp.npz"
    assert written.exists() and os.listdir(tmp_path) == [written.name]
    assert os.path.getmtime(shipped) == before
    want = vocabulary.train_vocabulary(corpus, k=10, levels=3, seed=7, device="cpu")
    loaded = pretrained.get_default_vocabulary()          # from tmp_path, no retraining
    assert len(calls) == 1
    for v in (voc, loaded):
        for a, b in zip(v.centers, want.centers):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(v.word_weights, want.word_weights)


def test_int8_tables_give_the_float32_descent():
    """The centre tables stay int8 on the device (a depth-6 tree is about
    0.26 GB so, 1 GB as float32); only the gathered rows become float32. The
    word ids equal those of a descent over float32 tables."""
    voc = pretrained.get_large_vocabulary()
    tables = voc.device_centers("cpu")
    assert all(t.dtype == torch.int8 for t in tables)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (500, 256))
    pm1 = torch.tensor(bits * 2 - 1, dtype=torch.float32)
    valid = torch.ones(500, dtype=torch.bool)
    ids = n(voc.transform_pm1(pm1, valid))
    node = np.zeros(500, np.int64)
    for lvl, c in enumerate(voc.centers):
        cand = c.astype(np.float32)[node[:, None] * voc.k + np.arange(voc.k)]   # [N, k, 256]
        dots = np.einsum("nd,nkd->nk", pm1.numpy(), cand)
        dots[np.abs(cand).sum(-1) == 0] = -1e9
        node = node * voc.k + dots.argmax(axis=1)
    np.testing.assert_array_equal(ids, node)
