"""Parity of orbslam2_tpu_torch.ops.hamming with the JAX package: the
distance matrix and the row-aligned distances, best and second and mutual
best, and the rotation-consistency mask; integer results must be equal,
ties included (ops.match is in test_torch_match.py)."""
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import hamming as jham
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.ops import hamming as tham

from torch_port_helpers import j, n, t
from test_torch_match import _descs


def test_distance_matrix_and_pairwise_are_exact(rng):
    a, b = _descs(rng, 70), _descs(rng, 90)
    a[0] = 0xFFFFFFFF                      # every sign bit of the int32 view
    b[0] = 0
    va, vb = rng.uniform(size=70) < 0.8, rng.uniform(size=90) < 0.8
    want = n(jham.distance_matrix(j(a), j(b), j(va), j(vb)))
    got = tham.distance_matrix(convert.desc_from_numpy(a), convert.desc_from_numpy(b),
                               t(va), t(vb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), want)
    assert want[0, 0] in (256, jham.INVALID_DIST)
    brute = np.unpackbits((a[:, None] ^ b[None]).view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(
        n(tham.distance_matrix(convert.desc_from_numpy(a), convert.desc_from_numpy(b))),
        brute)
    np.testing.assert_array_equal(
        n(tham.pairwise_distance(convert.desc_from_numpy(a), convert.desc_from_numpy(b[:70]))),
        n(jham.pairwise_distance(j(a), j(b[:70]))))
    assert (tham.TH_HIGH, tham.TH_LOW, tham.HISTO_LENGTH, tham.INVALID_DIST) == \
        (jham.TH_HIGH, jham.TH_LOW, jham.HISTO_LENGTH, jham.INVALID_DIST)


@pytest.mark.parametrize("with_mask", [False, True])
def test_best_and_second_and_mutual_best_with_ties(rng, with_mask):
    dist = rng.integers(0, 6, (60, 40)).astype(np.int32)      # ties in every row
    dist[5] = jham.INVALID_DIST
    mask = (rng.uniform(size=dist.shape) < 0.7) if with_mask else None
    want = jham.best_and_second(j(dist), None if mask is None else j(mask))
    got = tham.best_and_second(t(dist), None if mask is None else t(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    np.testing.assert_array_equal(
        n(tham.mutual_best(t(dist), None if mask is None else t(mask))),
        n(jham.mutual_best(j(dist), None if mask is None else j(mask))))


@pytest.mark.parametrize("case", ["ties", "weak_bins", "random", "none_valid"])
def test_rotation_consistency_mask(rng, case):
    m = 240
    a = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    valid = rng.uniform(size=m) < 0.8
    if case == "ties":
        # exactly equal counts in four bins: the top three must be the three
        # lowest bins, as lax.top_k breaks ties
        centers = (np.array([3, 9, 17, 25]) + 0.5) * (2 * np.pi / 30)
        b = (a - np.repeat(centers, m // 4)).astype(np.float32)
        valid[:] = True
    elif case == "weak_bins":
        # one dominant bin, the others below a tenth of it
        b = (a - 1.0).astype(np.float32)
        b[:6] = a[:6] - np.array([2.0, 2.0, 3.0, 3.0, 4.0, 5.0], np.float32)
    elif case == "none_valid":
        b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
        valid[:] = False
    else:
        b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    want = n(jham.rotation_consistency_mask(j(a), j(b), j(valid)))
    got = n(tham.rotation_consistency_mask(t(a), t(b), t(valid)))
    np.testing.assert_array_equal(got, want)
    if case == "ties":
        assert 0.7 < got.mean() < 0.8
