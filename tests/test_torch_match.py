"""Parity of orbslam2_tpu_torch.ops.match with the JAX package: conflict
resolution, the windowed match and the predicted scale level; integer
results must be equal, ties included (ops.hamming is in
test_torch_hamming.py)."""
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import match as jmatch
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.ops import match as tmatch

from torch_port_helpers import (j, jax_keypoints, n, random_keypoints, t,
                                torch_keypoints)


def _descs(rng, m, near=None, flips=20):
    d = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    if near is not None:      # the `near` rows with a few bits flipped
        src = near
        mask = np.zeros((m, 256), np.uint8)
        for r in range(m):
            mask[r, rng.choice(256, rng.integers(0, flips), replace=False)] = 1
        d = src ^ np.packbits(mask, axis=1, bitorder="little").view(np.uint32)
    return d


def test_resolve_conflicts(rng):
    best_kp = rng.integers(-1, 12, 80).astype(np.int32)       # many conflicts
    best_dist = rng.integers(0, 5, 80).astype(np.int32)       # and ties
    want = n(jmatch.resolve_conflicts(j(best_kp), j(best_dist), 12))
    got = n(tmatch.resolve_conflicts(t(best_kp), t(best_dist), 12))
    np.testing.assert_array_equal(got, want)
    none = np.full(8, -1, np.int32)
    np.testing.assert_array_equal(
        n(tmatch.resolve_conflicts(t(none), t(best_dist[:8]), 5)), np.full(5, -1))


@pytest.mark.parametrize("ratio,free", [(None, False), (0.8, True), (0.9, False)])
def test_windowed_match(rng, ratio, free):
    kp = random_keypoints(rng, 150)
    kp["octave"][:] = rng.integers(0, 3, 150)
    p = 110
    src = rng.integers(0, 150, p)
    q_desc = _descs(rng, p, near=kp["desc"][src])
    q_uv = (kp["xy"][src] + rng.normal(size=(p, 2)) * 4).astype(np.float32)
    q_valid = rng.uniform(size=p) < 0.9
    radius = rng.uniform(3, 25, p).astype(np.float32)
    lo = rng.integers(0, 3, p).astype(np.int32)
    hi = (lo + rng.integers(0, 2, p)).astype(np.int32)
    kp_free = (rng.uniform(size=150) < 0.8) if free else None
    want = jmatch.windowed_match(
        j(q_uv), j(q_desc), j(q_valid), j(radius), j(lo), j(hi),
        jax_keypoints(kp), max_dist=100, ratio=ratio,
        kp_free=None if kp_free is None else j(kp_free))
    got = tmatch.windowed_match(
        t(q_uv), convert.desc_from_numpy(q_desc), t(q_valid), t(radius), t(lo), t(hi),
        torch_keypoints(kp), max_dist=100, ratio=ratio,
        kp_free=None if kp_free is None else t(kp_free))
    assert (n(want.best_kp) >= 0).sum() > 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


def test_predict_scale_level(rng):
    dist = rng.uniform(0.2, 20, 300).astype(np.float32)
    max_dist = rng.uniform(1, 30, 300).astype(np.float32)
    want = n(jmatch.predict_scale_level(j(dist), j(max_dist), 1.2, 8))
    got = tmatch.predict_scale_level(t(dist), t(max_dist), 1.2, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), want)
