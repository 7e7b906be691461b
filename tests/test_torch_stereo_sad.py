"""The port's stereo SAD search and its median sweep (ops/stereo.py) against
the JAX package's, on crafted inputs, on the CPU (the matcher on a rendered
pair is in test_torch_stereo.py).

On integer-valued images the SAD sums are exact, so both packages' outputs
are identical.
"""
import numpy as np
import pytest

from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.ops import stereo as jst
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.ops import stereo as tst

from torch_port_helpers import j, jax_keypoints, n, t, torch_keypoints
from test_torch_stereo import CAM_KW, SF


def _crafted_level(seed, lh=40, lw=64):
    """Integer-valued left/right blocks (exact float32 sums): a textured
    left image, the right one shifted by 7 columns, and a flat band where
    every SAD ties."""
    rng = np.random.default_rng(seed)
    bl = rng.integers(0, 256, (lh, lw)).astype(np.float32)
    br = np.roll(bl, -7, axis=1)
    bl[26:, :] = 77.0
    br[26:, :] = 77.0
    return bl, br


@pytest.mark.parametrize("s", [1.0, SF ** 2])
def test_sad_level_on_crafted_blocks(s):
    """Keypoints at every margin (windows clamped into the image, `safe`
    false), SAD minima at both ends of the strip and inside it, and tied
    SADs on a flat band: identical outputs."""
    bl, br = _crafted_level(int(s * 10))
    lh, lw = bl.shape
    xs, ys, xr0 = [], [], []
    for x in (0, 2, 5, 6, 20, 40, lw - 6, lw - 5, lw - 1):       # every column margin
        for y in (0, 4, 5, 15, lh - 6, lh - 5, lh - 1):           # every row margin
            xs.append(x)
            ys.append(y)
            xr0.append(x - 7)                                      # the true match
    for x in (20, 24, 30, 40):
        for off in (-5, -3, 0, 2, 5):                              # ends and inside
            xs.append(x)
            ys.append(12)
            xr0.append(x - 7 - off)
        xs.append(x)
        ys.append(34)                                              # flat band: ties
        xr0.append(x - 7)
    xy = np.stack([np.array(xs, np.float32), np.array(ys, np.float32)], 1) * np.float32(s)
    ur0 = np.array(xr0, np.float32) * np.float32(s)
    ur_j, safe_j = jst._sad_level(j(bl), j(br), j(xy), j(ur0), s)
    ur_t, safe_t = tst._sad_level(t(bl), t(br), t(xy), t(ur0), s)
    np.testing.assert_array_equal(n(safe_t), n(safe_j))
    np.testing.assert_array_equal(n(ur_t), n(ur_j))
    safe = n(safe_t)
    assert safe.any() and (~safe).sum() > 20
    xr = np.round(ur0 / np.float32(s))
    steps = np.round(n(ur_t) / np.float32(s) - xr)
    # every end of the strip and the ties (first minimum: offset -5) occur
    assert {-5, 5} <= set(steps[safe].astype(int).tolist())


@pytest.mark.parametrize("dists", [
    [5, 5, 10, 10, 10, 10, 21, 22, 40, 60, 99, 100],   # even count, ties at the median
    [7, 7, 7, 30, 30, 30, 30, 64, 64, 90, 120],         # odd count, one beyond TH_HIGH
    [30] * 12,                                          # every distance equal
    [101, 120, 150, 200],                               # nothing within TH_HIGH
], ids=["even_ties", "odd", "all_equal", "none"])
def test_median_sweep_with_ties(dists):
    """Left keypoint i can only match right keypoint i (own row), at Hamming
    distance dists[i]; the sweep keeps d <= 2.1 * the median over the sorted
    matched distances padded with INVALID_DIST, index n_m // 2."""
    k = len(dists)
    rng = np.random.default_rng(len(dists))
    desc_l = rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint32)
    bits = np.unpackbits(desc_l.view(np.uint8), axis=1)
    for i, d in enumerate(dists):
        bits[i, rng.choice(256, d, replace=False)] ^= 1
    desc_r = np.packbits(bits, axis=1).view(np.uint32)
    y = 8.0 + 12.0 * np.arange(k)
    base = dict(response=np.ones(k, np.float32), angle=np.zeros(k, np.float32),
                octave=np.zeros(k, np.int32), size=np.full(k, 31.0, np.float32),
                valid=np.ones(k, bool))
    kl = dict(base, xy=np.stack([np.full(k, 100.0), y], 1).astype(np.float32), desc=desc_l)
    kr = dict(base, xy=np.stack([np.full(k, 90.0), y], 1).astype(np.float32), desc=desc_r)
    img = np.full((8 + 12 * k, 200), 50.0, np.float32)
    cam = dict(CAM_KW, width=200, height=img.shape[0])
    ur_j, d_j = jst.match_stereo(jax_keypoints(kl), jax_keypoints(kr), (j(img),), (j(img),),
                                 JCamera(**cam), SF, 1, level_budgets=(k,))
    ur_t, d_t = tst.match_stereo(torch_keypoints(kl), torch_keypoints(kr), [t(img)], [t(img)],
                                 TCamera(**cam), SF, level_budgets=(k,))
    np.testing.assert_array_equal(n(ur_t), n(ur_j))
    # depth = bf / disparity: XLA's CPU division may round the last bit
    # differently (it multiplies by a reciprocal)
    np.testing.assert_allclose(n(d_t), n(d_j), rtol=2e-7)
    matched = sorted(d for d in dists if d <= 100)
    padded = matched + [257] * (k - len(matched))
    median = padded[len(matched) // 2]
    want = [d <= 100 and d <= 1.5 * 1.4 * median for d in dists]
    np.testing.assert_array_equal(n(ur_t) >= 0, want)
