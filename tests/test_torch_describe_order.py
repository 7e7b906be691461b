"""The one order of the float sums that the describe kernel
(orbslam2_tpu_torch/csrc/orient_describe.cu) and its plain PyTorch version
share, pinned on the CPU.

The intensity-centroid moments are exact while the pixels are integers. The
pyramid's resampled levels and rendered float images are not, and there a
sum taken in another order rounds differently, moves the angle and, through
it, may flip a descriptor bit. Kernel and plain version therefore sum in one
stated order: per column dx = -15..15 the disc's rows in row order
(``col_sum += v``, and ``m01 = fma(dy, v, m01)`` with one rounding a step),
``m10 = dx * col_sum``, then the 32 columns halved five times, column i
adding column i + half. The expected moments here are computed in that order
in float32 with numpy, the fused multiply-add as an exact float64 sum (each
one checked exact) rounded once, on non-integer pixels, and must agree bit
for bit; 1 / r is rsqrt(r^2), on the CPU 1 / sqrt(r^2) with each operation
correctly rounded, so the plain version's rotated sample offsets, and with
them its descriptors, follow from the moments.
"""
import numpy as np
import torch

from orbslam2_tpu_torch.ops import cuda_orb

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)

H = cuda_orb.HALF_PATCH


def _fma32(a: np.float32, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c rounded once to float32. The float32 product is exact in
    float64, and the float64 sum is checked exact (its two-sum error is 0),
    so the one rounding left is the cast."""
    p = np.float64(a) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - c64
    assert not ((c64 - (s - bb)) + (p - bb)).any(), "float64 sum not exact"
    return s.astype(np.float32)


def _documented_moments(raw: np.ndarray, ys: np.ndarray, xs: np.ndarray, fused=True):
    """m10, m01 in the documented order, float32 throughout (with
    ``fused=False`` the m01 product rounded on its own, for contrast)."""
    off = np.arange(-H, H + 1)
    col_sum = np.zeros((len(ys), 32), np.float32)
    m01 = np.zeros((len(ys), 32), np.float32)
    for dy in off:
        inside = np.zeros(32, bool)
        inside[:31] = off * off + dy * dy <= H * H
        v = np.zeros((len(ys), 32), np.float32)
        v[:, :31] = raw[(ys + dy)[:, None], xs[:, None] + off[None, :]]
        col_sum = np.where(inside, col_sum + v, col_sum)
        nxt = _fma32(np.float32(dy), v, m01) if fused else m01 + np.float32(dy) * v
        m01 = np.where(inside, nxt, m01)
    dx = np.append(off, H + 1).astype(np.float32)
    m10 = col_sum * dx
    for half in (16, 8, 4, 2, 1):
        m10 = m10[:, :half] + m10[:, half:2 * half]
        m01 = m01[:, :half] + m01[:, half:2 * half]
    return m10[:, 0], m01[:, 0]


def _non_integer_image(seed=3, h=96, w=128):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, (h, w)).astype(np.float32)
    assert (img != np.round(img)).mean() > 0.99
    ys = rng.integers(H, h - H, 300)
    xs = rng.integers(H, w - H, 300)
    return img, ys, xs


def test_moments_follow_the_documented_order_bit_for_bit():
    img, ys, xs = _non_integer_image()
    m10, m01 = cuda_orb._moments_plain(torch.tensor(img), torch.tensor(ys), torch.tensor(xs))
    w10, w01 = _documented_moments(img, ys, xs)
    np.testing.assert_array_equal(m10.numpy(), w10)
    np.testing.assert_array_equal(m01.numpy(), w01)
    # the order matters on these pixels: a plain sum over the disc in another
    # order rounds differently on some keypoints
    off = np.arange(-H, H + 1)
    dyy, dxx = np.meshgrid(off, off, indexing="ij")
    disc = (dxx * dxx + dyy * dyy) <= H * H
    patches = img[(ys[:, None, None] + dyy), (xs[:, None, None] + dxx)] * disc
    other = (patches * dyy.astype(np.float32)).reshape(len(ys), -1).sum(1, dtype=np.float32)
    assert (other != w01).any()
    # and so does the fused multiply-add: the product rounded on its own
    # gives other m01 values on some keypoints
    assert (_documented_moments(img, ys, xs, fused=False)[1] != w01).any()


def test_plain_angle_and_offsets_follow_from_the_moments():
    img, ys, xs = _non_integer_image(seed=4)
    pattern = torch.tensor(np.random.default_rng(1).integers(-13, 14, (256, 2, 2)),
                           dtype=torch.float32)
    angle, desc = cuda_orb.fused_orient_describe_plain(
        torch.tensor(img), torch.tensor(img), torch.tensor(ys), torch.tensor(xs), pattern)
    w10, w01 = _documented_moments(img, ys, xs)
    np.testing.assert_allclose(angle.numpy(), np.arctan2(w01, w10), atol=1e-6)
    # cos and sin as 1 / sqrt(r^2), each operation rounded to float32 (the
    # CPU's rsqrt)
    r2 = w10 * w10 + w01 * w01
    inv_r = np.float32(1.0) / np.sqrt(r2).astype(np.float32)
    ca, sa = w10 * inv_r, w01 * inv_r
    pdx, pdy = pattern[:, 0, 0].numpy(), pattern[:, 0, 1].numpy()
    rx = np.clip(np.rint(pdx[None] * ca[:, None] - pdy[None] * sa[:, None]), -H, H)
    ry = np.clip(np.rint(pdx[None] * sa[:, None] + pdy[None] * ca[:, None]), -H, H)
    bx = np.clip(np.rint(pattern[:, 1, 0].numpy()[None] * ca[:, None]
                         - pattern[:, 1, 1].numpy()[None] * sa[:, None]), -H, H)
    by = np.clip(np.rint(pattern[:, 1, 0].numpy()[None] * sa[:, None]
                         + pattern[:, 1, 1].numpy()[None] * ca[:, None]), -H, H)
    grey = np.round(np.clip(img, 0, 255))
    va = grey[(ys[:, None] + ry).astype(int), (xs[:, None] + rx).astype(int)]
    vb = grey[(ys[:, None] + by).astype(int), (xs[:, None] + bx).astype(int)]
    bits = (va < vb).astype(np.uint64)
    words = (bits.reshape(len(ys), 8, 32) << np.arange(32, dtype=np.uint64)).sum(2)
    np.testing.assert_array_equal(desc.numpy().view(np.uint32), words.astype(np.uint32))
