"""The port's fused orientation+BRIEF function against the TPU kernel.

On the CPU the port's wrapper takes its plain PyTorch version (the CUDA
kernel is compared with that same plain version on the card by
chip_smoke.py, and by the `cuda`-marked test below); the JAX side runs
pallas_orb.fused_orient_describe in interpret mode, as tests/test_pallas_orb.py
does. Fixtures are those of tests/test_pallas_orb.py.

Tolerances: angle < 1e-3 rad (same moments up to float32 summation order).
Descriptors: both sides compare integer grey levels at offsets rounded half
to even, so they agree bit for bit except where summation-order noise in
cos/sin moves a rotated offset across a half-integer; the limit is the JAX
package's own between its twin paths (median <= 4, max <= 40 of 256 bits),
and the share of bit-exact descriptors must be at least 90 %.
"""
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import orb as jorb, pallas_orb
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.ops import cuda_orb, orb as torb

from torch_port_helpers import angle_diff, desc_np, hamming_rows, n, smooth_image, t

PATTERN = jorb.load_pattern(jorb.ORBConfig())


def _images(seed, h, w):
    img = smooth_image(seed, h, w)
    blur = np.asarray(jorb._separable_conv(jnp.asarray(img),
                                           jorb.gaussian_kernel1d(2.0, 3)))
    return img, blur


def _edge_keypoints(h, w):
    m = jorb.EDGE_MARGIN
    xs_list = [m, m + 1, w - m - 1, w - m - 2]
    xs_list += [x for x in range(m, w - m, 61)]
    ys_list = [m, m + 1, h - m - 1, h - m - 2] + [h // 2] * max(
        0, len(xs_list) - 4)
    k = min(len(xs_list), len(ys_list))
    return np.array(ys_list[:k], np.int32), np.array(xs_list[:k], np.int32)


def _case(name):
    if name == "random":
        h, w = 120, 160
        img, blur = _images(7, h, w)
        rng = np.random.default_rng(7)
        ys = rng.integers(jorb.EDGE_MARGIN, h - jorb.EDGE_MARGIN, 64).astype(np.int32)
        xs = rng.integers(jorb.EDGE_MARGIN, w - jorb.EDGE_MARGIN, 64).astype(np.int32)
        return img, blur, ys, xs
    h, w = {"edge_480x640": (480, 640), "edge_96x200": (96, 200),
            "edge_120x1241": (120, 1241)}[name]
    img, blur = _images(11, h, w)
    return (img, blur) + _edge_keypoints(h, w)


def _check(ang, desc, ang_ref, desc_ref):
    assert ang.shape == ang_ref.shape and desc.shape == desc_ref.shape
    assert angle_diff(ang, ang_ref).max() < 1e-3
    ham = hamming_rows(desc, desc_ref)
    assert np.median(ham) <= 4, ham
    assert ham.max() <= 40, ham
    assert (ham == 0).mean() >= 0.9, ham


@pytest.mark.parametrize("name", ["random", "edge_480x640", "edge_96x200",
                                  "edge_120x1241"])
def test_plain_version_matches_tpu_kernel(name):
    img, blur, ys, xs = _case(name)
    ang_ref, desc_ref = pallas_orb.fused_orient_describe(
        jnp.asarray(img), jnp.asarray(blur), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(PATTERN), interpret=True)
    ang, desc = cuda_orb.fused_orient_describe(
        t(img), t(blur), t(ys), t(xs), convert.pattern_from_numpy(PATTERN))
    assert ang.dtype == torch.float32 and desc.dtype == torch.int32
    _check(n(ang), desc_np(desc), np.asarray(ang_ref), desc_np(desc_ref))


def test_port_pattern_is_the_jax_package_pattern():
    np.testing.assert_array_equal(torb.load_pattern(torb.ORBConfig()), PATTERN)
    np.testing.assert_array_equal(torb.make_pattern(5), jorb.make_pattern(5))
    cfg = torb.ORBConfig(pattern_kind="gaussian")
    np.testing.assert_array_equal(torb.load_pattern(cfg),
                                  jorb.make_pattern(cfg.pattern_seed))


def test_degenerate_patch_and_out_of_margin_slots():
    """A constant image has zero moments (angle 0 by convention, pattern
    unrotated); slots outside the margin, as the extractor's padded slots
    are, must stay in range and agree with the centre they are clamped to."""
    h, w = 64, 80
    flat = torch.full((h, w), 100.0)
    img, blur = _images(3, h, w)
    ys = t(np.array([0, h - 1, 15, 30], np.int32))
    xs = t(np.array([0, w - 1, 15, 40], np.int32))
    pat = convert.pattern_from_numpy(PATTERN)
    ang, desc = cuda_orb.fused_orient_describe(flat, flat, ys, xs, pat)
    assert torch.all(ang == 0) and torch.all(desc == 0)
    ang, desc = cuda_orb.fused_orient_describe(t(img), t(blur), ys, xs, pat)
    ys_c = t(np.array([15, h - 16, 15, 30], np.int32))
    xs_c = t(np.array([15, w - 16, 15, 40], np.int32))
    ang_c, desc_c = cuda_orb.fused_orient_describe(t(img), t(blur), ys_c, xs_c, pat)
    assert torch.equal(ang, ang_c) and torch.equal(desc, desc_c)


@pytest.mark.parametrize("bad", ["dtype", "shape", "pattern", "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    img, blur, ys, xs = (t(a) for a in _case("random"))
    pat = convert.pattern_from_numpy(PATTERN)
    if bad == "dtype":
        ys = ys.long()
    elif bad == "shape":
        blur = blur[:-1]
    elif bad == "pattern":
        pat = pat[:128]
    else:
        img = img.T.contiguous().T
    with pytest.raises((TypeError, ValueError)):
        cuda_orb.fused_orient_describe(img, blur, ys, xs, pat)


def _levels(coord_dtype=np.int64):
    """Four levels of different widths: full budget, k below budget, k = 0,
    and a narrow one whose keypoints hug the margins."""
    raws, blurs, ys, xs = [], [], [], []
    for seed, (h, w), k in ((21, (120, 160), 40), (22, (100, 133), 17),
                            (23, (83, 111), 0), (24, (64, 200), 9)):
        img, blur = _images(seed, h, w)
        ey, ex = _edge_keypoints(h, w)
        rng = np.random.default_rng(seed)
        y = np.concatenate([ey, rng.integers(0, h, k)])[:k]
        x = np.concatenate([ex, rng.integers(0, w, k)])[:k]
        raws.append(t(img))
        blurs.append(t(blur))
        ys.append(t(y.astype(coord_dtype)))
        xs.append(t(x.astype(coord_dtype)))
    return raws, blurs, ys, xs, [40, 25, 6, 9]


@pytest.mark.parametrize("coords", ["int64", "int32"])
def test_all_levels_version_is_the_per_level_version_concatenated(coords):
    """Bit for bit, with zeros in the padded slots; through the wrapper (which
    takes the plain version for CPU tensors) and the plain version itself."""
    raws, blurs, ys, xs, budgets = _levels(np.dtype(coords).type)
    pat = convert.pattern_from_numpy(PATTERN)
    want_a, want_d = [], []
    for raw, blur, y, x, budget in zip(raws, blurs, ys, xs, budgets):
        a, d = cuda_orb.fused_orient_describe_plain(raw, blur, y, x, pat)
        k = y.shape[0]
        want_a.append(torch.cat([a, torch.zeros(budget - k)]))
        want_d.append(torch.cat([d, torch.zeros((budget - k, 8), dtype=torch.int32)]))
    want_a, want_d = torch.cat(want_a), torch.cat(want_d)
    assert want_a.shape == (80,) and (want_d[57:65] == 0).all()
    assert (want_d[:40] != 0).any() and (want_d[71:] != 0).any()
    for fn in (cuda_orb.fused_orient_describe_levels,
               cuda_orb.fused_orient_describe_levels_plain):
        ang, desc = fn(raws, blurs, ys, xs, pat, budgets)
        assert ang.dtype == torch.float32 and desc.dtype == torch.int32
        assert torch.equal(ang, want_a) and torch.equal(desc, want_d)


def test_level_table_has_the_extractors_layout():
    """Offsets, counts and sizes as level_budgets and level_shapes imply; the
    pointers are the tensors' own."""
    cfg = torb.ORBConfig(n_features=2000, n_levels=3)   # level 0: 160 candidates
    ex = torb.ORBExtractor(cfg, (120, 160), device="cpu")
    rng = np.random.default_rng(5)
    raws = [t(rng.uniform(0, 255, s).astype(np.float32)) for s in ex.level_shapes]
    sel = [ex._select_level(raw, level) for level, raw in enumerate(raws)]
    ys, xs = [s[0] for s in sel], [s[1] for s in sel]
    table = cuda_orb.build_level_table(raws, raws, ys, xs, ex.level_budgets)
    assert (table.n_levels, table.n_total, table.coord_bytes) == (3, ex.n_total, 8)
    assert ys[0].shape[0] == 160 < ex.level_budgets[0]
    offset = 0
    for level in range(3):
        e = table.level[level]
        assert (e.h, e.w) == ex.level_shapes[level]
        assert (e.k, e.budget, e.offset) == (ys[level].shape[0],
                                             ex.level_budgets[level], offset)
        assert (e.raw, e.blur, e.ys, e.xs) == (
            raws[level].data_ptr(), raws[level].data_ptr(),
            ys[level].data_ptr(), xs[level].data_ptr())
        offset += ex.level_budgets[level]
    one = cuda_orb.build_level_table(raws[:1], raws[:1], [ys[0].int()], [xs[0].int()], [160])
    assert (one.n_levels, one.n_total, one.coord_bytes, one.level[0].offset) == (1, 160, 4, 0)


def test_level_table_size_is_pinned_on_both_sides():
    """ctypes and nvcc must lay the table out alike: the Python constants are
    the ctypes sizes, and the source pins the same numbers at compile time."""
    assert ctypes.sizeof(cuda_orb.LevelEntry) == cuda_orb.LEVEL_ENTRY_BYTES == 56
    assert ctypes.sizeof(cuda_orb.LevelTable) == cuda_orb.LEVEL_TABLE_BYTES
    assert cuda_orb.LEVEL_TABLE_BYTES == 16 * 56 + 16 < 4096   # a kernel parameter
    src = open(os.path.join(os.path.dirname(cuda_orb.__file__), "..", "csrc",
                            "orient_describe.cu")).read()
    pinned = dict(re.findall(r"static_assert\(sizeof\((\w+)\) == (\d+)", src))
    assert pinned == {"OrientDescribeLevel": str(cuda_orb.LEVEL_ENTRY_BYTES),
                      "OrientDescribeTable": str(cuda_orb.LEVEL_TABLE_BYTES)}
    assert f"level[{cuda_orb.MAX_LEVELS}]" in src


@pytest.mark.parametrize("bad", ["over_budget", "mixed_coords", "float_coords",
                                 "too_many_levels", "ragged_lists", "small_level",
                                 "pattern"])
def test_all_levels_wrapper_rejects_what_the_kernel_does_not_take(bad):
    raws, blurs, ys, xs, budgets = _levels()
    pat = convert.pattern_from_numpy(PATTERN)
    if bad == "over_budget":
        budgets[1] = 16
    elif bad == "mixed_coords":
        ys[3] = ys[3].int()
    elif bad == "float_coords":
        ys = [y.float() for y in ys]
    elif bad == "too_many_levels":
        raws, blurs, ys, xs, budgets = (list(v) * 5 for v in (raws, blurs, ys, xs, budgets))
    elif bad == "ragged_lists":
        budgets = budgets[:-1]
    elif bad == "small_level":
        raws[2] = blurs[2] = torch.zeros((30, 111))
    else:
        pat = pat.reshape(256, 4)
    with pytest.raises((TypeError, ValueError)):
        cuda_orb.fused_orient_describe_levels(raws, blurs, ys, xs, pat, budgets)


@pytest.mark.cuda
def test_cuda_all_levels_launch_matches_plain_version():
    """Run on a machine with a GPU:
    JAX_PLATFORMS=cpu python -m pytest -m cuda tests/test_torch_orb_kernel.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    raws, blurs, ys, xs, budgets = _levels()
    raws, blurs, ys, xs = ([v.cuda() for v in vs] for vs in (raws, blurs, ys, xs))
    pat = convert.pattern_from_numpy(PATTERN, "cuda")
    before = cuda_orb.fused_orient_describe.launches
    ang, desc = cuda_orb.fused_orient_describe_levels(raws, blurs, ys, xs, pat, budgets)
    assert cuda_orb.fused_orient_describe.launches == before + 1
    ang_p, desc_p = cuda_orb.fused_orient_describe_levels_plain(
        raws, blurs, ys, xs, pat, budgets)
    _check(n(ang), desc_np(desc), n(ang_p), desc_np(desc_p))
    assert (desc[57:65] == 0).all() and (ang[57:71] == 0).all()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Run on a machine with a GPU:
    JAX_PLATFORMS=cpu python -m pytest -m cuda tests/test_torch_orb_kernel.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    img, blur, ys, xs = (t(a).cuda() for a in _case("edge_480x640"))
    pat = convert.pattern_from_numpy(PATTERN, "cuda")
    before = cuda_orb.fused_orient_describe.launches
    ang, desc = cuda_orb.fused_orient_describe(img, blur, ys, xs, pat)
    assert cuda_orb.fused_orient_describe.launches == before + 1
    ang_p, desc_p = cuda_orb.fused_orient_describe_plain(img, blur, ys, xs, pat)
    _check(n(ang), desc_np(desc), n(ang_p), desc_np(desc_p))
