"""Parity of orbslam2_tpu_torch.ops.orb with the JAX package's extractor.

Each stage is compared on its own on identical inputs (resize, blur, FAST,
NMS, small top-k, bit packing), then the whole extractor against
ORBExtractor(use_pallas=True), whose kernel runs interpreted on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu_torch.ops import cuda_orb, orb as torb

from torch_port_helpers import angle_diff, desc_np, hamming_rows, j, n, t


def _scene(seed, h, w):
    """Corner-rich image: smoothed noise plus random rectangles."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(40, 90, (h, w)).astype(np.float32)
    img = np.array(jorb._separable_conv(jnp.asarray(img),
                                        jorb.gaussian_kernel1d(2.0, 3)))
    for _ in range(h * w // 700):
        x, y = rng.integers(0, w - 30), rng.integers(0, h - 30)
        ww, hh = rng.integers(6, 30, size=2)
        img[y:y + hh, x:x + ww] = 0.7 * img[y:y + hh, x:x + ww] + rng.uniform(0, 110)
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("shape_in,shape_out", [
    ((240, 320), (200, 267)), ((200, 267), (167, 222)), ((480, 640), (400, 533)),
    ((134, 179), (112, 149))])
def test_pyramid_resize_matches_jax(shape_in, shape_out):
    """jax.image.resize antialiases on downscale; the port's resize must too.
    Tolerance 0.01 grey levels (float32 filter weights)."""
    img = _scene(1, *shape_in)
    want = n(jax.image.resize(j(img), shape_out, method="bilinear"))
    got = n(torb._resize_bilinear(t(img), shape_out))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 0.01


@pytest.mark.parametrize("shape", [(120, 160), (97, 131)])
def test_blur_matches_jax(shape):
    """7x7 sigma-2 blur, zero 'same' padding; tolerance 1e-3 grey levels."""
    img = _scene(2, *shape)
    k = jorb.gaussian_kernel1d(2.0, 3)
    np.testing.assert_array_equal(k, torb.gaussian_kernel1d(2.0, 3))
    want = n(jorb._separable_conv(j(img), k))
    got = n(torb._separable_conv(t(img), k))
    assert np.abs(got - want).max() < 1e-3
    # borders see zeros, not replicated pixels
    assert got[0, 0] < 0.5 * img[:4, :4].mean()


def test_fast_and_nms_match_jax():
    """Integer-valued image: differences are exact, so masks must be equal
    and scores equal."""
    img = np.round(_scene(3, 120, 160))
    hi_j, lo_j, sc_j = jorb.fast_response_dual(j(img), 20.0, 7.0)
    hi_t, lo_t, sc_t = torb.fast_response_dual(t(img), 20.0, 7.0)
    np.testing.assert_array_equal(n(hi_t), n(hi_j))
    np.testing.assert_array_equal(n(lo_t), n(lo_j))
    np.testing.assert_allclose(n(sc_t), n(sc_j), atol=1e-3)
    assert n(hi_t).sum() > 50 and n(lo_t).sum() > n(hi_t).sum()
    c_t, s_t = torb.fast_response(t(img), 20.0)
    np.testing.assert_array_equal(n(c_t), n(hi_j))
    masked = np.where(n(hi_j), n(sc_j), -np.inf).astype(np.float32)
    np.testing.assert_array_equal(n(torb._nms3(t(masked))), n(jorb._nms3(j(masked))))


def test_arc9_needs_nine_contiguous():
    ring = np.zeros((16, 1, 3), bool)
    ring[[14, 15, 0, 1, 2, 3, 4, 5, 6], 0, 0] = True      # 9, wrapping around
    ring[0:8, 0, 1] = True                                 # only 8
    ring[::2, 0, 2] = True                                 # alternating
    np.testing.assert_array_equal(n(torb._arc9(t(ring)))[0], [True, False, False])
    np.testing.assert_array_equal(n(jorb._arc9(j(ring)))[0], [True, False, False])


def test_topk_ties_go_to_the_lowest_index():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, (37, 64)).astype(np.float32)   # heavy ties
    x[3] = -np.inf                                        # an empty cell
    v_j, i_j = jorb._topk_small(j(x), 5)
    v_t, i_t = torb._topk_small(t(x), 5)
    np.testing.assert_array_equal(n(v_t), n(v_j))
    np.testing.assert_array_equal(n(i_t), n(i_j))
    flat = x.reshape(-1)
    v_j, i_j = jax.lax.top_k(j(flat), 300)
    v_t, i_t = torb._topk_lowest_index(t(flat), 300)
    np.testing.assert_array_equal(n(v_t), n(v_j))
    np.testing.assert_array_equal(n(i_t), n(i_j))


def test_pack_unpack_match_jax(rng):
    bits = rng.integers(0, 2, (50, 256)).astype(np.uint8)
    bits[0] = 1                                            # every sign bit set
    packed_j = n(jorb.pack_bits(j(bits)))
    packed_t = torb.pack_bits(t(bits))
    assert packed_t.dtype == torch.int32
    np.testing.assert_array_equal(desc_np(packed_t), packed_j)
    np.testing.assert_array_equal(n(torb.unpack_bits(packed_t)), bits)


@pytest.mark.parametrize("shape,n_features,n_levels", [
    ((120, 160), 200, 3), ((240, 320), 800, 4)])
def test_extractor_matches_jax(shape, n_features, n_levels):
    """Whole extractor: same budgets, same valid mask, same keypoints; angles
    within 1e-3 rad, descriptors within the JAX package's own limits between
    its twin paths and at least 90 % of them bit-exact."""
    img = _scene(5, *shape)
    jcfg = jorb.ORBConfig(n_features=n_features, n_levels=n_levels, use_pallas=True)
    tcfg = torb.ORBConfig(n_features=n_features, n_levels=n_levels)
    jex = jorb.ORBExtractor(jcfg, shape)
    tex = torb.ORBExtractor(tcfg, shape, device="cpu")
    assert tex.level_budgets == jex.level_budgets
    assert tex.level_shapes == jex.level_shapes and tex.n_total == jex.n_total
    kj, pyr_j = jax.jit(jex.extract_with_pyramid)(j(img))
    kt, pyr_t = tex.extract_with_pyramid(t(img))
    for a, b in zip(pyr_t, pyr_j):
        assert np.abs(n(a) - n(b)).max() < 0.02          # blurred pyramid, grey levels
    v = n(kj.valid)
    assert v.sum() > 0.5 * n_features
    np.testing.assert_array_equal(n(kt.valid), v)
    np.testing.assert_allclose(n(kt.xy), n(kj.xy), atol=1e-4)
    np.testing.assert_array_equal(n(kt.octave), n(kj.octave))
    np.testing.assert_allclose(n(kt.size), n(kj.size), rtol=1e-6)
    np.testing.assert_allclose(n(kt.response), n(kj.response), atol=0.05)
    assert angle_diff(n(kt.angle)[v], n(kj.angle)[v]).max() < 1e-3
    ham = hamming_rows(desc_np(kt.desc)[v], desc_np(kj.desc)[v])
    assert np.median(ham) <= 4 and ham.max() <= 40, ham
    assert (ham == 0).mean() >= 0.9, (ham == 0).mean()
    assert kt.desc.dtype == torch.int32 and kt.octave.dtype == torch.int32


def _extract_level_by_level(ex, image):
    """The extractor's earlier route, kept here as the reference: one call of
    the fused function per level, every field padded per level, the levels
    concatenated field by field."""
    F = torch.nn.functional
    fields = {name: [] for name in ("xy", "response", "angle", "octave", "size",
                                    "desc", "valid")}
    img = image
    for level in range(ex.config.n_levels):
        if level > 0:
            img = torb._resize_bilinear(img, ex.level_shapes[level])
        blurred = torb._separable_conv(img, ex.blur_kernel)
        budget = ex.level_budgets[level]
        ys, xs, sel_score, valid = ex._select_level(img, level)
        angle, desc = cuda_orb.fused_orient_describe(
            img.contiguous(), blurred.contiguous(),
            ys.to(torch.int32), xs.to(torch.int32), ex.pattern_t)
        scale = float(ex.scales[level])
        xy0 = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], dim=-1) * scale
        pad = budget - ys.shape[0]
        if pad > 0:
            xy0 = F.pad(xy0, (0, 0, 0, pad))
            sel_score = F.pad(sel_score, (0, pad), value=float("-inf"))
            angle = F.pad(angle, (0, pad))
            desc = F.pad(desc, (0, 0, 0, pad))
            valid = F.pad(valid, (0, pad))
        fields["xy"].append(xy0)
        fields["response"].append(torch.where(torch.isfinite(sel_score), sel_score,
                                              torch.zeros_like(sel_score)))
        fields["angle"].append(angle)
        fields["octave"].append(torch.full((budget,), level, dtype=torch.int32))
        fields["size"].append(torch.full((budget,), torb.PATCH * scale,
                                         dtype=torch.float32))
        fields["desc"].append(desc)
        fields["valid"].append(valid)
    return torb.Keypoints(**{k: torch.cat(v) for k, v in fields.items()})


@pytest.mark.parametrize("shape,n_features,n_levels", [
    ((120, 160), 200, 3), ((240, 320), 800, 4), ((120, 160), 2000, 3),
    ((97, 131), 300, 5)])
def test_extractor_fields_equal_the_level_by_level_route(shape, n_features, n_levels):
    """One fused call for all levels must leave every Keypoints field bit for
    bit as the per-level route gave it; the third case has levels with fewer
    candidates than budget (padded slots)."""
    img = t(_scene(6, *shape))
    ex = torb.ORBExtractor(torb.ORBConfig(n_features=n_features, n_levels=n_levels),
                           shape, device="cpu")
    got, pyramid = ex.extract_with_pyramid(img)
    want = _extract_level_by_level(ex, img)
    assert got.n == ex.n_total and len(pyramid) == n_levels
    assert [tuple(p.shape) for p in pyramid] == ex.level_shapes
    for name in ("xy", "response", "angle", "octave", "size", "desc", "valid"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert got.valid.sum() > 0.25 * min(n_features, 400)
    if n_features == 2000:   # level 0: 20 cells x 8 candidates for 791 slots
        pad = slice(160, ex.level_budgets[0])
        assert not got.valid[pad].any() and (got.desc[pad] == 0).all()
        assert (got.angle[pad] == 0).all() and (got.xy[pad] == 0).all()
    again, _ = ex.extract_with_pyramid(img)       # shared constants stay intact
    assert torch.equal(again.octave, want.octave) and torch.equal(again.size, want.size)


def test_extractor_entry_points_default_to_the_card():
    cfg = torb.ORBConfig(n_features=100, n_levels=2)
    assert torb.get_extractor(cfg, (64, 64), "cpu") is torb.get_extractor(cfg, (64, 64), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torb.ORBExtractor(cfg, (64, 64))
        with pytest.raises(RuntimeError, match="CUDA"):
            torb.get_extractor(cfg, (64, 64))
