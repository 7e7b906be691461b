"""ORB feature extraction in PyTorch.

Counterpart of ``orbslam2_tpu/ops/orb.py``; same pipeline and constants:

- image pyramid: cascaded antialiased bilinear resize chain
- FAST 9/16 corners at two thresholds from one shifted stack, with the
  per-cell fallback to the low threshold where the high one found nothing
- spatial distribution: per-cell top-k then per-level top-budget (the
  dense-array equivalent of the reference's quadtree)
- orientation + rotated BRIEF per keypoint by the fused kernel of
  ``ops/cuda_orb.py`` (the raw level image for the intensity-centroid
  moments, the 7x7 Gaussian-blurred image quantised to integer grey for the
  256 pair tests)

All outputs are fixed-capacity tensors with a validity mask. Packed
descriptors are ``[N, 8]`` int32 bit-views of the eight little-endian 32-bit
words ``pack_bits`` produces (PyTorch has no right shift for uint32).
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from orbslam2_tpu_torch import resolve_device
from orbslam2_tpu_torch.ops import cuda_orb

# FAST radius-3 Bresenham circle, 16 points, (dy, dx), clockwise from 12
# o'clock — same circle OpenCV uses.
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

HALF_PATCH = 15
PATCH = 31
EDGE_MARGIN = 19
DESC_BITS = 256
DESC_WORDS = 8  # 256 bits as 8 x 32-bit words


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """Mirrors the reference settings block (ORBextractor.* keys)."""
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell_size: int = 32          # spatial-distribution bucket
    cell_topk: int = 8           # candidates kept per bucket before the level top-k
    pattern_seed: int = 20120904  # fixed seed -> reproducible descriptor pattern
    # "learned": the shipped greedy-decorrelated test set; "gaussian": the
    # seeded BRIEF-style pattern.
    pattern_kind: str = "learned"


@dataclasses.dataclass
class Keypoints:
    """Fixed-capacity keypoint set for one image (SoA, masked); several
    images' sets stacked carry a leading session axis (``stack``)."""
    xy: torch.Tensor        # [N, 2] float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor     # [N] float32 radians
    octave: torch.Tensor    # [N] int32
    size: torch.Tensor      # [N] float32 (patch diameter at level-0 scale)
    desc: torch.Tensor      # [N, 8] int32 bit-views of packed 256-bit descriptors
    valid: torch.Tensor     # [N] bool

    def replace(self, **kw) -> "Keypoints":
        return dataclasses.replace(self, **kw)

    @property
    def n(self) -> int:
        return self.xy.shape[-2]

    @staticmethod
    def stack(kps) -> "Keypoints":
        """Keypoint sets of one capacity on a leading session axis: every
        field [B, N, ...]."""
        return Keypoints(**{f.name: torch.stack([getattr(kp, f.name) for kp in kps])
                            for f in dataclasses.fields(Keypoints)})


def make_pattern(seed: int) -> np.ndarray:
    """Deterministic BRIEF pattern: 256 point pairs ~ N(0, (PATCH/5)^2),
    L2-clipped to radius 13 so any rotation stays inside the 31x31 patch.
    Returns float32 [256, 2, 2] ((a, b) x (dx, dy))."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(DESC_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    factor = np.minimum(1.0, 13.0 / np.maximum(norm, 1e-9))
    return (pts * factor).astype(np.float32)


_LEARNED_PATTERN_PATH = os.path.join(
    os.path.dirname(__file__), "data", "brief_pattern_learned.npz")


@functools.lru_cache(maxsize=1)
def _learned_pattern() -> np.ndarray:
    pattern = np.load(_LEARNED_PATTERN_PATH)["pattern"].astype(np.float32)
    pattern.setflags(write=False)
    return pattern


def load_pattern(config: "ORBConfig") -> np.ndarray:
    """Resolve the BRIEF test pattern for a config: the shipped learned
    table, or the seeded-Gaussian pattern. Falls back to Gaussian if the
    learned artifact is missing."""
    if config.pattern_kind == "learned" and os.path.exists(_LEARNED_PATTERN_PATH):
        return _learned_pattern()
    return make_pattern(config.pattern_seed)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of an [H, W] image (the triangle filter
    widened by the downscale factor, as the JAX package's pyramid step)."""
    return F.interpolate(img[None, None], size=shape, mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def _separable_conv(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Same-padding (zero) separable 2D correlation of an [H, W] image:
    rows first, then columns. Explicit shifted adds in float32, so neither a
    TF32 convolution nor a reduced-precision product can enter — the result
    is rounded to integer grey and compared bit for bit."""
    r = (len(k1d) - 1) // 2
    taps = [float(v) for v in k1d]
    h, w = img.shape
    x = F.pad(img, (0, 0, r, r))
    acc = taps[0] * x[0:h]
    for i in range(1, len(taps)):
        acc = acc + taps[i] * x[i:i + h]
    x = F.pad(acc, (r, r, 0, 0))
    out = taps[0] * x[:, 0:w]
    for i in range(1, len(taps)):
        out = out + taps[i] * x[:, i:i + w]
    return out


def _arc9(mask16: torch.Tensor) -> torch.Tensor:
    """[16, H, W] bool circle masks -> [H, W] bool: any contiguous arc >= 9."""
    weights = (1 << torch.arange(16, device=mask16.device, dtype=torch.int64))
    m = torch.sum(mask16.to(torch.int64) * weights[:, None, None], dim=0)
    m = m | (m << 16)               # duplicate for wraparound (int64: no sign bit in play)
    s = m & (m >> 1)                # runs >= 2
    s = s & (s >> 2)                # >= 4
    s = s & (s >> 4)                # >= 8
    s = s & (m >> 8)                # >= 9
    return (s & 0xFFFF) != 0


def fast_response_dual(
    img: torch.Tensor, th_hi: float, th_lo: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FAST 9/16 corner test at two thresholds over one shifted stack.

    Returns (corner_hi, corner_lo [H, W] bool, score [H, W] float32); score
    is the hi-threshold sum of circle differences beyond threshold for the
    dominant polarity (used only for ranking).
    """
    shifted = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in FAST_OFFSETS],
        dim=0,
    )  # [16, H, W]; shifted[i][y,x] = img[y+dy, x+dx]
    diff = shifted - img[None]
    corner_hi = _arc9(diff > th_hi) | _arc9(diff < -th_hi)
    corner_lo = _arc9(diff > th_lo) | _arc9(diff < -th_lo)
    score_b = torch.sum(torch.clamp(diff - th_hi, min=0.0), dim=0)
    score_d = torch.sum(torch.clamp(-diff - th_hi, min=0.0), dim=0)
    return corner_hi, corner_lo, torch.maximum(score_b, score_d)


def fast_response(img: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """FAST 9/16 corner test over the whole image -> (is_corner, score)."""
    corner, _, score = fast_response_dual(img, threshold, threshold)
    return corner, score


def _topk_small(x: torch.Tensor, k: int):
    """Row-wise top-k by k rounds of (max, argmax, mask); ties go to the
    lowest column (``torch.max`` over a dim returns the first maximum).
    -> ([R, k] values, [R, k] int64 columns)."""
    x = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        v, i = torch.max(x, dim=1)
        vals.append(v)
        idxs.append(i)
        x.scatter_(1, i[:, None], float("-inf"))
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k of a 1-D tensor, descending, ties toward the lower index
    (``torch.topk`` does not promise a tie order; a stable sort does)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """True where score is a 3x3 local maximum (borders padded with -inf)."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= neigh


# Rank bias marking hi-threshold FAST survivors through the cell-space
# blend: well above any achievable FAST score (<= 16 * 255), and low
# enough that (score + _HI_BIAS) - _HI_BIAS round-trips with < 0.01
# quantization in f32 (scores are only ranks).
_HI_BIAS = 65536.0


class ORBExtractor:
    """Static-shape ORB extractor for one image geometry and one device.

    Construct once per (image shape, config, device); ``__call__`` is pure.
    Per-level scales and feature budgets are precomputed as the reference
    ORBextractor's constructor does.
    """

    def __init__(self, config: ORBConfig, image_shape: Tuple[int, int],
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.h, self.w = image_shape
        c = config
        self.scales = [c.scale_factor ** l for l in range(c.n_levels)]
        self.level_shapes: List[Tuple[int, int]] = [
            (max(32, int(round(self.h / s))), max(32, int(round(self.w / s))))
            for s in self.scales
        ]
        # geometric per-level budget, as the reference
        factor = 1.0 / c.scale_factor
        n_per = c.n_features * (1 - factor) / (1 - factor ** c.n_levels)
        budgets = [int(round(n_per * factor ** l)) for l in range(c.n_levels - 1)]
        budgets.append(max(0, c.n_features - sum(budgets)))
        self.level_budgets = budgets
        self.n_total = sum(budgets)
        self.pattern = load_pattern(c)  # [256, 2, 2] numpy
        self.pattern_t = torch.tensor(self.pattern, dtype=torch.float32,
                                      device=self.device)
        self.blur_kernel = gaussian_kernel1d(2.0, 3)  # 7x7 sigma=2
        # per-slot constants of the frame-wide outputs, levels one after another
        def per_slot(values, dtype):
            return torch.cat([torch.full((b,), v, dtype=dtype, device=self.device)
                              for b, v in zip(budgets, values)])

        self._slot_scale = per_slot([float(s) for s in self.scales], torch.float32)
        self._slot_octave = per_slot(range(c.n_levels), torch.int32)
        self._slot_size = per_slot([PATCH * float(s) for s in self.scales], torch.float32)

    # ------------------------------------------------------------------
    def __call__(self, image: torch.Tensor) -> Keypoints:
        """image: [H, W] float32 in [0, 255] -> fixed-capacity Keypoints."""
        kp, _ = self.extract_with_pyramid(image)
        return kp

    def extract_with_pyramid(self, image: torch.Tensor):
        """Like __call__ but also returns the per-level *blurred* pyramid
        (tuple of [lh, lw] f32 tensors) for consumers that reuse it.

        Keypoints are selected level by level; orientation and descriptors of
        all levels then come from one call of the fused kernel. ``octave`` and
        ``size`` of the result are the extractor's own constant tensors,
        shared by every frame: read them, do not write to them."""
        levels = self._levels(image)
        angle, desc = cuda_orb.fused_orient_describe_levels(
            *levels[:4], self.pattern_t, self.level_budgets)
        return self._keypoints(levels, angle, desc), tuple(levels[1])

    def extract_batch_with_pyramid(self, images):
        """Several images of this geometry, each as ``extract_with_pyramid``
        would give it, with the orientation and descriptors of all the
        images' levels from ceil(B * L / 16) calls of the fused kernel: the
        levels of every image one after another, cut into tables of at most
        ``cuda_orb.MAX_LEVELS`` (an image's levels may span two tables).
        images: a sequence of [H, W] f32 tensors, or a [B, H, W] tensor.
        -> [(kp, pyr)] in the order of the images."""
        per_image = [self._levels(image) for image in images]
        fields = [sum((list(lv[i]) for lv in per_image), []) for i in range(4)]
        budgets = list(self.level_budgets) * len(per_image)
        angles, descs = [], []
        for lo in range(0, len(budgets), cuda_orb.MAX_LEVELS):
            hi = lo + cuda_orb.MAX_LEVELS
            angle, desc = cuda_orb.fused_orient_describe_levels(
                *(field[lo:hi] for field in fields), self.pattern_t, budgets[lo:hi])
            angles.append(angle)
            descs.append(desc)
        angle, desc = torch.cat(angles), torch.cat(descs)
        n = self.n_total
        return [(self._keypoints(lv, angle[i * n:(i + 1) * n], desc[i * n:(i + 1) * n]),
                 tuple(lv[1])) for i, lv in enumerate(per_image)]

    def extract_pair_with_pyramid(self, left: torch.Tensor, right: torch.Tensor):
        """Both images of a stereo pair in one batch (at up to 8 levels, one
        call of the fused kernel). -> ((kp_l, pyr_l), (kp_r, pyr_r))."""
        return tuple(self.extract_batch_with_pyramid((left, right)))

    def _levels(self, image: torch.Tensor):
        """The level loop of one image: pyramid, blur, FAST, NMS, cell and
        level selection. -> (raws, blurred, ys, xs, scores), one entry per
        level."""
        raws, pyramid, ys, xs, scores = [], [], [], [], []
        img = image.contiguous()
        for level in range(self.config.n_levels):
            if level > 0:
                # cascaded pyramid: each level resampled from the previous
                img = _resize_bilinear(img, self.level_shapes[level])
            raws.append(img)
            pyramid.append(_separable_conv(img, self.blur_kernel))
            y, x, sel_score, _ = self._select_level(img, level)
            ys.append(y)
            xs.append(x)
            scores.append(sel_score)
        return raws, pyramid, ys, xs, scores

    def _keypoints(self, levels, angle: torch.Tensor, desc: torch.Tensor) -> Keypoints:
        """The frame-wide Keypoints of one image's levels and its kernel
        outputs; a level with fewer candidates than its budget is padded up
        to it (coordinates 0, score -inf)."""
        _, _, ys, xs, scores = levels
        ys, xs, scores = list(ys), list(xs), list(scores)
        for level, budget in enumerate(self.level_budgets):
            pad = budget - ys[level].shape[0]
            if pad > 0:
                ys[level] = F.pad(ys[level], (0, pad))
                xs[level] = F.pad(xs[level], (0, pad))
                scores[level] = F.pad(scores[level], (0, pad), value=float("-inf"))
        score = torch.cat(scores)
        valid = torch.isfinite(score)
        xy = torch.stack([torch.cat(xs).to(torch.float32),
                          torch.cat(ys).to(torch.float32)], dim=-1)
        return Keypoints(
            xy=xy * self._slot_scale[:, None],
            response=torch.where(valid, score, torch.zeros_like(score)),
            angle=angle, octave=self._slot_octave, size=self._slot_size,
            desc=desc, valid=valid)

    # ------------------------------------------------------------------
    def _select_level(self, img: torch.Tensor, level: int):
        """FAST + NMS + cell fallback + cell top-k + level top-budget.
        -> (ys, xs [k] int64 clamped into the image, sel_score [k], valid [k])
        with k = min(budget, candidates)."""
        c = self.config
        lh, lw = img.shape
        budget = self.level_budgets[level]

        corner_hi, corner_lo, score = fast_response_dual(
            img, c.ini_th_fast, c.min_th_fast)

        # border mask: keep full patches inside the image
        m = EDGE_MARGIN
        valid_region = torch.zeros((lh, lw), dtype=torch.bool, device=img.device)
        valid_region[m:lh - m, m:lw - m] = True
        corner_hi = corner_hi & valid_region
        corner_lo = corner_lo & valid_region

        neg_inf = torch.full_like(score, float("-inf"))
        keep_hi = corner_hi & _nms3(torch.where(corner_hi, score, neg_inf))
        keep_lo = corner_lo & _nms3(torch.where(corner_lo, score, neg_inf))

        # dual-threshold fallback per cell, resolved in cell space: hi
        # survivors carry score + _HI_BIAS, cells whose max crosses the
        # bias keep only hi rows
        enc = torch.where(keep_hi, score + _HI_BIAS,
                          torch.where(keep_lo, score, neg_inf))

        cell = c.cell_size
        ph = (cell - lh % cell) % cell
        pw = (cell - lw % cell) % cell
        enc = F.pad(enc, (0, pw, 0, ph), value=float("-inf"))

        hp, wp = enc.shape
        ncy, ncx = hp // cell, wp // cell
        cells = enc.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
            ncy * ncx, cell * cell)
        cell_has_hi = torch.max(cells, dim=1, keepdim=True).values >= 0.5 * _HI_BIAS
        cells = torch.where(
            cell_has_hi,
            torch.where(cells >= 0.5 * _HI_BIAS, cells - _HI_BIAS,
                        torch.full_like(cells, float("-inf"))),
            cells)
        # k sized to the level budget: 3x headroom over budget/ncells for
        # uneven texture, capped at the config's cell_topk
        k_cell = min(c.cell_topk, cell * cell,
                     max(3, -(-budget // (ncy * ncx)) * 3))
        top_val, top_idx = _topk_small(cells, k_cell)
        cell_id = torch.arange(ncy * ncx, device=img.device)[:, None]
        py = (cell_id // ncx) * cell + top_idx // cell
        px = (cell_id % ncx) * cell + top_idx % cell

        flat_scores = top_val.reshape(-1)
        k = min(budget, flat_scores.shape[0])
        sel_score, sel = _topk_lowest_index(flat_scores, k)
        ys = py.reshape(-1)[sel].clamp(0, lh - 1)
        xs = px.reshape(-1)[sel].clamp(0, lw - 1)
        return ys, xs, sel_score, torch.isfinite(sel_score)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] 0/1 -> [..., 8] int32 bit-views (little-endian bit order:
    bit b of word w is element 32*w + b)."""
    shape = bits.shape[:-1]
    b = bits.reshape(shape + (DESC_WORDS, 32)).to(torch.int64)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b * weights, dim=-1)             # in [0, 2^32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 bit-views -> [..., 256] 0/1 uint8."""
    shape = packed.shape[:-1]
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    # arithmetic shift smears the sign bit upward only; bit 0 after the
    # shift is bit `s` of the word for every s in 0..31
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(shape + (DESC_BITS,)).to(torch.uint8)


@functools.lru_cache(maxsize=16)
def get_extractor(config: ORBConfig, image_shape: Tuple[int, int],
                  device="cuda") -> ORBExtractor:
    return ORBExtractor(config, image_shape, device)
