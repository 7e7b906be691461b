"""The shipped vocabularies, and the default one trained again.

Counterpart of ``orbslam2_tpu/place/pretrained.py``. The port keeps its own
copies of the JAX package's two small trees, trained on this framework's own
descriptors (the reference's ORBvoc.txt does not match this BRIEF pattern):

- ``data/default_voc_k10l3_lp.npz``: k=10, depth 3 (1000 words), learned
  pattern; ``data/default_voc_k10l3.npz``: the same for the Gaussian one;
- ``data/default_voc_k10l4_lp.npz``: k=10, depth 4 (10 000 words), learned
  pattern.

The larger trees (depth 5 and 6, 4-40 MB) are not copied, so that the
repository stays small: ``get_best_vocabulary`` looks for them in ``data/``
as the JAX package does and today returns the 10 000-word tree; a user with
a larger tree loads it with ``vocabulary.load_vocabulary(path)`` (the
drivers' ``--vocabulary``).

``get_default_vocabulary(force_retrain=True)`` trains the 1000-word tree
again, as the JAX package's ``_train_default`` does (12 synthetic textures,
1500 features on 4 levels, seed 7), with the port's extractor and k-medians
on ``device``, and writes it over the file in ``data/``.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from orbslam2_tpu_torch.ops import orb
from orbslam2_tpu_torch.place import vocabulary as voc_mod

_DATA = os.path.join(os.path.dirname(__file__), "data")


def _suffix(pattern_kind: str) -> str:
    """Trees trained on the learned pattern carry an ``_lp`` suffix."""
    learned = pattern_kind == "learned" and os.path.exists(orb._LEARNED_PATTERN_PATH)
    return "_lp" if learned else ""


def _path(tier: str, pattern_kind: str, suffix: str | None = None) -> str:
    sfx = _suffix(pattern_kind) if suffix is None else suffix
    return os.path.join(_DATA, f"default_voc_{tier}{sfx}.npz")


def get_default_vocabulary(pattern_kind: str = orb.ORBConfig.pattern_kind, *,
                           force_retrain: bool = False, device="cuda"
                           ) -> voc_mod.Vocabulary:
    """The 1000-word tree for the descriptor pattern the extractor uses;
    trained on ``device`` and saved into ``data/`` where there is none or
    ``force_retrain`` asks for it."""
    cache = _path("k10l3", pattern_kind)
    if not force_retrain and os.path.exists(cache):
        return voc_mod.load_vocabulary(cache)
    voc = _train_default(device, pattern_kind)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    voc_mod.save_vocabulary(voc, cache)
    return voc


def get_large_vocabulary(pattern_kind: str = orb.ORBConfig.pattern_kind
                         ) -> voc_mod.Vocabulary:
    """The 10 000-word tree (k=10, depth 4): discriminates better on long
    sequences with many keyframes, where the 1000-word tree's vectors
    saturate. Falls back to the default tree where no such tree exists for
    the pattern."""
    p = _path("k10l4", pattern_kind)
    if os.path.exists(p):
        return voc_mod.load_vocabulary(p)
    return get_default_vocabulary(pattern_kind)


def get_best_vocabulary(pattern_kind: str = orb.ORBConfig.pattern_kind
                        ) -> voc_mod.Vocabulary:
    """The largest tree in ``data/``, as the reference mains always load the
    full ORBvoc.txt (System.cc:68-80) and the drivers load this: depth 6,
    then depth 5, then either of them trained on the other descriptor
    pattern (with a warning: it still partitions descriptor space, with
    less discrimination), then ``get_large_vocabulary``."""
    for tier in ("k10l6", "k10l5"):
        p = _path(tier, pattern_kind)
        if os.path.exists(p):
            return voc_mod.load_vocabulary(p)
    for tier in ("k10l6", "k10l5"):
        for sfx in ("", "_lp"):
            p = _path(tier, pattern_kind, sfx)
            if os.path.exists(p):
                warnings.warn(f"vocabulary {os.path.basename(p)} was trained on a "
                              "different descriptor pattern; train one on this "
                              "pattern for full discrimination")
                return voc_mod.load_vocabulary(p)
    return get_large_vocabulary(pattern_kind)


def default_training_corpus(device="cuda",
                            pattern_kind: str = orb.ORBConfig.pattern_kind) -> torch.Tensor:
    """The descriptors the default tree is trained on: 1500 features on 4
    levels of 12 corner-rich synthetic 640x480 textures (the JAX package's
    ``_train_default`` corpus), extracted on ``device``. -> [N, 8] int32."""
    from orbslam2_tpu_torch.io.synthetic import make_texture

    rng = np.random.default_rng(1234)
    extractor = orb.ORBExtractor(
        orb.ORBConfig(n_features=1500, n_levels=4, pattern_kind=pattern_kind),
        (480, 640), device)
    descs = []
    for i in range(12):
        tex = make_texture(rng, 1024)
        img = tex[:480, :640] if i % 2 == 0 else tex[-480:, -640:]
        kp = extractor(torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
            extractor.device))
        descs.append(kp.desc[kp.valid])
    return torch.cat(descs)


def _train_default(device="cuda", pattern_kind: str = orb.ORBConfig.pattern_kind
                   ) -> voc_mod.Vocabulary:
    return voc_mod.train_vocabulary(default_training_corpus(device, pattern_kind),
                                    k=10, levels=3, seed=7, device=device)
