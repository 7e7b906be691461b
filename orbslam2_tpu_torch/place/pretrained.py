"""The shipped vocabularies.

Counterpart of ``orbslam2_tpu/place/pretrained.py``. The port keeps its own
copies of the JAX package's two small trees, trained there on its own
descriptors (the reference's ORBvoc.txt does not match this BRIEF pattern):

- ``data/default_voc_k10l3_lp.npz``: k=10, depth 3 (1000 words), learned
  pattern; ``data/default_voc_k10l3.npz``: the same for the Gaussian one;
- ``data/default_voc_k10l4_lp.npz``: k=10, depth 4 (10 000 words), learned
  pattern.

The larger trees (depth 5 and 6, 4-40 MB) are not copied: load them with
``vocabulary.load_vocabulary(path)`` from a path the caller gives.
"""
from __future__ import annotations

import os

from orbslam2_tpu_torch.ops import orb
from orbslam2_tpu_torch.place import vocabulary as voc_mod

_DATA = os.path.join(os.path.dirname(__file__), "data")


def _path(tier: str, pattern_kind: str) -> str:
    """Trees trained on the learned pattern carry an ``_lp`` suffix."""
    learned = pattern_kind == "learned" and os.path.exists(orb._LEARNED_PATTERN_PATH)
    return os.path.join(_DATA, f"default_voc_{tier}{'_lp' if learned else ''}.npz")


def get_default_vocabulary(pattern_kind: str = orb.ORBConfig.pattern_kind
                           ) -> voc_mod.Vocabulary:
    """The 1000-word tree for the descriptor pattern the extractor uses."""
    return voc_mod.load_vocabulary(_path("k10l3", pattern_kind))


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
