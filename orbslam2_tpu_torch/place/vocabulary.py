"""Binary bag-of-words vocabulary tree (the reference's DBoW2).

Counterpart of ``orbslam2_tpu/place/vocabulary.py``; reads the same npz
format. The tree is one table of children centres per level: level l holds
k^(l+1) slots (the children of every level-(l-1) slot, contiguous), each a
256-vector in {-1, 0, +1} (int8; all-zero rows are dead nodes). Leaves are
the last level and a word id is a leaf slot.

The descent of all descriptors runs on the device, one level at a time: the
k children centres of each descriptor's node are gathered and compared with
the descriptor's {-1, +1} bits by a float32 product (the Hamming distance is
(256 - product) / 2; the sums are exact up to 256). The nearest child wins,
dead children never, and a tie goes to the lowest child index, as the JAX
package's argmax breaks it: otherwise word ids would differ.

A bag-of-words vector is a dense L1-normalised tf-idf array over the words;
scoring is DBoW2's L1 score. Training (``train_vocabulary``, and with it
``save_vocabulary``) needs the JAX package's extractor and is not ported:
the port loads trees trained there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from orbslam2_tpu_torch.ops.orb import unpack_bits


@dataclasses.dataclass
class Vocabulary:
    """Flat vocabulary tree (see the module docstring)."""
    k: int
    levels: int
    centers: list             # per level: np.ndarray [k^(l+1), 256] int8
    word_weights: np.ndarray  # [n_words] idf weights
    n_words: int
    # centre tables uploaded once per device, as float32
    _centers_dev: Dict[str, list] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def device_centers(self, device) -> list:
        """The centre tables on `device` (uploaded at the first call)."""
        key = str(torch.device(device))
        if key not in self._centers_dev:
            self._centers_dev[key] = [
                torch.from_numpy(np.asarray(c, np.float32)).to(device)
                for c in self.centers]
        return self._centers_dev[key]

    def transform_packed(self, desc_packed: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
        """[N, 8] int32 bit-view descriptors -> word ids [N] int32 (-1 where
        not valid), on the descriptors' device."""
        bits = unpack_bits(desc_packed).to(torch.float32) * 2.0 - 1.0
        return self.transform_pm1(bits, valid)

    def transform_pm1(self, bits_pm1: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
        """[N, 256] {-1, +1} -> word ids [N] int32."""
        centers = self.device_centers(bits_pm1.device)
        children = torch.arange(self.k, device=bits_pm1.device)
        node = torch.zeros(bits_pm1.shape[0], dtype=torch.int64,
                           device=bits_pm1.device)
        for lvl in range(self.levels):
            child_base = node * self.k
            cand = centers[lvl][child_base[:, None] + children[None, :]]  # [N,k,256]
            dots = (cand @ bits_pm1[:, :, None])[..., 0]                  # [N,k]
            alive = torch.sum(torch.abs(cand), dim=-1) > 0
            dots = torch.where(alive, dots, -1e9)
            # torch.max over a dim returns the first maximum: the lowest
            # child index wins a tie, as jnp.argmax
            node = child_base + torch.max(dots, dim=-1).indices
        return torch.where(valid, node, -1).to(torch.int32)

    def bow_vector(self, word_ids: np.ndarray) -> np.ndarray:
        """word ids [N] -> L1-normalised tf-idf dense vector [n_words]."""
        v = np.zeros(self.n_words, np.float32)
        ids = word_ids[word_ids >= 0]
        np.add.at(v, ids, self.word_weights[ids])
        s = v.sum()
        return v / s if s > 0 else v

    def score_l1(self, v1: np.ndarray, v2: np.ndarray) -> float:
        """DBoW2 L1 score of two L1-normalised vectors: 1 - 0.5 |v1 - v2|_1,
        in [0, 1]."""
        return float(1.0 - 0.5 * np.abs(v1 - v2).sum())


def load_vocabulary(path: str) -> Vocabulary:
    """A vocabulary saved by either package (the same npz format), e.g. one
    of the JAX package's larger trees at a path the caller gives."""
    z = np.load(path)
    levels = int(z["levels"])
    return Vocabulary(
        k=int(z["k"]), levels=levels,
        centers=[z[f"centers_{i}"] for i in range(levels)],
        word_weights=z["word_weights"], n_words=int(z["n_words"]))
