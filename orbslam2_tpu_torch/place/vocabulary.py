"""Binary bag-of-words vocabulary tree (the reference's DBoW2).

Counterpart of ``orbslam2_tpu/place/vocabulary.py``; reads and writes the
same npz format. The tree is one table of children centres per level: level
l holds k^(l+1) slots (the children of every level-(l-1) slot, contiguous),
each a 256-vector in {-1, 0, +1} (int8; all-zero rows are dead nodes).
Leaves are the last level and a word id is a leaf slot.

The descent of all descriptors runs on the device, one level at a time: the
k children centres of each descriptor's node are gathered (the tables stay
int8 on the device; only the gathered rows become float32) and compared
with the descriptor's {-1, +1} bits by a float32 product (the Hamming
distance is (256 - product) / 2; the sums are exact up to 256). The nearest
child wins, dead children never, and a tie goes to the lowest child index,
as the JAX package's argmax breaks it: otherwise word ids would differ.

A bag-of-words vector is a dense L1-normalised tf-idf array over the words;
scoring is DBoW2's L1 score.

Training (``train_vocabulary``) is hierarchical binary k-medians, the role
of DBoW2's ``create()``: the nearest-centre assignments and the members'
bit counts run on the device (float32 products of {-1, +1} bits with TF32
off, and integer sums: both exact), the choices of seeds and of rows for
empty clusters on the host from ``np.random.default_rng(seed)``, drawn in
the JAX package's order. The tree, centres and idf weights, is the JAX
package's for the same corpus and seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from orbslam2_tpu_torch import resolve_device
from orbslam2_tpu_torch.ops.orb import DESC_BITS, unpack_bits

# descriptors per transform call in the idf pass: [rows, k, 256] float32 rows
TRANSFORM_CHUNK = 32768


@dataclasses.dataclass
class Vocabulary:
    """Flat vocabulary tree (see the module docstring)."""
    k: int
    levels: int
    centers: list             # per level: np.ndarray [k^(l+1), 256] int8
    word_weights: np.ndarray  # [n_words] idf weights
    n_words: int
    # centre tables uploaded once per device, as int8
    _centers_dev: Dict[str, list] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def device_centers(self, device) -> list:
        """The centre tables on `device` (uploaded at the first call)."""
        key = str(torch.device(device))
        if key not in self._centers_dev:
            self._centers_dev[key] = [
                torch.from_numpy(np.ascontiguousarray(c, np.int8)).to(device)
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
            cand = centers[lvl][child_base[:, None] + children[None, :]].to(
                torch.float32)                                            # [N,k,256]
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


def _packed_tensor(descriptors_packed) -> torch.Tensor:
    """The port's int32 bit-view tensor, or the JAX package's uint32 words."""
    if isinstance(descriptors_packed, torch.Tensor):
        return descriptors_packed.to(torch.int32)
    return torch.from_numpy(np.ascontiguousarray(descriptors_packed, np.uint32).view(np.int32))


def train_vocabulary(descriptors_packed, k: int = 10, levels: int = 3,
                     seed: int = 0, iters: int = 8,
                     fit_cap: Optional[int] = None,
                     assign_chunk: int = 262144, device="cuda") -> Vocabulary:
    """Hierarchical binary k-medians on packed descriptors [N, 8] (the
    port's int32 bit-views, or uint32 words), on ``device``.

    Every node clusters its descriptors into k children: ``iters`` rounds of
    nearest-centre assignment and bitwise-majority medoids from k seed rows,
    stopping early when the centres do not change; a child left empty takes
    a random row of the node. ``fit_cap``: the rounds use at most this many
    of the node's rows (drawn without replacement), the final assignment of
    all of them the resulting centres. ``assign_chunk``: rows per product in
    that assignment. The idf weights come from the training corpus
    (TemplatedVocabulary::setNodeWeights): log(N / count) per word, 0 for
    unused words."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    packed = _packed_tensor(descriptors_packed).to(dev)
    bits = unpack_bits(packed)                       # [N, 256] 0/1 uint8
    n = bits.shape[0]
    centers_by_level = [np.zeros((k ** (l + 1), DESC_BITS), np.int8)
                        for l in range(levels)]

    def pm1(b: torch.Tensor) -> torch.Tensor:
        return b.to(torch.float32) * 2.0 - 1.0

    def rows(data: torch.Tensor, idx) -> torch.Tensor:
        return data[torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=dev)]

    def assign_to(data: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
        """Nearest centre (largest {-1,+1} product, the first on a tie), in
        chunks of rows."""
        cf = pm1(cents).T
        return torch.cat([torch.argmax(pm1(data[s:s + assign_chunk]) @ cf, dim=1)
                          for s in range(0, len(data), assign_chunk)])

    def kmedians(data: torch.Tensor):
        """-> (centre bits [n_c, 256] 0/1, assignment [len(data)])."""
        fit = data
        if fit_cap is not None and len(data) > fit_cap:
            fit = rows(data, rng.choice(len(data), fit_cap, replace=False))
        m = len(fit)
        n_c = min(k, m)
        cents = rows(fit, rng.choice(m, size=n_c, replace=False))
        fit_f, fit_i = pm1(fit), fit.to(torch.int32)
        for _ in range(iters):
            assign = torch.argmax(fit_f @ pm1(cents).T, dim=1)
            counts = torch.bincount(assign, minlength=n_c)
            ones = torch.zeros((n_c, DESC_BITS), dtype=torch.int32, device=dev)
            ones.index_add_(0, assign, fit_i)
            # majority vote: mean >= 0.5
            new = (2 * ones >= counts[:, None]).to(torch.uint8)
            for c in np.flatnonzero(counts.cpu().numpy() == 0):
                new[c] = rows(fit, rng.integers(0, m, 1))[0]
            converged = torch.equal(new, cents)
            cents = new
            if converged:
                break
        return cents, assign_to(data, cents)

    def split(data: torch.Tensor, level: int, slot: int) -> None:
        if len(data) == 0:
            return
        cents, assign = kmedians(data)
        base = slot * k
        cents_np = cents.cpu().numpy().astype(np.int8)
        for c in range(len(cents_np)):
            centers_by_level[level][base + c] = cents_np[c] * 2 - 1
            if level + 1 < levels:
                split(data[assign == c], level + 1, base + c)

    split(bits, 0, 0)

    n_words = k ** levels
    voc = Vocabulary(k=k, levels=levels, centers=centers_by_level,
                     word_weights=np.ones(n_words, np.float32), n_words=n_words)
    ids = torch.cat([voc.transform_packed(chunk, torch.ones(len(chunk), dtype=torch.bool,
                                                            device=dev))
                     for chunk in packed.split(TRANSFORM_CHUNK)]).cpu().numpy()
    counts = np.bincount(ids[ids >= 0], minlength=n_words).astype(np.float32)
    idf = np.log(n / np.maximum(counts, 1.0))
    voc.word_weights = np.where(counts > 0, idf, 0.0).astype(np.float32)
    return voc


def save_vocabulary(voc: Vocabulary, path: str) -> None:
    """The npz both packages read (``load_vocabulary``)."""
    np.savez_compressed(
        path, k=voc.k, levels=voc.levels, n_words=voc.n_words,
        word_weights=voc.word_weights,
        **{f"centers_{i}": c for i, c in enumerate(voc.centers)})
