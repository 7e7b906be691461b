"""Keyframe database: place-recognition index over bag-of-words vectors.

Own numpy copy of ``orbslam2_tpu/slammap/keyframe_db.py`` (the reference's
DBoW2 inverted file + KeyFrameDatabase). Each keyframe stores its sparse BoW
rows (word ids + L1-normalised tf-idf weights, one row per descriptor at
most), and a query builds one dense lookup vector over the vocabulary;
shared-word counts and L1 scores against all keyframes are then one gather +
reduction over the [K, W] id table: the array form of the inverted file.

Scoring identity used throughout: for L1-normalised nonnegative vectors,
1 - 0.5*|v1 - v2|_1  ==  sum_i min(v1_i, v2_i), which only touches the
words the keyframe actually contains.

Candidate selection mirrors DetectLoopCandidates and
DetectRelocalizationCandidates: 0.8*maxCommonWords gate, min-score gate,
covisibility-group score accumulation over the top-10 neighbours,
0.75*bestAccScore final cut.
"""
from __future__ import annotations

from typing import List

import numpy as np

from orbslam2_tpu_torch.place.vocabulary import Vocabulary
from orbslam2_tpu_torch.slammap import covisibility


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary, max_keyframes: int,
                 max_words_per_kf: int = 2304):
        self.voc = voc
        k, w = max_keyframes, max_words_per_kf
        self.wids = np.full((k, w), -1, np.int32)   # sparse word ids
        self.wts = np.zeros((k, w), np.float32)     # L1-normalized tf-idf
        self.valid = np.zeros(k, bool)

    def add(self, kf: int, word_ids: np.ndarray) -> None:
        ids = np.asarray(word_ids)
        ids = ids[ids >= 0]
        uids, counts = np.unique(ids, return_counts=True)
        wts = counts.astype(np.float32) * self.voc.word_weights[uids]
        s = wts.sum()
        if s > 0:
            wts /= s
        n = min(len(uids), self.wids.shape[1])
        self.wids[kf] = -1
        self.wts[kf] = 0.0
        self.wids[kf, :n] = uids[:n]
        self.wts[kf, :n] = wts[:n]
        self.valid[kf] = True

    def erase(self, kf: int) -> None:
        self.valid[kf] = False
        self.wids[kf] = -1
        self.wts[kf] = 0.0

    # ------------------------------------------------------------------
    def score_against_all(self, v: np.ndarray) -> np.ndarray:
        """L1 similarity of dense query vector v against every stored KF:
        score = sum_i min(v_kf_i, v_i) over the KF's own words."""
        g = v[np.maximum(self.wids, 0)] * (self.wids >= 0)
        s = np.minimum(g, self.wts).sum(axis=1)
        return np.where(self.valid, s, -1.0)

    def score_kf(self, v: np.ndarray, kf: int) -> float:
        """L1 similarity of dense query v against one stored keyframe."""
        row_ids = self.wids[kf]
        g = v[np.maximum(row_ids, 0)] * (row_ids >= 0)
        return float(np.minimum(g, self.wts[kf]).sum())

    def _common_words(self, v: np.ndarray) -> np.ndarray:
        """[K] count of words shared with the dense query vector."""
        has = v > 0
        return (has[np.maximum(self.wids, 0)] & (self.wids >= 0)).sum(axis=1)

    # ------------------------------------------------------------------
    def _group_and_select(self, cand_mask: np.ndarray, scores: np.ndarray,
                          w: np.ndarray) -> List[int]:
        """Covisibility-group score accumulation + 0.75*best cut."""
        cands = np.where(cand_mask)[0]
        if len(cands) == 0:
            return []
        acc_best_kf = np.zeros(len(cands), np.int64)
        acc_scores = np.zeros(len(cands), np.float32)
        for i, c in enumerate(cands):
            group = [c, *covisibility.best_covisible(w, int(c), 10)]
            g_scores = [scores[g] if cand_mask[g] else 0.0 for g in group]
            acc_scores[i] = float(np.sum(g_scores))
            acc_best_kf[i] = group[int(np.argmax(g_scores))]
        best_acc = acc_scores.max()
        keep = acc_scores > 0.75 * best_acc
        out: List[int] = []
        for kf in acc_best_kf[keep]:
            if kf not in out:
                out.append(int(kf))
        return out

    # ------------------------------------------------------------------
    def detect_loop_candidates(self, kf: int, min_score: float,
                               w: np.ndarray, m,
                               exclude_mask: np.ndarray | None = None,
                               query_bow: np.ndarray | None = None) -> List[int]:
        """Loop candidates for keyframe kf, excluding its covisible set.

        `exclude_mask`: extra exclusions (e.g. temporally recent keyframes —
        in the reference these are implicitly excluded because its denser
        covisibility graph marks them as connected).
        `query_bow`: the query's dense bow vector — required when kf has not
        been added to the database yet (detection runs before insertion,
        LoopClosing.cc:270-276)."""
        v = query_bow if query_bow is not None else self.dense_bow(kf)
        common = self._common_words(v)
        connected = np.zeros(len(self.valid), bool)
        connected[w[kf] > 0] = True
        connected[kf] = True
        if exclude_mask is not None:
            connected |= exclude_mask
        eligible = self.valid & ~connected & (common > 0)
        if not eligible.any():
            return []
        max_common = common[eligible].max()
        min_common = 0.8 * max_common
        scores = self.score_against_all(v)
        cand_mask = eligible & (common > min_common) & (scores >= min_score)
        return self._group_and_select(cand_mask, scores, w)

    def detect_reloc_candidates(self, word_ids: np.ndarray, w: np.ndarray) -> List[int]:
        """Relocalization candidates for an untracked frame."""
        v = self.voc.bow_vector(word_ids)
        common = self._common_words(v)
        eligible = self.valid & (common > 0)
        if not eligible.any():
            return []
        max_common = common[eligible].max()
        cand_mask = eligible & (common > 0.8 * max_common)
        scores = self.score_against_all(v)
        return self._group_and_select(cand_mask, scores, w)

    # ------------------------------------------------------------------
    def dense_bow(self, kf: int) -> np.ndarray:
        """Reconstruct the dense BoW vector of a stored keyframe (query
        staging only — never materialized per-database)."""
        v = np.zeros(self.voc.n_words, np.float32)
        sel = self.wids[kf] >= 0
        v[self.wids[kf, sel]] = self.wts[kf, sel]
        return v
