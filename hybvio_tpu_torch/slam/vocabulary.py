"""Bag-of-words vocabulary over binary ORB descriptors (port of the
reference package's ``slam/vocabulary.py``).

The reference's DBoW2 vocabulary tree is flattened into one (W, 256)
codebook of word centroids in {-1,+1}^256, trained online with
deterministic k-means on the session's own descriptors (or loaded from, and
saved to, a ``.npy`` at ``vocabularyPath``), with TF-IDF weighted,
L1-normalized BoW vectors scored by DBoW2's L1 metric (s(v, w) = sum_i
min(v_i, w_i)) and an inverted index (word -> keyframe ids) on the host.

The bookkeeping is the reference's numpy, copied. The k-means steps (a
``jax.jit`` on the host CPU there) run as torch on the session's device,
captured in a CUDA graph on the card (``graphs.CapturedStep``):
its +/-1 dot products are exact integers, so argmax ties are exact ties,
and the first index wins as in the reference.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..graphs import CapturedStep
from ..runtime import default_device

N_BITS = 256


def _kmeans_iterations(cb: torch.Tensor, d: torch.Tensor, valid: torch.Tensor,
                       iters: int) -> torch.Tensor:
    """``iters`` k-means steps of the codebook cb (W, 256) over the
    descriptors d (n, 256), of which the rows ``valid`` (n,) count: the
    padding rows add exact zeros to the exact integer sums and counts."""
    words = torch.arange(cb.shape[0], device=cb.device)
    w = valid.to(d.dtype)[:, None]
    for _ in range(iters):
        # assign: nearest centroid by dot product (== min Hamming for +/-1)
        a = torch.argmax(d @ cb.T, dim=1)  # (n,)
        one_hot = (a[:, None] == words[None, :]).to(d.dtype) * w  # (n, W)
        sums = one_hot.T @ d  # (W, 256)
        counts = one_hot.sum(dim=0)[:, None]
        # empty clusters keep their previous centroid
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cb)
        cb = torch.sign(torch.where(new == 0, cb, new))
    return cb


def _kmeans(desc: np.ndarray, n_words: int, iters: int, seed: int, device,
            iterate=_kmeans_iterations) -> np.ndarray:
    """Deterministic k-means over {-1,+1} descriptors on ``device``; returns
    (W, 256) float32 centroids (sign-quantized so word assignment is a
    Hamming nearest-neighbour, like DBoW2's binary node centroids). The
    descriptors are padded to the next power of two (at least 256) rows,
    so that a training pool that grows reuses a few captured programs
    (``iterate``, ``_kmeans_iterations`` or a captured form of it)."""
    rng = np.random.RandomState(seed)
    n = desc.shape[0]
    if n >= n_words:
        init = desc[rng.choice(n, n_words, replace=False)]
    else:  # top up with random hyperplane words
        extra = np.sign(rng.randn(n_words - n, N_BITS)).astype(np.float32)
        init = np.concatenate([desc, extra], axis=0)
    rows = 256
    while rows < n:
        rows *= 2
    padded = np.zeros((rows, N_BITS), np.float32)
    padded[:n] = desc
    on = lambda a: torch.as_tensor(a).to(device)
    cb = iterate(on(np.asarray(init, np.float32)), on(padded), on(np.arange(rows) < n), iters)
    return cb.cpu().numpy().astype(np.float32)


class Vocabulary:
    """Online-trained BoW vocabulary with an inverted index.

    Usage: feed descriptors of every keyframe with :meth:`add_keyframe`;
    retrieve loop candidates with :meth:`query`. Until ``train_size``
    descriptors have been seen, a deterministic random-hyperplane codebook
    (LSH) is used; k-means training (on ``device``: the card unless the
    caller asks for the CPU) then rebuilds all stored BoW vectors.
    """

    def __init__(self, n_words: int = 512, train_size: int = 2048,
                 kmeans_iters: int = 8, seed: int = 20240401,
                 path: Optional[str] = None,
                 reservoir_size: int = 4096,
                 retrain_every_docs: int = 32, device=None):
        self.device = torch.device(device) if device is not None else default_device()
        # the k-means steps, captured on the card (the reference jits them)
        self.kmeans_program = CapturedStep(_kmeans_iterations, "slam vocabulary k-means")
        self.n_words = n_words
        self.train_size = train_size
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        rng = np.random.RandomState(seed)
        self.codebook = np.sign(rng.randn(n_words, N_BITS)).astype(np.float32)
        self.trained = False
        # a vocabulary LOADED from vocabularyPath is a fixed pretrained
        # codebook (the reference's DBoW2 semantics: vocabularyPath points at
        # a prebuilt general vocabulary that never changes in-session)
        self.frozen = False
        if path and os.path.exists(path):
            loaded = np.load(path)
            if loaded.shape == (n_words, N_BITS):
                self.codebook = loaded.astype(np.float32)
                self.trained = True
                self.frozen = True
        # reservoir-sampled training pool spanning the WHOLE session (a
        # train-once-on-the-first-2048-descriptors codebook cannot represent
        # scenery first seen later; periodic retrain + _rebuild_all keeps
        # retrieval consistent)
        self.reservoir_size = reservoir_size
        self.retrain_every_docs = retrain_every_docs
        self._reservoir = np.zeros((0, N_BITS), np.float32)
        self._seen_desc = 0
        self._docs_at_train = 0
        self._reservoir_rng = np.random.RandomState(seed + 17)
        self._train_count = 0
        # per-keyframe raw descriptors kept until training so BoW vectors can
        # be rebuilt with the trained codebook
        self._kf_desc: Dict[int, np.ndarray] = {}
        # raw term (word) counts per keyframe; TF-IDF weighting is applied
        # LAZILY with the current document frequencies (weighting at insert
        # time would freeze a stale idf — the first document's would be zero)
        self._tf: Dict[int, np.ndarray] = {}
        self.words: Dict[int, np.ndarray] = {}  # kf_id -> sorted unique word ids
        self.inverted: Dict[int, Set[int]] = {}  # word -> kf ids
        self.n_docs = 0
        self._df = np.zeros(n_words, np.float64)  # document frequency

    # ------------------------------------------------------------- internals

    def _assign_words(self, desc: np.ndarray) -> np.ndarray:
        # plain numpy: (n, 256) @ (256, W) at keyframe rate is microseconds
        # on the host; a device dispatch would cost more than the matmul
        return np.argmax(desc @ self.codebook.T, axis=1).astype(np.int64)

    def _idf(self) -> np.ndarray:
        return np.log(max(self.n_docs, 1) + 1.0) - np.log(self._df + 1.0)

    def _bow_vec(self, kf_id: int, idf: Optional[np.ndarray] = None) -> np.ndarray:
        """L1-normalized TF-IDF vector with the CURRENT document frequencies."""
        v = self._tf[kf_id] * (self._idf() if idf is None else idf)
        s = v.sum()
        return (v / s if s > 0 else v)

    def _rebuild_all(self) -> None:
        """Re-assign every stored keyframe with the (re)trained codebook."""
        self.inverted = {}
        self._df[:] = 0.0
        for kf_id, desc in self._kf_desc.items():
            w = self._assign_words(desc)
            uw = np.unique(w)
            self._tf[kf_id] = np.bincount(w, minlength=self.n_words).astype(np.float64)
            self.words[kf_id] = uw
            self._df[uw] += 1.0
            for wid in uw:
                self.inverted.setdefault(int(wid), set()).add(kf_id)

    # ---------------------------------------------------------------- public

    def _reservoir_add(self, desc: np.ndarray) -> None:
        """Deterministic reservoir sampling over all session descriptors."""
        for row in desc:
            self._seen_desc += 1
            if len(self._reservoir) < self.reservoir_size:
                self._reservoir = np.concatenate(
                    [self._reservoir, row[None, :]])
            else:
                j = self._reservoir_rng.randint(self._seen_desc)
                if j < self.reservoir_size:
                    self._reservoir[j] = row

    def train_now(self) -> None:
        pool = self._reservoir
        if self.frozen or pool.shape[0] < self.n_words // 4:
            return
        self.codebook = _kmeans(pool, self.n_words, self.kmeans_iters, self.seed,
                                self.device, self.kmeans_program)
        self.trained = True
        self._docs_at_train = self.n_docs
        self._rebuild_all()

    def add_keyframe(self, kf_id: int, desc: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> None:
        if valid is not None:
            desc = desc[np.asarray(valid, bool)]
        desc = np.asarray(desc, np.float32)
        if desc.shape[0] == 0:
            return
        self._kf_desc[kf_id] = desc
        self.n_docs += 1
        if not self.frozen:
            self._reservoir_add(desc)
            self._train_count += desc.shape[0]
            retrain = (
                # initial training once enough material exists
                (not self.trained and self._train_count >= self.train_size)
                # periodic retrain so late-session scenery is representable
                or (self.trained and self.retrain_every_docs > 0
                    and self.n_docs - self._docs_at_train
                    >= self.retrain_every_docs))
            if retrain:
                self.train_now()
                if self.trained:
                    # train_now() -> _rebuild_all() already indexed THIS
                    # keyframe (tf/df/words/inverted); inserting again would
                    # permanently double-count its document frequencies
                    return
        w = self._assign_words(desc)
        uw = np.unique(w)
        self._df[uw] += 1.0
        self._tf[kf_id] = np.bincount(w, minlength=self.n_words).astype(np.float64)
        self.words[kf_id] = uw
        for wid in uw:
            self.inverted.setdefault(int(wid), set()).add(kf_id)

    def remove_keyframe(self, kf_id: int) -> None:
        """Culling support: drop a keyframe from the database."""
        if kf_id not in self._tf:
            return
        for wid in self.words[kf_id]:
            s = self.inverted.get(int(wid))
            if s is not None:
                s.discard(kf_id)
        self._df[self.words[kf_id]] -= 1.0
        del self._tf[kf_id]
        del self.words[kf_id]
        self._kf_desc.pop(kf_id, None)
        self.n_docs -= 1

    def score(self, kf_a: int, kf_b: int) -> float:
        """DBoW2 L1 score between two stored keyframes (1 = identical)."""
        if kf_a not in self._tf or kf_b not in self._tf:
            return 0.0
        idf = self._idf()
        va, vb = self._bow_vec(kf_a, idf), self._bow_vec(kf_b, idf)
        return float(np.minimum(va, vb).sum())

    def query(self, kf_id: int, exclude: Set[int],
              min_in_common_ratio: float = 0.3,
              min_score: float = 0.0,
              max_results: int = 5) -> List:
        """Retrieve loop-closure candidates for a stored keyframe.

        Shortlist via the inverted index (keyframes sharing >=
        min_in_common_ratio of the query's words — reference:
        slam.bowMinInCommonRatio), then score the shortlist with the batched
        L1 metric and return [(kf_id, score)] best-first with score >=
        min_score (the caller derives min_score from an adjacent-keyframe
        score per slam.bowScoreRatio).
        """
        uw = self.words.get(kf_id)
        if uw is None or len(uw) == 0:
            return []
        counts: Dict[int, int] = {}
        for wid in uw:
            for other in self.inverted.get(int(wid), ()):  # inverted index walk
                if other == kf_id or other in exclude:
                    continue
                counts[other] = counts.get(other, 0) + 1
        if not counts:
            return []
        need = max(1, int(np.ceil(min_in_common_ratio * len(uw))))
        short = [k for k, c in counts.items() if c >= need]
        if not short:
            return []
        idf = self._idf()
        vq = self._bow_vec(kf_id, idf)
        db = np.stack([self._bow_vec(k, idf) for k in short])  # (C, W)
        scores = np.minimum(db, vq[None, :]).sum(axis=1)  # batched L1 score
        order = np.argsort(-scores)
        out = [(short[i], float(scores[i])) for i in order if scores[i] >= min_score]
        return out[:max_results]

    def save(self, path: str) -> None:
        np.save(path, self.codebook)
