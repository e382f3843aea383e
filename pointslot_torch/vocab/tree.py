"""Hierarchical binary vocabulary + sparse BoW database at ORBvoc scale.

Port of ``pointslot_tpu/vocab/tree.py``. The reference descends a k^L tree
of binary centroids (Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1343:
ORBvoc is k = 10, L = 6, ~1M leaves) and scores keyframes through an
inverted index (src/KeyFrameDatabase.cc).

- ``TreeVocabulary``: the node tables (descriptors as int32 words, children
  with -1 padding, the leaves' word ids and weights) are put on the
  vocabulary's device once, at construction; the transform is ``depth``
  stages of torch ops there: gather each feature's current node's k
  children, XOR, popcount (``ops/hamming.py::popcount32``), argmin (ties to
  the first child, as ``jnp.argmin``), a leaf staying put. Word ids equal
  the reference's. A tree loaded from a DBoW2 file has ``depth = L + 1``
  (``vocab/bow.py``), so one more stage runs in which every feature already
  sits on a leaf; it is kept so that words and timings match the
  reference's.
- ``train``, ``save_binary``, ``from_parent_array`` and ``synthesize`` are
  the reference's host numpy, the random calls in the same order, so that a
  seed gives the same arrays.
- ``SparseKeyFrameDatabase``: the reference's host inverted index. For
  L1-normalized non-negative vectors the DBoW2 L1 score 1 - 0.5 sum|a - b|
  equals the sum over common words of min(a_i, b_i), so a query walks only
  the posting lists of its words.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from pointslot_torch.convert import host, to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.ops.hamming import popcount32

BIG = 1 << 20


def _popcount_bytes(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


class TreeVocabulary:
    """k-ary binary vocabulary tree with a staged descent on the device."""

    def __init__(self, node_desc: np.ndarray, children: np.ndarray,
                 weights: np.ndarray, is_leaf: np.ndarray,
                 k: int, depth: int, device="cuda"):
        self.device = resolve_device(device)
        self.node_desc = np.asarray(node_desc, np.uint32)    # (T, 8)
        self.children = np.asarray(children, np.int32)       # (T, k) -1 pad
        self.node_weights = np.asarray(weights, np.float32)  # (T,)
        self.is_leaf = np.asarray(is_leaf, bool)             # (T,)
        self.k = int(k)
        self.depth = int(depth)
        # word id = rank of the leaf among leaves (node-array order), the
        # same convention DBoW2 uses when it assigns word ids at load
        leaf_word = np.full(len(self.node_desc), -1, np.int32)
        leaf_idx = np.nonzero(self.is_leaf)[0]
        leaf_word[leaf_idx] = np.arange(len(leaf_idx), dtype=np.int32)
        self.leaf_word = leaf_word
        self.n_words = int(len(leaf_idx))
        self.word_weights = self.node_weights[leaf_idx].astype(np.float32)

        d = self.device
        self._desc_dev = to_tensor(self.node_desc, torch.int32, d)
        self._children_dev = to_tensor(self.children, torch.int32, d)
        self._leaf_word_dev = to_tensor(self.leaf_word, torch.int32, d)
        self._word_w_dev = to_tensor(self.word_weights, torch.float32, d)

    @property
    def device_bytes(self) -> int:
        """Bytes of the node tables held on the device."""
        return sum(t.numel() * t.element_size() for t in (
            self._desc_dev, self._children_dev, self._leaf_word_dev, self._word_w_dev))

    # ------------------------------------------------------------------
    def transform_device(self, desc: torch.Tensor, valid: torch.Tensor):
        """Staged tree descent of (N, 8) int32 words, (N,) bool on the
        vocabulary's device: (word ids (N,) int32, -1 for invalid features;
        tf-idf weights (N,) f32 per feature before aggregation)."""
        n = desc.shape[0]
        cur = torch.zeros(n, dtype=torch.int64, device=desc.device)   # root = node 0
        for _ in range(self.depth):
            ch = self._children_dev[cur].long()                       # (N, k)
            ch_desc = self._desc_dev[torch.clamp(ch, min=0)]          # (N, k, 8)
            d = popcount32(ch_desc ^ desc[:, None, :]).sum(dim=-1, dtype=torch.int32)
            d = torch.where(ch >= 0, d, torch.full_like(d, BIG))
            best = torch.argmin(d, dim=1)
            nxt = ch.gather(1, best[:, None])[:, 0]
            cur = torch.where(nxt >= 0, nxt, cur)   # leaves stay put
        word = self._leaf_word_dev[cur]
        word = torch.where(valid, word, torch.full_like(word, -1))
        w = torch.where(word >= 0, self._word_w_dev[torch.clamp(word, min=0).long()],
                        torch.zeros_like(word, dtype=torch.float32))
        return word, w

    def _transform(self, desc, valid):
        """Host (word ids, weights) of numpy or tensor inputs, in one
        transfer."""
        return host(*self.transform_device(to_tensor(desc, torch.int32, self.device),
                                           to_tensor(valid, torch.bool, self.device)))

    # ------------------------------------------------------------------
    def bow_vector(self, desc, valid) -> Tuple[np.ndarray, np.ndarray]:
        """(unique word ids (M,), L1-normalized tf-idf weights (M,))."""
        word, w = self._transform(desc, valid)
        keep = word >= 0
        if not keep.any():
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        uw, inv = np.unique(word[keep], return_inverse=True)
        acc = np.zeros(len(uw), np.float64)
        np.add.at(acc, inv, w[keep])
        total = acc.sum()
        if total <= 0:
            # zero-idf vocabulary: fall back to term counts
            np.add.at(acc, inv, 1.0)
            total = acc.sum()
        return uw.astype(np.int32), (acc / max(total, 1e-9)).astype(np.float32)

    def word_ids(self, desc, valid) -> np.ndarray:
        """(N,) word id per feature (-1 invalid): the direct-index analog
        used for BoW-gated feature matching."""
        return self._transform(desc, valid)[0]

    # ------------------------------------------------------------------
    @classmethod
    def train(cls, descriptors: np.ndarray, k: int = 10, depth: int = 3,
              seed: int = 0, kmeans_iters: int = 6, device="cuda") -> "TreeVocabulary":
        """Hierarchical binary k-means (majority-vote centroids), the same
        construction DBoW2 uses offline. Builds up to k^depth leaves."""
        from pointslot_torch.vocab.bow import _pack_bits, _unpack_bits

        rng = np.random.default_rng(seed)
        desc = np.unique(np.asarray(descriptors, np.uint32), axis=0)
        bits_all = _unpack_bits(desc)

        node_desc: List[np.ndarray] = [np.zeros(8, np.uint32)]  # root
        children: List[List[int]] = [[]]

        def split(node: int, idx: np.ndarray, level: int):
            if level >= depth or len(idx) <= 1:
                return
            kk = min(k, len(idx))
            cent = desc[rng.choice(idx, kk, replace=False)]
            for _ in range(kmeans_iters):
                x = desc[idx, None, :] ^ cent[None, :, :]
                d = _popcount_bytes(x)
                assign = d.argmin(1)
                new = cent.copy()
                for c in range(kk):
                    m = bits_all[idx[assign == c]]
                    if len(m):
                        new[c] = _pack_bits(
                            (m.mean(0) > 0.5)[None].astype(np.uint8))[0]
                if np.array_equal(new, cent):
                    break
                cent = new
            x = desc[idx, None, :] ^ cent[None, :, :]
            d = _popcount_bytes(x)
            assign = d.argmin(1)
            for c in range(kk):
                sub = idx[assign == c]
                if len(sub) == 0:
                    continue
                node_desc.append(cent[c])
                children.append([])
                cid = len(node_desc) - 1
                children[node].append(cid)
                split(cid, sub, level + 1)

        split(0, np.arange(len(desc)), 0)

        T = len(node_desc)
        ch = np.full((T, k), -1, np.int32)
        for i, cs in enumerate(children):
            ch[i, : len(cs)] = cs
        is_leaf = np.array([len(cs) == 0 for cs in children], bool)
        is_leaf[0] = False
        # idf weights over the training set
        vocab = cls(np.stack(node_desc), ch, np.ones(T, np.float32), is_leaf, k, depth,
                    device=device)
        word = vocab.word_ids(desc, np.ones(len(desc), bool))
        counts = np.bincount(word[word >= 0], minlength=vocab.n_words).astype(np.float64)
        idf = np.log(len(desc) / np.maximum(counts, 1.0)).astype(np.float32)
        w = np.zeros(T, np.float32)
        w[vocab.leaf_word >= 0] = idf[vocab.leaf_word[vocab.leaf_word >= 0]]
        return cls(np.stack(node_desc), ch, w, is_leaf, k, depth, device=device)

    # ------------------------------------------------------------------
    def save_binary(self, path: str) -> None:
        """Write the DBoW2 binary layout (records are nodes 1.., the parent
        field is a node id); round-trips through load_orb_vocab_binary."""
        from pointslot_torch.vocab.bow import save_orb_vocab_binary

        T = len(self.node_desc)
        parents = np.zeros(T, np.int32)
        idx = np.repeat(np.arange(T, dtype=np.int32), self.children.shape[1])
        ch = self.children.ravel()
        m = ch >= 0
        parents[ch[m]] = idx[m]
        save_orb_vocab_binary(
            path, parents[1:], self.node_desc[1:].view(np.uint8),
            self.node_weights[1:], self.is_leaf[1:],
            k=self.k, L=self.depth,
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_parent_array(cls, parents: np.ndarray, desc: np.ndarray,
                          weights: np.ndarray, is_leaf: np.ndarray,
                          k: int, depth: int, device="cuda") -> "TreeVocabulary":
        """Build from the (parent-pointer) node records of the DBoW2
        binary/text formats (the layout the reference loads at
        src/System.cc:79 via TemplatedVocabulary::loadFromBinaryFile):
        records are nodes 1..N in file order, the implicit root is node 0,
        and each record's parent field is a node id (0 = child of root)."""
        parents = np.asarray(parents, np.int64)
        T = len(parents) + 1  # records exclude the root
        node_desc = np.zeros((T, 8), np.uint32)
        node_desc[1:] = np.asarray(desc, np.uint32).reshape(-1, 8)
        w = np.zeros(T, np.float32)
        w[1:] = weights
        leaf = np.zeros(T, bool)
        leaf[1:] = is_leaf
        counts = np.bincount(parents, minlength=T)
        kk = max(int(counts.max(initial=1)), 1)
        children = np.full((T, kk), -1, np.int32)
        # vectorized child-slot assignment: stable-sort records by parent,
        # then each record's slot is its rank within its parent group
        order = np.argsort(parents, kind="stable")
        sp = parents[order]
        rank = np.arange(len(sp)) - np.searchsorted(sp, sp, side="left")
        children[sp, rank] = (order + 1).astype(np.int32)
        return cls(node_desc, children, w, leaf, kk, depth, device=device)

    @classmethod
    def synthesize(cls, k: int = 10, depth: int = 6, seed: int = 0,
                   device="cuda") -> "TreeVocabulary":
        """Random perfect k^depth tree at the ORBvoc operating point (k = 10,
        L = 6, ~1M leaves, the scale the reference loads at startup,
        src/System.cc:79). No ORBvoc file is in the repository; a
        synthesized tree exercises memory, descent time and the sparse
        database at the reference's scale. Breadth-first layout: level l
        occupies nodes [(k^l-1)/(k-1), (k^{l+1}-1)/(k-1))."""
        rng = np.random.default_rng(seed)
        level_sizes = [k**l for l in range(depth + 1)]
        T = sum(level_sizes)
        node_desc = rng.integers(0, 2**32, (T, 8), dtype=np.uint32)
        node_desc[0] = 0
        children = np.full((T, k), -1, np.int32)
        off = 0
        for l in range(depth):
            n_l = level_sizes[l]
            base = off + n_l + np.arange(n_l, dtype=np.int64) * k
            children[off : off + n_l] = (base[:, None] + np.arange(k)).astype(np.int32)
            off += n_l
        is_leaf = np.zeros(T, bool)
        is_leaf[T - level_sizes[depth] :] = True
        weights = np.zeros(T, np.float32)
        weights[is_leaf] = rng.uniform(0.2, 1.0, level_sizes[depth])
        return cls(node_desc, children, weights, is_leaf, k, depth, device=device)


class SparseKeyFrameDatabase:
    """Inverted-index BoW database (reference src/KeyFrameDatabase.cc),
    memory O(K * words per keyframe): scales to ORBvoc-size vocabularies."""

    def __init__(self, vocab: TreeVocabulary, max_kfs: int):
        self.vocab = vocab
        self._kf: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._inv: Dict[int, Dict[int, float]] = {}
        self.max_kfs = max_kfs

    def transform(self, desc: np.ndarray, valid: np.ndarray):
        return self.vocab.bow_vector(desc, valid)

    def clear(self):
        self._kf.clear()
        self._inv.clear()

    def add(self, kf: int, desc: np.ndarray, valid: np.ndarray):
        if kf in self._kf:
            self.remove(kf)
        words, weights = self.vocab.bow_vector(desc, valid)
        self._kf[kf] = (words, weights)
        for w, wt in zip(words.tolist(), weights.tolist()):
            self._inv.setdefault(w, {})[kf] = wt
        return (words, weights)

    def remove(self, kf: int):
        entry = self._kf.pop(kf, None)
        if entry is None:
            return
        for w in entry[0].tolist():
            post = self._inv.get(w)
            if post is not None:
                post.pop(kf, None)
                if not post:
                    del self._inv[w]

    def pair_score(self, kf: int, vec) -> float:
        """DBoW2 L1 similarity of a stored keyframe against a query vector
        (for L1-normalized non-negative vectors: the sum of the minima over
        common words)."""
        entry = self._kf.get(kf)
        if entry is None:
            return -1.0
        qw, qv = vec
        kw, kv = entry
        common, qi, ki = np.intersect1d(qw, kw, return_indices=True)
        if len(common) == 0:
            return 0.0
        return float(np.minimum(qv[qi], kv[ki]).sum())

    def query(self, vec, exclude: Set[int], min_score: float) -> List[int]:
        qw, qv = vec
        scores: Dict[int, float] = {}
        for w, wt in zip(qw.tolist(), qv.tolist()):
            for kf, kwt in self._inv.get(w, {}).items():
                scores[kf] = scores.get(kf, 0.0) + min(wt, kwt)
        ids = [k for k, s in scores.items() if s >= min_score and k not in exclude]
        return sorted(ids, key=lambda k: -scores[k])
