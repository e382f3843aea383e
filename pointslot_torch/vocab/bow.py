"""Bag-of-binary-words place recognition as one Hamming table per query.

Port of ``pointslot_tpu/vocab/bow.py`` (the flat vocabulary; the
reference's DBoW2 TemplatedVocabulary<FORB>): ``_unpack_bits``,
``_pack_bits``, ``BinaryVocabulary`` (binary k-means ``train``, tf-idf
``transform``, the L1 ``score``) and ``train_default_vocab``. Word
assignment is one popcount Hamming table (``ops/hamming.py``) and an
argmin on the vocabulary's device; ``torch.argmin`` and ``jnp.argmin`` both
return the first minimum, so word ids equal the reference's. The word
counts are small integers in float32 and sum exactly in any order.

``train_default_vocab`` loads the in-repo ``.cache/vocab_s0_w512.npz``
(resolved from the repository root, not the working directory) and trains
with the port's ORBExtractor only when that file is absent. The tree
vocabulary and the DBoW2 file loaders are not ported (ROADMAP item 13b).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pointslot_torch.convert import host, to_tensor
from pointslot_torch.device import resolve_device
from pointslot_torch.ops.hamming import hamming_table_popcount

CACHE_DIR = Path(__file__).resolve().parents[2] / ".cache"


def _unpack_bits(desc: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 256) {0,1} uint8."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(desc.shape[0], 256).astype(np.uint8)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, 256) {0,1} -> (N, 8) uint32."""
    b = bits.reshape(-1, 8, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (b << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)


def _hamming_host(desc: np.ndarray, words: np.ndarray, device) -> np.ndarray:
    """(N, 8) x (W, 8) uint32 words -> (N, W) int32 distances, on `device`."""
    d = hamming_table_popcount(to_tensor(desc, torch.int32, device),
                               to_tensor(words, torch.int32, device))
    return host(d)[0]


class BinaryVocabulary:
    def __init__(self, words: np.ndarray, idf: Optional[np.ndarray] = None, device="cuda"):
        self.device = resolve_device(device)
        self.words = np.asarray(words, np.uint32)          # (W, 8)
        self.n_words = len(self.words)
        self.idf = (
            np.asarray(idf, np.float32)
            if idf is not None
            else np.ones(self.n_words, np.float32)
        )
        self._words_dev = to_tensor(self.words, torch.int32, self.device)
        self._idf_dev = to_tensor(self.idf, torch.float32, self.device)

    # ------------------------------------------------------------------
    @classmethod
    def train(cls, descriptors: np.ndarray, n_words: int = 512, iters: int = 8,
              seed: int = 0, device="cuda") -> "BinaryVocabulary":
        """Binary k-means: Hamming assignment + per-bit majority centroids."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        desc = np.unique(descriptors, axis=0)
        if len(desc) < n_words:
            reps = -(-n_words // max(len(desc), 1))
            desc = np.tile(desc, (reps, 1))[: max(n_words, len(desc))]
        centroids = desc[rng.choice(len(desc), n_words, replace=False)]
        bits = _unpack_bits(desc)
        for _ in range(iters):
            assign = _hamming_host(desc, centroids, dev).argmin(axis=1)
            new_centroids = centroids.copy()
            for w in range(n_words):
                members = bits[assign == w]
                if len(members) == 0:
                    new_centroids[w] = desc[rng.integers(len(desc))]
                else:
                    new_centroids[w] = _pack_bits(
                        (members.mean(axis=0) > 0.5)[None, :].astype(np.uint8)
                    )[0]
            if np.array_equal(new_centroids, centroids):
                break
            centroids = new_centroids
        # idf from training distribution
        assign = _hamming_host(desc, centroids, dev).argmin(axis=1)
        counts = np.bincount(assign, minlength=n_words).astype(np.float64)
        idf = np.log(len(desc) / np.maximum(counts, 1.0)).astype(np.float32)
        return cls(centroids, idf, device=dev)

    # ------------------------------------------------------------------
    def transform_device(self, desc: torch.Tensor, valid: torch.Tensor):
        """(N, 8) int32 words, (N,) bool on the vocabulary's device ->
        (L1-normalized tf-idf (W,), word ids (N,) int32), device tensors."""
        d = hamming_table_popcount(desc, self._words_dev)   # (N, W)
        word = torch.argmin(d, dim=1)
        slot = torch.where(valid, word, torch.full_like(word, self.n_words))
        v = torch.zeros(self.n_words + 1, dtype=torch.float32, device=desc.device)
        v = v.index_add(0, slot, torch.ones_like(slot, dtype=torch.float32))[: self.n_words]
        v = v * self._idf_dev
        v = v / torch.clamp(v.abs().sum(), min=1e-9)
        return v, word.to(torch.int32)

    def transform(self, desc, valid):
        """(N, 8) descriptors (uint32 numpy or int32 tensor words) -> host
        (L1-normalized tf-idf (W,), word ids (N,)), in one transfer."""
        return host(*self.transform_device(to_tensor(desc, torch.int32, self.device),
                                           to_tensor(valid, torch.bool, self.device)))

    @staticmethod
    def score(v1, v2):
        """DBoW2 L1 similarity in [0, 1]:
        s = 1 - 0.5 * sum |v1/|v1| - v2/|v2||  (vectors already normalized)."""
        return 1.0 - 0.5 * (v1 - v2).abs().sum(dim=-1)


_default_vocab_cache = {}


def train_default_vocab(seed: int = 0, n_words: int = 512, cache_dir=None,
                        device="cuda") -> BinaryVocabulary:
    """The default vocabulary: `cache_dir` (the repository's ``.cache`` by
    default) holds ``vocab_s{seed}_w{n_words}.npz``; when it is absent, train
    one from ORB descriptors of synthetic scenes (the self-contained
    substitute for the reference's shipped ORBvoc binary) and write it
    there. Cached in-process per device."""
    dev = resolve_device(device)
    key = (seed, n_words, str(dev))
    if key in _default_vocab_cache:
        return _default_vocab_cache[key]
    cache_dir = Path(cache_dir) if cache_dir is not None else CACHE_DIR
    path = cache_dir / f"vocab_s{seed}_w{n_words}.npz"
    if path.is_file():
        z = np.load(path)
        vocab = BinaryVocabulary(z["words"], z["idf"], device=dev)
        _default_vocab_cache[key] = vocab
        return vocab

    from pointslot_torch.config import CameraConfig, ORBConfig
    from pointslot_torch.convert import desc_to_numpy
    from pointslot_torch.datasets.synthetic import SyntheticRenderer, make_scene
    from pointslot_torch.ops.orb import ORBExtractor

    cam = CameraConfig()
    all_desc = []
    for s in range(2):
        scene = make_scene(n_frames=3, n_points=2000, n_objects=2, seed=seed + s)
        renderer = SyntheticRenderer(scene)
        ext = ORBExtractor(cam.height, cam.width, ORBConfig(), device=dev)
        for i in range(0, 3):
            left, _, _ = renderer.render(i)
            f = ext(left)
            all_desc.append(desc_to_numpy(f.desc)[f.valid.cpu().numpy()])
    vocab = BinaryVocabulary.train(
        np.concatenate(all_desc), n_words=n_words, seed=seed, device=dev
    )
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, words=vocab.words, idf=vocab.idf)
    except OSError:
        pass
    _default_vocab_cache[key] = vocab
    return vocab
