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
with the port's ORBExtractor only when that file is absent.

The DBoW2 file loaders and saver (``load_vocab``, ``load_orb_vocab_binary``
with ``.gz``, ``strict`` and ``expect_sha256``, ``save_orb_vocab_binary``,
``load_orb_vocab_text``) are the reference's host code. At or under
``TREE_WORD_THRESHOLD`` words a loader returns a ``BinaryVocabulary`` of
the leaves; above it, or with ``as_tree``, the tree (``vocab/tree.py``),
with ``depth = L + 1`` as in the reference. Either lives on `device`.
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


# Above this many words a dense (N_feat, W) assignment table / (K, W)
# database matrix stops being reasonable; loaders switch to the tree
# vocabulary (staged descent) + sparse inverted-index database.
TREE_WORD_THRESHOLD = 4096


def load_vocab(path: str, as_tree: Optional[bool] = None, device="cuda"):
    """Load a DBoW2 vocabulary by format: .bin (optionally .bin.gz) binary
    layout (the file the reference loads at src/System.cc:79), anything
    else the text export. Returns a flat BinaryVocabulary for small files
    and a TreeVocabulary above TREE_WORD_THRESHOLD words; force with
    as_tree."""
    if path.endswith((".bin", ".bin.gz")):
        return load_orb_vocab_binary(path, as_tree=as_tree, device=device)
    return load_orb_vocab_text(path, as_tree=as_tree, device=device)


def load_orb_vocab_binary(path: str, as_tree: Optional[bool] = None,
                          strict: bool = False,
                          expect_sha256: Optional[str] = None, device="cuda"):
    """Load a DBoW2 binary vocabulary (ORBvoc.bin, the format the reference
    loads at startup, src/System.cc:79 via TemplatedVocabulary::
    loadFromBinaryFile, Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1343).

    Layout: 24-byte header (u32 nb_nodes, u32 size_node, i32 k, i32 L,
    i32 scoring, i32 weighting), then nb_nodes fixed-size records of
    size_node bytes: i32 parent | 32 descriptor bytes | f32 weight |
    u8 is_leaf. Accepts gzip-compressed files (.gz).

    ``strict`` validates the tree's structural invariants (parent indices
    in range and topologically ordered, branching factor against the
    header's k, finite non-negative weights, leaf count <= k^L), so that a
    record-layout mismatch fails at load time instead of mis-parsing.
    ``expect_sha256`` pins the exact file."""
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "rb") as f:
            raw = f.read()
    else:
        with open(path, "rb") as f:
            raw = f.read()
    if expect_sha256 is not None:
        import hashlib

        got = hashlib.sha256(raw).hexdigest()
        if got != expect_sha256.lower():
            raise ValueError(f"{path}: sha256 {got} != expected {expect_sha256}")
    if len(raw) < 24:
        raise ValueError(f"{path}: truncated vocabulary header")
    nb_nodes, size_node = np.frombuffer(raw[:8], np.uint32)
    if size_node < 41:
        raise ValueError(f"{path}: node record too small ({size_node} B)")
    body = raw[24 : 24 + int(nb_nodes) * int(size_node)]
    if len(body) < int(nb_nodes) * int(size_node):
        raise ValueError(f"{path}: expected {nb_nodes} nodes, file truncated")
    rec = np.frombuffer(body, np.uint8).reshape(int(nb_nodes), int(size_node))
    parents = rec[:, 0:4].copy().view(np.int32).ravel()
    desc = rec[:, 4:36]
    weight = rec[:, 36:40].copy().view(np.float32).ravel()
    is_leaf = rec[:, 40] != 0
    if not is_leaf.any():
        raise ValueError(f"{path}: vocabulary has no leaf words")
    n_words = int(is_leaf.sum())
    if strict:
        _validate_vocab_structure(path, raw, parents, weight, is_leaf)
    if as_tree or (as_tree is None and n_words > TREE_WORD_THRESHOLD):
        from pointslot_torch.vocab.tree import TreeVocabulary

        k, L = np.frombuffer(raw[8:16], np.int32)
        return TreeVocabulary.from_parent_array(
            parents, np.ascontiguousarray(desc).view(np.uint32), weight,
            is_leaf, k=max(int(k), 2), depth=max(int(L), 1) + 1, device=device,
        )
    words = np.ascontiguousarray(desc[is_leaf]).view(np.uint32)
    return BinaryVocabulary(words, weight[is_leaf].astype(np.float32), device=device)


def _validate_vocab_structure(path, raw, parents, weight, is_leaf):
    """Strict-parse invariants of the DBoW2 node-record layout (see
    load_orb_vocab_binary). Raises ValueError naming every problem: the
    failure to catch is a plausible-looking but wrong byte offset, which
    corrupts every field at once."""
    n = len(parents)   # records = nodes 1..n; node 0 (the root) implicit
    k, L = (int(x) for x in np.frombuffer(raw[8:16], np.int32))
    problems = []
    if not (2 <= k <= 64):
        problems.append(f"branching factor k={k} implausible")
    if not (1 <= L <= 12):
        problems.append(f"depth L={L} implausible")
    # record i is node i+1; its parent field is a node id (0 = root) that
    # must precede it: DBoW2 serializes parents before children
    node_ids = np.arange(1, n + 1)
    bad_parent = (parents < 0) | (parents >= node_ids)
    if bad_parent.any():
        i = int(np.argmax(bad_parent))
        problems.append(f"node {i + 1} parent {parents[i]} out of topological order")
    if not np.isfinite(weight).all():
        problems.append("non-finite weights")
    elif (weight < 0).any():
        problems.append(f"{int((weight < 0).sum())} negative weights")
    # parents must be internal nodes (parent node id p>0 -> record p-1)
    rec_parents = parents[parents > 0] - 1
    if len(rec_parents):
        leaf_parents = is_leaf[np.clip(rec_parents, 0, n - 1)]
        if leaf_parents.any():
            bad = parents[parents > 0][np.argmax(leaf_parents)]
            problems.append(f"a node's parent {bad} is a leaf")
    counts = np.bincount(np.clip(parents, 0, n), minlength=n + 1)
    if counts.max() > k:
        problems.append(f"a node has {int(counts.max())} children (> k={k})")
    n_words = int(is_leaf.sum())
    if n_words > k ** L:
        problems.append(f"{n_words} leaves > k^L = {k ** L}")
    if problems:
        raise ValueError(
            f"{path}: strict vocabulary parse failed — " + "; ".join(problems)
            + f" (header: n={n}, k={k}, L={L})")


def save_orb_vocab_binary(path: str, parents: np.ndarray, desc: np.ndarray,
                          weights: np.ndarray, is_leaf: np.ndarray,
                          k: int = 10, L: int = 6) -> None:
    """Write the DBoW2 binary layout (the counterpart of
    load_orb_vocab_binary; the reference only ships the pre-built file)."""
    n = len(parents)
    size_node = 41
    header = np.array([n, size_node], np.uint32).tobytes()
    header += np.array([k, L, 0, 0], np.int32).tobytes()
    rec = np.zeros((n, size_node), np.uint8)
    rec[:, 0:4] = np.asarray(parents, np.int32)[:, None].view(np.uint8).reshape(n, 4)
    rec[:, 4:36] = np.asarray(desc, np.uint8).reshape(n, 32)
    rec[:, 36:40] = np.asarray(weights, np.float32)[:, None].view(np.uint8).reshape(n, 4)
    rec[:, 40] = np.asarray(is_leaf, bool).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(header + rec.tobytes())


def load_orb_vocab_text(path: str, as_tree: Optional[bool] = None, device="cuda"):
    """Load a DBoW2 text-format vocabulary (ORBvoc.txt): header 'k L s1 s2'
    then one node per line: parent is_leaf 32-byte-descriptor weight.
    Small files keep only the leaves (flat lookup); large ones keep the
    tree for the staged descent (see load_vocab)."""
    with open(path) as f:
        header = f.readline().split()
        parents, descs, weights, leaf_flags = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf_flags.append(parts[1] in ("1", "True"))
            descs.append(np.asarray([int(x) for x in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))
    is_leaf = np.asarray(leaf_flags, bool)
    desc = np.stack(descs)
    w = np.asarray(weights, np.float32)
    n_words = int(is_leaf.sum())
    if as_tree or (as_tree is None and n_words > TREE_WORD_THRESHOLD):
        from pointslot_torch.vocab.tree import TreeVocabulary

        k = int(header[0]) if len(header) >= 2 else 10
        L = int(header[1]) if len(header) >= 2 else 6
        return TreeVocabulary.from_parent_array(
            np.asarray(parents, np.int32), desc.view(np.uint32), w, is_leaf,
            k=max(k, 2), depth=max(L, 1) + 1, device=device,
        )
    return BinaryVocabulary(desc[is_leaf].view(np.uint32), w[is_leaf], device=device)
