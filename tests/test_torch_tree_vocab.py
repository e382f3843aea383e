"""The tree vocabulary, its sparse database and the DBoW2 vocabulary files,
the port against the JAX package on the CPU: pointslot_torch's
``vocab/tree.py`` and ``vocab/bow.py`` loaders against pointslot_tpu's.

Tolerances and why:
- the synthesized (k = 10, depth = 4) and trained (k = 8, depth = 3) trees'
  arrays, and the word ids of the staged descent: equal. The host code and
  its random calls are the reference's; the descent is integer logic;
- database scores within 1e-6 (host float sums over equal word weights;
  they come out equal), queries equal;
- vocabulary files: a binary file (plain and .gz) written by either
  package, and a text file, load in both to the same words. A tree loaded
  from a file has depth L + 1 in both, one stage more than it was built
  with: its leaves stay put in that stage (``test_file_round_trip_adds_a_
  descent_stage``);
- ``strict``: every malformed file below is refused by both, with the same
  message.

About 15 s alone, on one torch thread.
"""

import gzip
import hashlib

import numpy as np
import pytest
import torch

from pointslot_tpu.vocab import bow as jbow
from pointslot_tpu.vocab import tree as jtree
from pointslot_torch.vocab import bow, tree

TREE_ARRAYS = ("node_desc", "children", "node_weights", "is_leaf", "leaf_word", "word_weights")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _assert_same_tree(got, want):
    for name in TREE_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.k, got.depth, got.n_words) == (want.k, want.depth, want.n_words)


def _assert_same_words(got, want, desc, valid):
    np.testing.assert_array_equal(got.word_ids(desc, valid), np.asarray(want.word_ids(desc, valid)))


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(5)
    desc = _desc(rng, 1500)
    return (desc, jtree.TreeVocabulary.train(desc, k=8, depth=3, seed=0),
            tree.TreeVocabulary.train(desc, k=8, depth=3, seed=0, device="cpu"))


def test_synthesized_tree_matches_reference():
    want = jtree.TreeVocabulary.synthesize(k=10, depth=4, seed=0)
    got = tree.TreeVocabulary.synthesize(k=10, depth=4, seed=0, device="cpu")
    _assert_same_tree(got, want)
    assert got.n_words == 10 ** 4
    rng = np.random.default_rng(1)
    desc, valid = _desc(rng, 1000), rng.random(1000) < 0.9
    _assert_same_words(got, want, desc, valid)
    assert (got.word_ids(desc, valid) == -1).sum() == (~valid).sum()


def test_trained_tree_matches_reference(trained):
    desc, want, got = trained
    _assert_same_tree(got, want)
    assert got.n_words > 100
    rng = np.random.default_rng(2)
    valid = rng.random(len(desc)) < 0.9
    _assert_same_words(got, want, desc, valid)
    # near-duplicates of training descriptors
    noisy = desc[:300] ^ (rng.random((300, 8)) < 0.03).astype(np.uint32)
    _assert_same_words(got, want, noisy, np.ones(300, bool))


def test_sparse_database_matches_reference(trained):
    desc, jvocab, vocab = trained
    want = jtree.SparseKeyFrameDatabase(jvocab, max_kfs=16)
    got = tree.SparseKeyFrameDatabase(vocab, max_kfs=16)
    valid = np.ones(len(desc), bool)
    for kf in range(8):
        sl = slice(kf * 150, kf * 150 + 300)
        gw, gv = got.add(kf, desc[sl], valid[sl])
        ww, wv = want.add(kf, desc[sl], valid[sl])
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
    for db in (got, want):
        db.remove(3)
    for q in (desc[100:400], desc[700:900], desc[1300:]):
        qg = got.transform(q, np.ones(len(q), bool))
        qw = want.transform(q, np.ones(len(q), bool))
        for kf in range(9):
            assert abs(got.pair_score(kf, qg) - want.pair_score(kf, qw)) <= 1e-6
        for exclude in (set(), {0, 5}):
            assert got.query(qg, exclude, 0.01) == want.query(qw, exclude, 0.01)
    got.clear()
    assert got.query(qg, set(), 0.0) == [] and not got._inv


def write_text_vocabulary(path, vocab):
    """The DBoW2 text export of a tree: 'k L s w' then one node per line
    (parent is_leaf 32 descriptor bytes weight), nodes 1.. in order."""
    T = len(vocab.node_desc)
    parents = np.zeros(T, np.int64)
    for p, row in enumerate(vocab.children):
        parents[row[row >= 0]] = p
    lines = [f"{vocab.k} {vocab.depth} 0 0"]
    for i in range(1, T):
        b = " ".join(str(int(x)) for x in vocab.node_desc[i].view(np.uint8))
        lines.append(f"{parents[i]} {int(vocab.is_leaf[i])} {b} {float(vocab.node_weights[i])!r}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("fmt, writer", [("bin", "jax"), ("bin", "port"), ("bin.gz", "jax"),
                                         ("bin.gz", "port"), ("txt", "text export")])
def test_vocabulary_files_load_across_packages(tmp_path, trained, fmt, writer):
    desc, jvocab, vocab = trained
    path = str(tmp_path / f"voc.{fmt}")
    plain = path[:-3] if fmt.endswith(".gz") else path
    if writer == "jax":
        jvocab.save_binary(plain)
    elif writer == "port":
        vocab.save_binary(plain)
    else:
        write_text_vocabulary(path, vocab)
    if fmt.endswith(".gz"):
        with open(plain, "rb") as f, gzip.open(path, "wb") as g:
            g.write(f.read())
    valid = np.ones(len(desc), bool)
    for as_tree in (True, None):
        got = bow.load_vocab(path, as_tree=as_tree, device="cpu")
        want = jbow.load_vocab(path, as_tree=as_tree)
        if as_tree:
            assert isinstance(got, tree.TreeVocabulary)
            _assert_same_tree(got, want)
            _assert_same_words(got, want, desc, valid)
            _assert_same_words(got, vocab, desc, valid)
        else:
            # at most TREE_WORD_THRESHOLD words: the flat vocabulary of the
            # leaves, word for word the tree's leaf order
            assert isinstance(got, bow.BinaryVocabulary) and got.n_words == vocab.n_words
            np.testing.assert_array_equal(got.words, want.words)
            np.testing.assert_array_equal(got.idf, want.idf)
            np.testing.assert_array_equal(got.transform(desc, valid)[1],
                                          np.asarray(want.transform(desc, valid)[1]))


def test_file_round_trip_adds_a_descent_stage(tmp_path):
    """A file records L; the loaders build depth L + 1 (vocab/bow.py:236-239 of
    the reference), so the loaded tree descends once more than the tree it
    was saved from. Every feature already sits on a leaf after L stages, so
    the extra stage moves nothing: the words equal the saved tree's."""
    rng = np.random.default_rng(3)
    vocab = tree.TreeVocabulary.synthesize(k=6, depth=3, seed=2, device="cpu")
    path = str(tmp_path / "voc.bin")
    vocab.save_binary(path)
    got = bow.load_vocab(path, as_tree=True, device="cpu")
    want = jbow.load_vocab(path, as_tree=True)
    assert got.depth == want.depth == vocab.depth + 1
    desc = _desc(rng, 500)
    _assert_same_words(got, want, desc, np.ones(500, bool))
    _assert_same_words(got, vocab, desc, np.ones(500, bool))


def _records(rng, n=12, k=4, L=2):
    """A valid small tree's records: 3 internal nodes under the root, 9
    leaves under them."""
    parents = np.array([0, 0, 0] + [1, 1, 1, 2, 2, 2, 3, 3, 3], np.int32)
    is_leaf = np.array([False] * 3 + [True] * 9)
    return dict(parents=parents, desc=_desc(rng, n).view(np.uint8),
                weights=rng.uniform(0.1, 1.0, n).astype(np.float32), is_leaf=is_leaf, k=k, L=L)


def _malformed(name, rec):
    r = {**rec, "parents": rec["parents"].copy(), "weights": rec["weights"].copy()}
    if name == "parent after child":
        r["parents"][3] = 9
    elif name == "negative parent":
        r["parents"][4] = -2
    elif name == "leaf parent":
        r["parents"][10] = 5
    elif name == "too many children":
        r["k"] = 2
    elif name == "negative weight":
        r["weights"][2] = -1.0
    elif name == "non-finite weight":
        r["weights"][6] = np.nan
    elif name == "more leaves than k^L":
        r["L"] = 1
    elif name == "implausible k":
        r["k"] = 1000
    return r


@pytest.mark.parametrize("name", ["parent after child", "negative parent", "leaf parent",
                                  "too many children", "negative weight", "non-finite weight",
                                  "more leaves than k^L", "implausible k"])
def test_strict_rejects_malformed_files(tmp_path, name):
    rng = np.random.default_rng(11)
    good = _records(rng)
    ok_path = str(tmp_path / "ok.bin")
    bow.save_orb_vocab_binary(ok_path, **{k: good[k] for k in good})
    bow.load_orb_vocab_binary(ok_path, strict=True, device="cpu")
    jbow.load_orb_vocab_binary(ok_path, strict=True)
    bad = _malformed(name, good)
    path = str(tmp_path / "bad.bin")
    bow.save_orb_vocab_binary(path, **bad)
    with pytest.raises(ValueError) as got:
        bow.load_orb_vocab_binary(path, strict=True, device="cpu")
    with pytest.raises(ValueError) as want:
        jbow.load_orb_vocab_binary(path, strict=True)
    assert str(got.value) == str(want.value)
    assert "strict vocabulary parse failed" in str(got.value)


def test_loader_rejects_bad_files(tmp_path):
    """Truncated header and body, a record size below 41 bytes, no leaf
    word and a sha256 that does not match: refused by both loaders alike,
    strict or not."""
    rng = np.random.default_rng(12)
    rec = _records(rng)
    path = str(tmp_path / "voc.bin")
    bow.save_orb_vocab_binary(path, **rec)
    raw = open(path, "rb").read()
    cases = {
        "header": raw[:20],
        "body": raw[:-7],
        "record size": raw[:4] + np.uint32(40).tobytes() + raw[8:],
    }
    no_leaf = {**rec, "is_leaf": np.zeros(12, bool)}
    bow.save_orb_vocab_binary(str(tmp_path / "no_leaf.bin"), **no_leaf)
    cases["no leaf"] = open(tmp_path / "no_leaf.bin", "rb").read()
    for name, data in cases.items():
        p = str(tmp_path / f"{name}.bin")
        with open(p, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError) as got:
            bow.load_orb_vocab_binary(p, device="cpu")
        with pytest.raises(ValueError) as want:
            jbow.load_orb_vocab_binary(p)
        assert str(got.value) == str(want.value), name
    sha = hashlib.sha256(raw).hexdigest()
    bow.load_orb_vocab_binary(path, expect_sha256=sha.upper(), device="cpu")
    with pytest.raises(ValueError, match="sha256"):
        bow.load_orb_vocab_binary(path, expect_sha256="0" * 64, device="cpu")
    with pytest.raises(ValueError, match="sha256"):
        jbow.load_orb_vocab_binary(path, expect_sha256="0" * 64)
