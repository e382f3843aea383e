"""FAST's doubling over ring slices against the score's definition, and
the CPU Hamming tables against the form the card runs, bit for bit.

``ops/fast.py`` builds the 16 arcs' min/max by doubling over slices of a
24-plane ring; here it is held to the definition (for each of the 16
arcs of 9 ring pixels, the min of d and of -d, the max over arcs), and
both are min/max/subtract on the same values, so they must agree exactly.
On the CPU, ``ops/hamming.py`` counts bits with numpy's ``bitwise_count``
on 64-bit words in blocks of rows; the card runs the int32 SWAR popcount.
Cases: heights that are and are not multiples of anything, ties (integer
grey levels), leading batch dimensions, descriptors at distance 0 and 256
(complementary words: four 64-bit counts of 64 sum past a uint8) and empty
tables. tests/test_torch_orb.py holds FAST to the JAX package's.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pointslot_torch.ops import fast, hamming


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fast_by_definition(img: torch.Tensor, threshold: float) -> torch.Tensor:
    h, w = img.shape[-2:]
    padded = F.pad(img, (3, 3, 3, 3))
    d = [padded[..., 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] - img for dy, dx in fast.CIRCLE]
    best = None
    for start in range(16):
        arc = [d[(start + k) % 16] for k in range(9)]
        lo, hi = arc[0], arc[0]
        for x in arc[1:]:
            lo, hi = torch.minimum(lo, x), torch.maximum(hi, x)
        cand = torch.maximum(lo, -hi)
        best = cand if best is None else torch.maximum(best, cand)
    border = torch.zeros((h, w), dtype=torch.bool)
    border[3:h - 3, 3:w - 3] = True
    return torch.where(best > threshold, best, torch.zeros_like(best)) * border


@pytest.mark.parametrize("shape", [(256, 512), (37, 61), (2, 40, 33), (5, 9)])
@pytest.mark.parametrize("integer", [False, True])
def test_fast_doubling_equals_definition(shape, integer):
    g = torch.Generator().manual_seed(sum(shape))
    img = torch.rand(shape, generator=g) * 255
    if integer:
        img = img.round()
    for threshold in (0.0, 12.0):
        got = fast.fast_score_map(img, threshold)
        assert torch.equal(got, _fast_by_definition(img, threshold))
    assert shape[-2] <= 6 or (got > 0).any()


@pytest.mark.parametrize("sa,sb", [((130, 8), (70, 8)), ((3, 65, 8), (3, 5, 8)),
                                   ((0, 8), (4, 8)), ((4, 8), (0, 8))])
def test_hamming_numpy_blocks_equal_swar(sa, sb):
    rng = np.random.default_rng(len(sa) + sa[-2])
    a = torch.from_numpy(rng.integers(-2**31, 2**31, sa, dtype=np.int64).astype(np.int32))
    b = torch.from_numpy(rng.integers(-2**31, 2**31, sb, dtype=np.int64).astype(np.int32))
    if sa[-2] and sb[-2]:
        b[..., 0, :] = ~a[..., 0, :]            # distance 256
        b[..., 1 % sb[-2], :] = a[..., 1 % sa[-2], :]   # distance 0
    want = hamming.popcount32(a[..., :, None, :] ^ b[..., None, :, :]).sum(dim=-1,
                                                                          dtype=torch.int32)
    got = hamming.hamming_table_popcount(a, b)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if sa[-2] and sb[-2]:
        assert int(got[..., 0, 0].min()) == 256
    # a view with other strides gives the same table
    assert torch.equal(hamming.hamming_table_popcount(a.flip(-2), b), want.flip(-2))
