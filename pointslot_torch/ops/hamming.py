"""Hamming distance on 256-bit ORB descriptors held as (N, 8) int32 words.

Port of ``pointslot_tpu/ops/hamming.py`` (popcount path). The words carry
the same bits as the reference's uint32 words. torch has no popcount op, so
it is SWAR bit arithmetic on int32: the sign bit is counted on its own and
the low 31 bits are folded without any intermediate reaching 2**31, and
every right shift is masked because int32 ``>>`` is arithmetic. On the CPU
the tables go through numpy's ``bitwise_count`` where numpy has it (2.0
and later): the same integers, without the SWAR's dozen passes over the
(N, M, 8) words, on 64-bit words and in blocks of rows that stay in cache.
"""

from __future__ import annotations

import numpy as np
import torch


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word -> int32 in [0, 32]."""
    sign = (x < 0).to(torch.int32)
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F) + sign


CPU_ROW_BLOCK = 64


def _table_numpy(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    a = np.ascontiguousarray(desc_a.numpy()).view(np.uint64)      # (..., N, 4)
    b = np.ascontiguousarray(desc_b.numpy()).view(np.uint64)
    out = np.empty(np.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-2]),
                   np.int32)
    for i in range(0, a.shape[-2], CPU_ROW_BLOCK):
        c = np.bitwise_count(a[..., i:i + CPU_ROW_BLOCK, None, :] ^ b[..., None, :, :])
        # uint8 counts of at most 64: two pairs fit, their sum (256) may not
        out[..., i:i + CPU_ROW_BLOCK, :] = ((c[..., 0] + c[..., 1]).astype(np.int32)
                                            + (c[..., 2] + c[..., 3]))
    return torch.from_numpy(out)


def hamming_table_popcount(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) int32 words -> (..., N, M) int32 distances."""
    if desc_a.device.type == "cpu" and hasattr(np, "bitwise_count"):
        return _table_numpy(desc_a, desc_b)
    x = desc_a[..., :, None, :] ^ desc_b[..., None, :, :]
    return popcount32(x).sum(dim=-1, dtype=torch.int32)


def hamming_pairwise(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Row-wise distance of aligned pairs: (N, 8), (N, 8) -> (N,) int32."""
    return popcount32(desc_a ^ desc_b).sum(dim=-1, dtype=torch.int32)
