"""Batched two-view linear triangulation.

Port of ``pointslot_tpu/geometry/triangulation.py::triangulate``: DLT on
the 4x4 system A^T A, solved for all candidate pairs at once through
``torch.linalg.eigh``. The smallest eigenvector's sign is arbitrary and
differs between LAPACK builds; the division by its fourth component
cancels it.
"""

from __future__ import annotations

import torch


def triangulate(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor):
    """DLT triangulation.

    P1, P2: (..., 3, 4) projection matrices (K [R|t]).
    uv1, uv2: (..., 2) pixel observations.
    Returns (..., 3) world points and (...,) condition flag (True = well-posed).
    """
    rows = []
    for P, uv in ((P1, uv1), (P2, uv2)):
        rows.append(uv[..., 0:1] * P[..., 2, :] - P[..., 0, :])
        rows.append(uv[..., 1:2] * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(rows, dim=-2)                       # (..., 4, 4)
    AtA = A.transpose(-1, -2) @ A
    _, v = torch.linalg.eigh(AtA)                       # ascending eigenvalues
    X = v[..., :, 0]                                    # smallest eigenvector
    w_ok = torch.abs(X[..., 3]) > 1e-8
    w = torch.where(w_ok, X[..., 3], torch.ones_like(X[..., 3]))
    return X[..., :3] / w[..., None], w_ok
