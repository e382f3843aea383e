"""GMS (Grid-based Motion Statistics) match filtering, batched.

Port of ``pointslot_tpu/ops/gms.py`` (the reference's gms_matcher,
include/gms_matcher.h:15-50: 20x20 grids, vote-based cell acceptance):
matches scatter votes into a (G*G, G*G) cell-pair count matrix; a 3x3
neighbourhood sum over the source cells and another over the target cells
give each pair's support; a match is kept when its support, less its own
vote, exceeds alpha * sqrt(mean matches per cell of its source
neighbourhood).

The JAX scatter with ``mode="drop"`` becomes an ``index_put_`` with
``accumulate=True`` into a buffer with one spare row and column, where the
invalid matches land and which is then sliced off. The neighbourhood sums
are ``torch.roll`` as the reference's are ``jnp.roll``: they wrap around the
grid's edges, so a cell at x = 0 is supported by cells at x = G - 1. The
port keeps that on purpose. Every vote is an integer in float32, so the
sums are exact in any order and the keep mask equals the reference's bit
for bit. The inputs may carry a leading batch axis: one independent filter
per lane (the object axis).
"""

from __future__ import annotations

import torch

GRID = 20
# The GMS paper's alpha=6 assumes ~10k-feature densities; SLOT match sets are
# hundreds, so the default here is calibrated lower.
ALPHA = 3.0


def _wrap_neighbourhood(x: torch.Tensor, dims) -> torch.Tensor:
    """Sum of the 3x3 neighbourhood over `dims`, wrapping at the edges."""
    out = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + torch.roll(x, (dy, dx), dims=dims)
    return out


def gms_filter(
    xy_a: torch.Tensor,      # (N, 2) or (B, N, 2) match endpoints in image A
    xy_b: torch.Tensor,      # (N, 2) or (B, N, 2) corresponding points in image B
    valid: torch.Tensor,     # (N,) or (B, N) bool
    width: int, height: int,
    grid: int = GRID,
    alpha: float = ALPHA,
) -> torch.Tensor:
    """Returns the (N,) or (B, N) bool inlier mask."""
    single = xy_a.dim() == 2
    if single:
        xy_a, xy_b, valid = xy_a[None], xy_b[None], valid[None]
    B, N = valid.shape
    G2 = grid * grid
    dev = xy_a.device

    def cell_of(xy):
        cx = torch.clamp((xy[..., 0] * grid / width).to(torch.int32), 0, grid - 1)
        cy = torch.clamp((xy[..., 1] * grid / height).to(torch.int32), 0, grid - 1)
        return (cy * grid + cx).long()

    ca = cell_of(xy_a)
    cb = cell_of(xy_b)
    spare = torch.full_like(ca, G2)
    lane = torch.arange(B, device=dev)[:, None].expand(B, N)

    # cell-pair vote matrix; invalid matches vote into the spare row/column
    votes = torch.zeros((B, G2 + 1, G2 + 1), dtype=torch.float32, device=dev)
    votes.index_put_((lane, torch.where(valid, ca, spare), torch.where(valid, cb, spare)),
                     torch.ones((B, N), dtype=torch.float32, device=dev), accumulate=True)
    votes = votes[:, :G2, :G2]

    # support of pair (i, j): matches whose a-end falls in i's 3x3
    # neighbourhood and whose b-end falls in j's
    vgrid = votes.reshape(B, grid, grid, grid, grid)        # (B, ay, ax, by, bx)
    support = _wrap_neighbourhood(_wrap_neighbourhood(vgrid, (1, 2)), (3, 4))
    support = support.reshape(B, G2, G2)

    # tau = alpha * sqrt(mean matches per cell in the source neighbourhood)
    per_cell = votes.sum(dim=2).reshape(B, grid, grid)
    mean_n = _wrap_neighbourhood(per_cell, (1, 2)).reshape(B, G2) / 9.0
    tau = alpha * torch.sqrt(torch.clamp(mean_n, min=1e-6))

    # subtract the match's own vote so singleton pairs never self-support
    score = support[lane, ca, cb] - 1.0
    keep = (score > tau.gather(1, ca)) & valid
    return keep[0] if single else keep
