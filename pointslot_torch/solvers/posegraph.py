"""Pose-graph optimization over SE(3) relative-pose constraints.

Port of ``pointslot_tpu/solvers/posegraph.py`` (the reference's
Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:1419; scale fixed for
stereo, so SE(3)): ``PoseGraphProblem`` and ``optimize_pose_graph``, a
damped Gauss-Newton on the per-edge residuals r = log(inv(M_ij T_j) T_i).

The edge Jacobians come from one ``torch.func.jacfwd`` of the residuals of
all edges at once (the reference's ``jax.jacfwd`` under ``vmap``; under
``torch.func.vmap`` the Jacobian came out NaN for edges near the
identity, where the unbatched one is finite). The normal equations are
summed into the dense (6K, 6K) system as one GEMM: each edge's two 6x6
blocks are laid into a (6, 6K) row block, and H = J^T W J, b = J^T W r
over all edges.
A GEMM sums in a fixed order, so a solve repeats bit for bit on the card
(a scatter-add's atomics would not). The solve is ``solve_ex`` and the
iteration count is fixed: no host sync.

Left for later (ROADMAP item 15): the matrix-free distributed form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pointslot_torch.geometry import se3


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor       # (K, 4, 4) initial T (any consistent convention)
    fixed: torch.Tensor       # (K,) bool
    valid: torch.Tensor       # (K,) bool
    e_i: torch.Tensor         # (E,) int edge endpoints
    e_j: torch.Tensor         # (E,)
    e_meas: torch.Tensor      # (E, 4, 4) measured T_i @ inv(T_j)
    e_weight: torch.Tensor    # (E,) float32 information scale
    e_valid: torch.Tensor     # (E,) bool


def _edge_residual(Ti, Tj, Mij):
    """r = log( inv(Mij @ Tj) @ Ti ) — zero when Ti = Mij @ Tj."""
    return se3.se3_log(torch.linalg.solve(Mij @ Tj, Ti))


def _edge_jacobians(Ti, Tj, Mij):
    """(E, 6, 12) Jacobians of every edge's residual wrt the tangent updates
    (xi_i, xi_j) at zero, from one ``jacfwd`` of the batched residual with
    the same 12 updates applied to every edge: each edge's residual reads
    only its own two poses, so its rows are that edge's Jacobian."""
    E = Ti.shape[0]

    def r_of(xi):
        return _edge_residual(se3.se3_retract(Ti, xi[:6].expand(E, 6)),
                              se3.se3_retract(Tj, xi[6:].expand(E, 6)), Mij)

    return torch.func.jacfwd(r_of)(torch.zeros(12, dtype=Ti.dtype, device=Ti.device))


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20,
                        damping: float = 1e-6) -> torch.Tensor:
    """Exactly `n_iters` damped Gauss-Newton steps; fixed and invalid
    poses stay where they are. Returns the poses (K, 4, 4)."""
    K = prob.poses.shape[0]
    E = prob.e_i.shape[0]
    dev, dt = prob.poses.device, prob.poses.dtype
    e_i, e_j = prob.e_i.long(), prob.e_j.long()
    ar = torch.arange(K, device=dev)
    oh_i = (e_i[:, None] == ar).to(dt)                                # (E, K)
    oh_j = (e_j[:, None] == ar).to(dt)
    w = torch.where(prob.e_valid, prob.e_weight, torch.zeros_like(prob.e_weight))
    free = (prob.valid & ~prob.fixed)[:, None].expand(K, 6).reshape(-1)
    pinned = (prob.fixed | ~prob.valid)[:, None, None]

    poses = prob.poses
    for _ in range(n_iters):
        Ti, Tj = poses[e_i], poses[e_j]
        r = _edge_residual(Ti, Tj, prob.e_meas)                        # (E, 6)
        J = _edge_jacobians(Ti, Tj, prob.e_meas)                       # (E, 6, 12)
        # each edge's row block over all K poses: (E, 6, K, 6) -> (6E, 6K)
        rows = (J[:, :, None, :6] * oh_i[:, None, :, None]
                + J[:, :, None, 6:] * oh_j[:, None, :, None]).reshape(6 * E, 6 * K)
        w_rows = w[:, None].expand(E, 6).reshape(-1, 1)
        H = rows.T @ (rows * w_rows)
        b = rows.T @ (r.reshape(-1, 1) * w_rows)

        H = torch.where(free[:, None] & free[None, :], H, torch.zeros_like(H))
        diag = torch.diagonal(H)
        H = H + torch.diag(torch.where(free, damping * torch.clamp(diag, min=1.0),
                                       torch.ones_like(diag)))
        b = torch.where(free[:, None], b, torch.zeros_like(b))
        dx = -torch.linalg.solve_ex(H, b)[0].reshape(K, 6)
        poses = torch.where(pinned, poses, se3.se3_retract(poses, dx))
    return poses
