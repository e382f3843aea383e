"""Tests of the port that need a CUDA card: the hand-written kernel against
its plain version, and the fused step on the card against the port's CPU
path. Without a card each test skips with its reason; on the card run

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pointslot_torch import convert
from pointslot_torch.config import CameraConfig, SystemConfig
from pointslot_torch.ops import patch
from pointslot_torch.ops.fused_track import FusedFrameStep


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _levels(seed: int):
    """The port's pyramid of a random 1242x375 pair on the card: per-level
    (2, h, w) tensors, as the frontend holds them."""
    from pointslot_torch.ops.orb import ORBExtractor

    g = torch.Generator().manual_seed(seed)
    both = (torch.rand((2, 375, 1242), generator=g) * 255).cuda()
    return ORBExtractor(375, 1242, device="cuda").pyramid(both)


@pytest.mark.parametrize("site, K", [("left-orb", 1000), ("right-orb", 1000),
                                     ("right-sad", 1000), ("fine", 266)])
def test_patch_gather_kernel_equals_plain(site, K):
    """A pure copy: the kernel equals the plain gather exactly for the
    frontend's four patch sources at the path's shapes -- image 0's 8
    levels, image 1's 8 levels (ORB and SAD windows) and the two level-0
    images -- the planes read in place, edge centres included."""
    _need_card()
    levels = _levels(K + len(site))
    if site == "fine":
        planes = [levels[0][0], levels[0][1]]
    else:
        planes = [x[0 if site == "left-orb" else 1] for x in levels]
    L = len(planes)
    Hp, Wp = patch.canvas_shape(planes)
    g = torch.Generator().manual_seed(K)
    lvl = torch.randint(0, L, (K,), generator=g)
    hw = torch.tensor([tuple(p.shape) for p in planes])[lvl]
    xyl = torch.stack([(torch.rand(K, generator=g) * hw[:, 1]).long(),
                       (torch.rand(K, generator=g) * hw[:, 0]).long(), lvl], 1)
    edges = torch.tensor([[0, 0, 0], [Wp - 1, Hp - 1, L - 1], [Wp + 5, Hp + 9, L],
                          [-1, -1, 0], [-Wp - 3, -2, 1], [3, 4, -1], [17, -60, L + 1]])
    xyl = torch.cat([xyl, edges]).to(torch.int32).cuda()
    before, builds = patch.LAUNCHES, patch.CANVAS_BUILDS
    got = patch.gather_patches(planes, xyl)
    assert patch.LAUNCHES == before + 1
    assert patch.CANVAS_BUILDS == builds
    want = patch.gather_patches_plain(planes, xyl)
    torch.cuda.synchronize()
    assert got.shape == (K + 7, 48, 48)
    assert torch.equal(got, want)


def test_patch_gather_rejects_bad_input():
    _need_card()
    planes = [torch.zeros((64, 64), device="cuda"), torch.zeros((32, 32), device="cuda")]
    xyl = torch.zeros((4, 3), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        patch.gather_patches(planes[:1] + [planes[1].double()], xyl)
    with pytest.raises(TypeError):
        patch.gather_patches(planes, xyl.long())
    with pytest.raises(ValueError):
        patch.gather_patches(planes, xyl[:, :2].contiguous())
    with pytest.raises(ValueError):
        patch.gather_patches([planes[0], planes[1].cpu()], xyl)
    with pytest.raises(ValueError):
        patch.gather_patches([planes[0].t(), planes[1]], xyl)
    with pytest.raises(ValueError):
        patch.gather_patches(planes * 5, xyl)


def test_fused_frame_step_cuda_matches_cpu():
    """The whole step on the card against the port's CPU path at 512x256:
    four kernel launches per frame and no canvas built; translations within
    1e-3 m and keypoints equal but for float32-rounding ties (bounded at
    0.5 %)."""
    _need_card()
    cam = CameraConfig(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
    cfg = SystemConfig().replace(camera=cam)
    rng = np.random.default_rng(3)
    left = rng.integers(0, 255, (256, 512), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    eye = np.eye(4, dtype=np.float32)
    M, O, Mo = 256, 2, 64
    pos = rng.uniform([-5, -2, 2], [5, 2, 20], (M, 3)).astype(np.float32)
    dsc = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    opos = rng.uniform(-1, 1, (O, Mo, 3)).astype(np.float32)
    odesc = rng.integers(0, 2**32, (O, Mo, 8), dtype=np.uint32)
    oT = np.tile(eye, (O, 1, 1))
    oT[:, 2, 3] = 8.0
    args = (left, right, eye, eye, pos, dsc, np.zeros(M, np.int32), np.ones(M, bool),
            opos, odesc, np.ones((O, Mo), bool), oT)
    out = {}
    for dev in ("cuda", "cpu"):
        step = FusedFrameStep(cfg, device=dev)
        before, builds = patch.LAUNCHES, patch.CANVAS_BUILDS
        r, To, _, n = step(*args)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert patch.LAUNCHES == before + 4
            assert patch.CANVAS_BUILDS == builds
            assert r.T_cw.device.type == "cuda"
        out[dev] = (convert.to_numpy(r), To.cpu().numpy())
    (g, gTo), (c, cTo) = out["cuda"], out["cpu"]
    same = (g.xy == c.xy).all(axis=1) & (g.level == c.level) & (g.valid == c.valid)
    assert (~same).sum() <= 0.005 * len(same)
    np.testing.assert_allclose(g.T_cw[:3, 3], c.T_cw[:3, 3], atol=1e-3)
    np.testing.assert_allclose(gTo[:, :3, 3], cTo[:, :3, 3], atol=1e-3)


def test_step_has_no_host_sync():
    """The step on device tensors makes no synchronising call (no .item(),
    no device-to-host copy, no error check that waits for the card), so it
    can be captured in a CUDA graph: sync debug mode "error" raises on any."""
    _need_card()
    cam = CameraConfig(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
    full = FusedFrameStep(SystemConfig().replace(camera=cam), device="cuda")
    rng = np.random.default_rng(5)
    left = rng.integers(0, 255, (256, 512), dtype=np.uint8)
    d = full.device
    args = [convert.to_tensor(x, None, d) for x in (left, np.roll(left, -4, axis=1))]
    eye = torch.eye(4, device=d)
    M, O, Mo = 256, 2, 64
    tables = convert.map_tables(rng.uniform([-5, -2, 2], [5, 2, 20], (M, 3)),
                                rng.integers(0, 2**32, (M, 8), dtype=np.uint32),
                                np.zeros(M), np.ones(M, bool), d)
    objects = convert.object_tables(rng.uniform(-1, 1, (O, Mo, 3)),
                                    rng.integers(0, 2**32, (O, Mo, 8), dtype=np.uint32),
                                    np.ones((O, Mo), bool), d)
    To = eye.expand(O, 4, 4).clone()
    To[:, 2, 3] = 8.0
    vo = eye.expand(O, 4, 4).clone()
    full.step.run(*args, eye, eye, *tables)          # first call: library loads, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = full.step.run(*args, eye, eye, *tables)
        full.phase.run(r.xy, r.level, r.desc, r.valid, r.depth, r.u_right, *objects, To, vo)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_gated_step_has_no_host_sync():
    """The mode-4 camera step, under a background gate, makes no
    synchronising call either: the gate's resize index maps live on the
    card and the per-keypoint check gathers there."""
    _need_card()
    cam = CameraConfig(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
    full = FusedFrameStep(SystemConfig().replace(camera=cam), device="cuda")
    rng = np.random.default_rng(6)
    left = rng.integers(0, 255, (256, 512), dtype=np.uint8)
    d = full.device
    args = [convert.to_tensor(x, None, d) for x in (left, np.roll(left, -4, axis=1))]
    eye = torch.eye(4, device=d)
    M = 256
    tables = convert.map_tables(rng.uniform([-5, -2, 2], [5, 2, 20], (M, 3)),
                                rng.integers(0, 2**32, (M, 8), dtype=np.uint32),
                                np.zeros(M), np.ones(M, bool), d)
    gate = torch.ones((256, 512), dtype=torch.bool, device=d)
    gate[60:200, 100:300] = False
    full.step.run(*args, eye, eye, *tables, gate)    # first call: library loads, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = full.step.run(*args, eye, eye, *tables, gate)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    xy = r.xy[r.valid].round().long()
    assert not (~gate[xy[:, 1], xy[:, 0]]).any()


def _object_ba_problem(seed: int, n_poses: int):
    """An object-scale BA window on the card (points within metres of the
    object, poses moving past it, stereo and mono edges, 0.2 px noise), the
    object dof mask, and constant-motion priors between the poses."""
    from pointslot_torch.geometry import se3
    from pointslot_torch.solvers import local_ba

    def exp(xi):
        return se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy().astype(np.float64)

    fx, cx, cy, bf = 721.5, 609.6, 172.9, 384.4
    rng = np.random.default_rng(seed)
    poses, T = [], exp([0.5, 0.3, 9.0, 0.0, 0.2, 0.0])
    for _ in range(n_poses):
        poses.append(T)
        T = exp([0.3, 0.01 * rng.normal(), -0.4, 0.0, 0.03 * rng.normal(), 0.0]) @ T
    pts = rng.uniform([-1.5, -1, -2], [1.5, 1, 2], (400, 3))
    e_pose, e_point, e_obs = [], [], []
    for p, Tco in enumerate(poses):
        pc = pts @ Tco[:3, :3].T + Tco[:3, 3]
        u, v = fx * pc[:, 0] / pc[:, 2] + cx, fx * pc[:, 1] / pc[:, 2] + cy
        obs = np.stack([u, v, u - bf / pc[:, 2]], 1)
        obs[:, :2] += rng.normal(size=(len(pts), 2)) * 0.2
        e_pose += [p] * len(pts)
        e_point += list(range(len(pts)))
        e_obs.append(obs)
    init = [poses[0]] + [exp(rng.normal(size=6) * 0.01) @ T for T in poses[1:]]
    dof = np.zeros((16, 6), np.float32)
    dof[:, :3] = dof[:, 4] = 1.0
    E = len(e_pose)
    prob, _ = local_ba.build_problem(
        np.stack(init), [True] + [False] * (n_poses - 1), pts + rng.normal(size=pts.shape) * 0.02,
        np.asarray(e_pose), np.asarray(e_point), np.concatenate(e_obs), rng.random(E) > 0.3,
        rng.choice([1.0, 1 / 1.44], E), P_cap=16, L_cap=512, K=16, dof_mask=dof, device="cuda")
    idx = np.stack([np.arange(n_poses - 1), np.arange(1, n_poses)], 1)
    T_rel = np.stack([poses[i + 1] @ np.linalg.inv(poses[i]) for i in range(n_poses - 1)])
    priors = local_ba.build_motion_priors(idx, T_rel, np.full(n_poses - 1, 50.0), R_cap=16,
                                          device="cuda")
    return prob, priors, dict(fx=fx, fy=fx, cx=cx, cy=cy, bf=bf)


def test_bundle_adjust_repeats_on_card():
    """Two solves of the same problems on the card give the same bits under
    torch's default algorithms (the pose-block, coupling and prior sums are
    one-hot GEMMs in a fixed order): one problem alone, and a batch of two
    with priors, as the object mapping stacks them."""
    _need_card()
    from pointslot_torch.solvers import local_ba

    (p1, pr1, cam), (p2, pr2, _) = _object_ba_problem(1, 8), _object_ba_problem(2, 5)
    probs, priors = local_ba.stack_problems([p1, p2]), local_ba.stack_problems([pr1, pr2])
    for solve in (lambda: local_ba.bundle_adjust(p1, **cam),
                  lambda: local_ba.bundle_adjust_batched(probs, **cam, priors=priors)):
        a, b = solve(), solve()
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert torch.isfinite(a.poses).all() and (a.cost < 1e4).all()


def _gba_problem(seed: int, n_poses: int = 24, n_points: int = 2000):
    """A global-BA-scale problem on the card: poses around a circle, points
    on a ring outside it, each seen by up to 8 of them (stereo and mono
    edges, 0.3 px noise), the first pose fixed, the pose capacity 32."""
    from pointslot_torch.geometry import se3
    from pointslot_torch.solvers import local_ba

    fx, cx, cy, bf = 721.5, 609.6, 172.9, 384.4
    rng = np.random.default_rng(seed)
    poses = []
    for k in range(n_poses):
        a = 2 * np.pi * k / n_poses
        T = np.eye(4)
        T[:3, :3] = se3.so3_exp(torch.tensor([0.0, -a, 0.0])).numpy()
        T[:3, 3] = -T[:3, :3] @ np.array([5 * np.sin(a), 0.0, 5 * np.cos(a) - 5])
        poses.append(T)
    ang = rng.uniform(0, 2 * np.pi, n_points)
    r = rng.uniform(9, 14, n_points)
    pts = np.stack([r * np.sin(ang), rng.uniform(-2, 2, n_points), r * np.cos(ang) - 5], 1)
    e_pose, e_point, e_obs = [], [], []
    for p, T in enumerate(poses):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        u, v = fx * pc[:, 0] / pc[:, 2] + cx, fx * pc[:, 1] / pc[:, 2] + cy
        seen = np.nonzero((pc[:, 2] > 1) & (u >= 0) & (u < 1242) & (v >= 0) & (v < 375))[0]
        obs = np.stack([u, v, u - bf / pc[:, 2]], 1)[seen]
        obs[:, :2] += rng.normal(size=(len(seen), 2)) * 0.3
        e_pose += [p] * len(seen)
        e_point += list(seen)
        e_obs.append(obs)
    E = len(e_pose)
    init = [poses[0]] + [se3.se3_exp(torch.tensor(rng.normal(size=6) * 0.01, dtype=torch.float32))
                         .numpy().astype(np.float64) @ T for T in poses[1:]]
    prob, _ = local_ba.build_problem(
        np.stack(init), [True] + [False] * (n_poses - 1), pts + rng.normal(size=pts.shape) * 0.05,
        np.asarray(e_pose), np.asarray(e_point), np.concatenate(e_obs), rng.random(E) > 0.3,
        rng.choice([1.0, 1 / 1.44], E), P_cap=32, L_cap=n_points, K=8, device="cuda")
    return prob


def test_global_ba_repeats_on_card():
    """Two global-BA solves of the same problem on the card, as the loop
    closer runs them (pre-gate, two-stage LM, cost statistics), give the
    same bits; and so do two pose-graph solves of its essential graph."""
    _need_card()
    from pointslot_torch.slam.loop_closing import LoopCloser
    from pointslot_torch.slam.map_state import MapState
    from pointslot_torch.solvers import posegraph
    from pointslot_torch.vocab.bow import train_default_vocab

    closer = LoopCloser(SystemConfig(), MapState(), train_default_vocab(device="cuda"),
                        device="cuda")
    snap = dict(prob=_gba_problem(3), n_kfs=24, pts=np.arange(2000))
    (a, sa), (b, sb) = closer._gba_solve(snap), closer._gba_solve(snap)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert sa == sb and sa["cost_after"] < sa["cost_before"]
    poses = snap["prob"].poses[:24]
    K = len(poses)
    e_i = torch.arange(1, K, device="cuda")
    e_j = torch.arange(0, K - 1, device="cuda")
    meas = poses[e_i] @ torch.linalg.inv(poses[e_j])
    prob = posegraph.PoseGraphProblem(
        poses=poses, fixed=torch.arange(K, device="cuda") == 0,
        valid=torch.ones(K, dtype=torch.bool, device="cuda"), e_i=e_i, e_j=e_j, e_meas=meas,
        e_weight=torch.ones(K - 1, device="cuda"),
        e_valid=torch.ones(K - 1, dtype=torch.bool, device="cuda"))
    assert torch.equal(posegraph.optimize_pose_graph(prob), posegraph.optimize_pose_graph(prob))
