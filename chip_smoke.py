#!/usr/bin/env python3
"""Drive pointslot_torch's mode-4 per-frame hot path on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100 (or another
sm_90a card). Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc builds every kernel of the path from pointslot_torch/csrc;
3. kernels against their plain versions (exact) at the four patch-gather
   call sites of frame 1's step and on edge centres, with device times from
   CUDA graphs of repeated launches, warm and L2-cold, beside the bound;
4. main path: a KITTI-size (1242x375) synthetic mode-4 sequence through
   FusedFrameStep on the card -- a 2048-point local map and two 256-point
   object tables of the true structure, refreshed at keyframes -- checked
   against ground truth, with the kernels' launch counts and the canvas
   builds (none) read around it; then the camera and object halves timed
   apart, a profile, and frame 1 repeated on the port's CPU path (gated);
5. one JSON line with every kernel's numbers;
6. last line: {"ok": true, "device": {...}}.

Needs no network; builds into build/kernels/.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pointslot_torch import convert, kernels
from pointslot_torch.config import CameraConfig, SystemConfig
from pointslot_torch.datasets import synthetic
from pointslot_torch.ops import patch
from pointslot_torch.ops.fused_track import FusedFrameStep

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
MAP_POINTS, OBJECTS, OBJ_POINTS = 2048, 2, 256
WARMUP_FRAMES, TIMED_FRAMES = 3, 20
KEYFRAME_EVERY = 8               # map/object table refresh, host side
MAX_TRANS_ERR_M = 0.25           # tests/test_fused_track.py:65
MIN_INLIERS = 30
MAX_KEYPOINTS_DIFFERING = 0.005  # card vs CPU path, tests/test_torch_cuda.py
MAX_POSE_GAP_M = 1e-3            # card vs CPU path, tests/test_torch_cuda.py
SITES = ("left ORB", "right ORB", "right SAD", "fine")   # patch gathers, call order
FLUSH_BYTES = 128 << 20          # L2 flush write, over twice the 50 MB L2
CANVAS_OPS = ("aten::constant_pad_nd", "aten::stack", "aten::contiguous")


def _capture(fn, reps: int) -> torch.cuda.CUDAGraph:
    """A CUDA graph of `reps` calls of `fn`, warmed up and replayed once."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph: torch.cuda.CUDAGraph) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _graph_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Warm device ms per call of `fn`: the median of `rounds` replays of a
    CUDA graph of `reps` calls, timed between CUDA events (no host launch
    cost; the inputs stay in L2 from one call to the next)."""
    graph = _capture(fn, reps)
    return float(np.median([_replay_ms(graph) for _ in range(rounds)])) / reps


def _cold_ms(fn, flush, reps: int = 20, rounds: int = 9) -> float:
    """L2-cold device ms per call of `fn`: a graph of `reps` x (flush, fn)
    less a graph of `reps` x flush, replayed in turns; the median of the
    per-round differences. `flush` writes a buffer larger than the L2."""
    both = _capture(lambda: (flush(), fn()), reps)
    alone = _capture(flush, reps)
    return float(np.median([(_replay_ms(both) - _replay_ms(alone)) / reps
                            for _ in range(rounds)]))


def _count_kernels(fn) -> int:
    """Device kernels launched by one call of `fn`, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def _patch_bound_ms(planes, xyl: torch.Tensor, in_plane: bool = True) -> float:
    """Least time for the gather over the card's memory rate: the distinct
    pixels its windows read, once, 12 bytes of coordinates and 9216 bytes of
    output per patch. in_plane counts only pixels that lie in a plane (the
    kernel never reads padding); else every canvas pixel the windows touch
    (the count used for the canvas kernel of the earlier design)."""
    L = len(planes)
    Hp, Wp = patch.canvas_shape(planes)
    dev = xyl.device
    ar = torch.arange(patch.PATCH, dtype=torch.int32, device=dev)
    lvl = patch._clamp_index(xyl[:, 2], L).long()
    rows = patch._clamp_index(xyl[:, 1:2] + ar, Hp).long()[:, :, None]
    cols = patch._clamp_index(xyl[:, 0:1] + ar, Wp).long()[:, None, :]
    flat = (lvl[:, None, None] * Hp + rows) * Wp + cols
    if in_plane:
        hw = torch.tensor([tuple(p.shape) for p in planes], device=dev)[lvl][:, :, None, None]
        r, c = rows - patch.HALF, cols - patch.HALF
        flat = flat[(r >= 0) & (r < hw[:, 0]) & (c >= 0) & (c < hw[:, 1])]
    touched = torch.zeros(L * Hp * Wp, dtype=torch.bool, device=dev)
    touched[flat.reshape(-1)] = True
    K = xyl.shape[0]
    nbytes = 4 * int(touched.sum()) + 12 * K + 4 * K * patch.PATCH * patch.PATCH
    return nbytes / HBM_BYTES_PER_S * 1e3


def record_sites(fe, left: torch.Tensor, right: torch.Tensor):
    """The four patch gathers of one frame's frontend, as the step makes
    them: {site: (planes, xyl)}, in call order."""
    calls = []
    launch = patch.gather_patches_cuda

    def record(planes, xyl):
        calls.append((tuple(planes), xyl))
        return launch(planes, xyl)

    patch.gather_patches_cuda = record
    try:
        fe.run(left, right)
    finally:
        patch.gather_patches_cuda = launch
    torch.cuda.synchronize()
    if len(calls) != len(SITES):
        raise SystemExit(f"expected {len(SITES)} patch gathers per frame, got {len(calls)}")
    return dict(zip(SITES, calls))


def check_patch_gather(seq) -> dict:
    """The kernel on the card at the four call sites of frame 1's step
    (left ORB, right ORB, right SAD, level-0 fine windows) and on edge
    centres: exact against its plain version, then timed warm and L2-cold
    beside its bound and the plain version; the kernel over K; and the
    canvas the earlier design built every frame. Returns the kernels-line
    numbers."""
    fe = seq.full.frontend
    left, right = seq.inputs(1)
    sites = record_sites(fe, left, right)
    planes_l, xyl_l = sites["left ORB"]
    L = len(planes_l)
    Hp, Wp = patch.canvas_shape(planes_l)
    h0, w0 = planes_l[0].shape
    edges = torch.tensor([[0, 0, 0], [w0 - 1, h0 - 1, 0], [Wp - 1, Hp - 1, L - 1],
                          [Wp + 5, Hp + 9, L - 1], [-1, -1, 0], [-Wp - 3, -2, 3],
                          [17, -60, L + 1], [3, 4, -1]], dtype=torch.int32, device=xyl_l.device)
    cases = dict(sites, **{"edge centres": (planes_l, edges)})
    max_err = 0.0
    for name, (planes, xyl) in cases.items():
        got = patch.gather_patches_cuda(planes, xyl)
        want = patch.gather_patches_plain(planes, xyl)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"patch_gather {name}: shape {tuple(got.shape)} max_abs_diff {err}")
        if err != 0.0:
            raise SystemExit(f"patch_gather disagrees with its plain version ({name}): {err}")
        max_err = max(max_err, err)

    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=xyl_l.device)
    flush = lambda: scratch.fill_(1.0)   # noqa: E731
    flush_ms = _graph_ms(flush, reps=10)
    print(f"L2 flush: {FLUSH_BYTES >> 20} MiB write, {flush_ms:.6f} ms each "
          f"(subtracted from the cold times)")
    out = []
    for name, (planes, xyl) in sites.items():
        fn = lambda: patch.gather_patches_cuda(planes, xyl)  # noqa: E731
        row = dict(site=name, K=int(xyl.shape[0]), cold_ms=_cold_ms(fn, flush),
                   warm_ms=_graph_ms(fn),
                   plain_ms=_graph_ms(lambda: patch.gather_patches_plain(planes, xyl), reps=10),
                   bound_ms=_patch_bound_ms(planes, xyl),
                   canvas_count_bound_ms=_patch_bound_ms(planes, xyl, in_plane=False))
        out.append(row)
        print(f"patch_gather {name}, K = {row['K']}: cold {row['cold_ms']:.6f} ms, bound "
              f"{row['bound_ms']:.6f} ms (bytes; canvas count "
              f"{row['canvas_count_bound_ms']:.6f}), cold/bound "
              f"{row['cold_ms'] / row['bound_ms']:.2f}; warm {row['warm_ms']:.6f} ms "
              f"(L2-resident, not held to the bound); plain {row['plain_ms']:.6f} ms")

    for K in (64, 266, 1000, 4000):
        xyl = xyl_l.repeat(-(-K // xyl_l.shape[0]), 1)[:K].contiguous()
        cold = _cold_ms(lambda: patch.gather_patches_cuda(planes_l, xyl), flush)
        b_ms = _patch_bound_ms(planes_l, xyl)
        print(f"patch_gather over K, left ORB planes: K = {K}: cold {cold:.6f} ms, "
              f"bound {b_ms:.6f} ms, cold/bound {cold / b_ms:.2f}")

    levels = fe._image_stage(torch.stack([left.to(torch.float32), right.to(torch.float32)]))[0]

    def canvas():
        cv = patch.stack_pyramid_for_patches(levels)
        return cv, cv[:, 0].contiguous()

    canvas_ms = _graph_ms(canvas, reps=10)
    canvas_cold_ms = _cold_ms(canvas, flush, reps=10)
    canvas_launches = _count_kernels(canvas)
    print(f"canvas the earlier design built per frame (8 pads, stack, level-0 copy; "
          f"timed alone, not on the path): {canvas_ms:.6f} ms warm, {canvas_cold_ms:.6f} ms "
          f"cold, {canvas_launches} kernel launches")
    return dict(max_abs_err=max_err, sites=out, canvas_ms=canvas_ms,
                canvas_cold_ms=canvas_cold_ms, canvas_launches=canvas_launches)


class Sequence:
    """The synthetic KITTI-size mode-4 sequence with its tables and state.

    The map and object tables hold the true structure: features of a
    keyframe placed at the renderer's depth and the keyframe's true pose,
    as a mapping side with bundle adjustment would provide them. The step
    is then held to ground truth alone, not to a stereo map's errors."""

    def __init__(self, full: FusedFrameStep, cam: CameraConfig, n_frames: int):
        self.full, self.cam = full, cam
        self.scene = synthetic.make_scene(n_frames=n_frames, n_points=2500, n_objects=2,
                                          seed=7, camera=cam, forward_speed=0.3)
        renderer = synthetic.SyntheticRenderer(self.scene)
        t0 = time.perf_counter()
        self.frames = [renderer.render_with_depth(i) for i in range(n_frames)]
        print(f"rendered {n_frames} stereo pairs {cam.width}x{cam.height} in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        self.dev = full.device
        eye = torch.eye(4, device=self.dev)
        self.T, self.vel = eye, eye
        left, right = self.frames[0][:2]
        self.keyframe(0, convert.to_numpy(full.frontend(left, right)))

    def keyframe(self, i: int, frame):
        """Refresh the map and object tables from frame i's features (numpy,
        the frontend's or a step result's), as the mapping side does at
        keyframe rate (host work, no kernel launch)."""
        _, _, inst, depth = self.frames[i]
        xi = np.clip(np.round(frame.xy[:, 0]).astype(int), 0, depth.shape[1] - 1)
        yi = np.clip(np.round(frame.xy[:, 1]).astype(int), 0, depth.shape[0] - 1)
        z = depth[yi, xi]
        frame = frame._replace(depth=np.where(z < 1e6, z, -1.0).astype(np.float32))
        T_cw = np.linalg.inv(self.scene.poses_world[i])
        # the static map leaves out features on the moving objects
        static = frame._replace(valid=frame.valid & (inst[yi, xi] == 0))
        self.map = convert.map_tables(
            *synthetic.map_table_from_frame(static, self.cam, MAP_POINTS, T_cw), self.dev)
        opos, odesc, ovalid, oT = synthetic.object_tables_from_frame(
            self.scene, i, inst, frame, OBJECTS, OBJ_POINTS)
        self.obj = convert.object_tables(opos, odesc, ovalid, self.dev)
        self.To = convert.to_tensor(oT, torch.float32, self.dev)
        self.vo = torch.eye(4, device=self.dev).expand(OBJECTS, 4, 4).contiguous()

    def inputs(self, i: int):
        left, right = self.frames[i][:2]
        return (convert.to_tensor(left, None, self.dev), convert.to_tensor(right, None, self.dev))

    def gt_error(self, i: int, T_cw: torch.Tensor) -> float:
        T_gt = np.linalg.inv(self.scene.poses_world[i])   # frame 0 is the world origin
        return float(np.linalg.norm(T_cw.cpu().numpy()[:3, 3] - T_gt[:3, 3]))

    def object_errors(self, i: int, T_co: torch.Tensor):
        """Translation error of each object's camera-from-object pose."""
        T_cw = np.linalg.inv(self.scene.poses_world[i])
        T_co = T_co.cpu().numpy()
        return [float(np.linalg.norm(T_co[k, :3, 3] - (T_cw @ o.poses_world[i])[:3, 3]))
                for k, o in enumerate(self.scene.objects[:OBJECTS])]


def run_main_path(seq: Sequence):
    """Warm-up + timed frames through FusedFrameStep.__call__ on the card.
    Returns (ms per timed frame, frame count)."""
    full = seq.full
    frame_ms = []
    n = WARMUP_FRAMES + TIMED_FRAMES
    last = None
    for i in range(1, n + 1):
        if i % KEYFRAME_EVERY == 0:
            seq.keyframe(i - 1, last)
        left, right = seq.inputs(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, To, vo, n_obj = full(left, right, seq.T, seq.vel, *seq.map, *seq.obj, seq.To, seq.vo)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        seq.T, seq.vel, seq.To, seq.vo = r.T_cw, r.velocity, To, vo
        last = convert.to_numpy(r)
        n_inl = int(last.n_inliers)
        err = seq.gt_error(i, r.T_cw)
        obj_err = seq.object_errors(i, To)
        finite = bool(torch.isfinite(r.T_cw).all() and torch.isfinite(To).all())
        print(f"frame {i:2d}: {dt:8.3f} ms  camera inliers {n_inl:4d}  "
              f"translation error {err:.4f} m  object inliers {n_obj.tolist()} "
              f"errors {[round(e, 4) for e in obj_err]} m")
        if not finite or n_inl <= MIN_INLIERS or err >= MAX_TRANS_ERR_M:
            raise SystemExit(f"frame {i} failed: inliers {n_inl}, error {err:.4f} m, "
                             f"finite {finite}")
        if i > WARMUP_FRAMES:
            frame_ms.append(dt)
    return frame_ms, n


def time_halves(seq: Sequence, frames):
    """Camera half (.step) and object half (.phase) timed apart, each
    between synchronisations, on the given frames."""
    full = seq.full
    cam_ms, obj_ms = [], []
    T, vel, To, vo = seq.T, seq.vel, seq.To, seq.vo
    for i in frames:
        left, right = seq.inputs(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = full.step.run(left, right, T, vel, *seq.map)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        To2, vo2, _ = full.phase.run(r.xy, r.level, r.desc, r.valid, r.depth, r.u_right,
                                     *seq.obj, To, vo)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cam_ms.append((t1 - t0) * 1e3)
        obj_ms.append((t2 - t1) * 1e3)
    return cam_ms, obj_ms


def profile_frames(seq: Sequence, frames):
    """torch.profiler over a few whole steps: the device's busy and idle
    share, kernel launches per frame and the kernels taking most device
    time. The profiler adds host cost, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    full = seq.full
    T, vel, To, vo = seq.T, seq.vel, seq.To, seq.vo
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in frames:
            left, right = seq.inputs(i)
            r, To, vo, _ = full(left, right, T, vel, *seq.map, *seq.obj, To, vo)
            T, vel = r.T_cw, r.velocity
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels_ev) / 1e3
    by_name = {}
    for e in kernels_ev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    n = len(frames)
    print(f"profile over {n} frames: wall {wall_ms / n:.3f} ms/frame, device busy "
          f"{busy_ms / n:.3f} ms/frame, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels_ev) / n:.0f} kernel launches/frame")
    for name, (cnt, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {t / n:8.3f} ms/frame {cnt / n:6.0f} launches/frame  {name[:90]}")
    # the ops that built the patch canvas in the earlier design; what is
    # left of them is their other uses in the step
    avg = {e.key: e for e in prof.key_averages()}
    for op in CANVAS_OPS:
        e = avg.get(op)
        us = 0.0 if e is None else getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        calls = 0 if e is None else e.count
        print(f"  {op}: {us / 1e3 / n:.6f} device ms/frame over {calls / n:g} calls/frame")


def compare_with_cpu(cfg: SystemConfig, full: FusedFrameStep):
    """Frame 1 from frame 0's tables on the card and on the port's CPU path:
    descriptor bits that differ on agreeing keypoints, and the pose gap.
    Fails past the bounds of tests/test_torch_cuda.py: more than 0.5 % of
    the keypoints differing, or a translation gap over 1e-3 m."""
    scene = synthetic.make_scene(n_frames=2, n_points=2500, n_objects=2, seed=7,
                                 camera=cfg.camera, forward_speed=0.3)
    renderer = synthetic.SyntheticRenderer(scene)
    left0, right0, inst = renderer.render(0)
    left1, right1, _ = renderer.render(1)
    cpu = FusedFrameStep(cfg, device="cpu")
    f0 = convert.to_numpy(cpu.frontend(left0, right0))
    tables = synthetic.map_table_from_frame(f0, cfg.camera, MAP_POINTS)
    otables = synthetic.object_tables_from_frame(scene, 0, inst, f0, OBJECTS, OBJ_POINTS)
    eye = np.eye(4, dtype=np.float32)
    args = (left1, right1, eye, eye, *tables, *otables)
    out = {}
    for name, step in (("cuda", full), ("cpu", cpu)):
        r, To, _, n = step(*args)
        out[name] = (convert.to_numpy(r), To.cpu().numpy(), n.cpu().numpy())
    (g, gTo, gn), (c, cTo, cn) = out["cuda"], out["cpu"]
    same = (g.xy == c.xy).all(axis=1) & (g.level == c.level) & (g.valid == c.valid)
    v = same & c.valid
    flips = int(np.unpackbits((g.desc[v] ^ c.desc[v]).view(np.uint8)).sum())
    differ = int((~same).sum())
    cam_gap = float(np.abs(g.T_cw[:3, 3] - c.T_cw[:3, 3]).max())
    obj_gap = float(np.abs(gTo[:, :3, 3] - cTo[:, :3, 3]).max())
    print(f"cuda vs cpu, frame 1: keypoints differing {differ} of {len(same)}, "
          f"descriptor bits differing {flips} of {256 * int(v.sum())} on agreeing keypoints, "
          f"camera translation gap {cam_gap:.3e} m, object translation gap {obj_gap:.3e} m, "
          f"inliers {int(g.n_inliers)} vs {int(c.n_inliers)}, "
          f"objects {gn.tolist()} vs {cn.tolist()}")
    if not (np.isfinite(g.T_cw).all() and np.isfinite(gTo).all()):
        raise SystemExit("non-finite pose on the card")
    if differ > MAX_KEYPOINTS_DIFFERING * len(same):
        raise SystemExit(f"card and CPU path differ on {differ} of {len(same)} keypoints")
    if not (cam_gap <= MAX_POSE_GAP_M and obj_gap <= MAX_POSE_GAP_M):
        raise SystemExit(f"card and CPU path differ in translation by {cam_gap:.3e} m "
                         f"(camera) and {obj_gap:.3e} m (objects)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(kernels.NVCC_FLAGS)})")

    cam = CameraConfig()
    cfg = SystemConfig().replace(camera=cam)
    full = FusedFrameStep(cfg, device="cuda")
    seq = Sequence(full, cam, n_frames=WARMUP_FRAMES + TIMED_FRAMES + 1)
    kernel = check_patch_gather(seq)

    patch.LAUNCHES = 0
    patch.CANVAS_BUILDS = 0
    frame_ms, n_frames = run_main_path(seq)
    launches, builds = patch.LAUNCHES, patch.CANVAS_BUILDS
    print(f"patch_gather launches on the main path: {launches} over {n_frames} frames; "
          f"canvas builds: {builds}")
    if launches != 4 * n_frames:
        raise SystemExit(f"expected 4 patch_gather launches per frame, got "
                         f"{launches / n_frames:g}")
    if builds != 0:
        raise SystemExit(f"the main path built the patch canvas {builds} times")

    cam_ms, obj_ms = time_halves(seq, range(n_frames - 7, n_frames + 1))
    print(f"median ms/frame on {card}: whole step {np.median(frame_ms):.3f} "
          f"(over {len(frame_ms)} frames), camera half {np.median(cam_ms):.3f}, "
          f"object half {np.median(obj_ms):.3f}")
    profile_frames(seq, range(n_frames - 3, n_frames + 1))
    compare_with_cpu(cfg, full)

    left = kernel["sites"][0]
    line = {"kernels": [{
        "name": "patch_gather", "route": "cuda",
        "source": "pointslot_torch/csrc/patch_gather.cu",
        "replaces": "pointslot_tpu/ops/pallas_patch.py:100",
        "replaces_kernel": "pointslot_tpu/ops/pallas_patch.py::_patch_kernel_stack",
        "launches": launches, "launches_per_frame": launches // n_frames,
        "max_abs_err": kernel["max_abs_err"], "max_abs_diff": kernel["max_abs_err"],
        "ms": left["cold_ms"], "kernel_ms": left["cold_ms"],
        "warm_ms": left["warm_ms"], "plain_ms": left["plain_ms"],
        "bound_ms": left["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "canvas_builds": builds, "sites": kernel["sites"],
        "earlier_canvas": {"ms": kernel["canvas_ms"], "cold_ms": kernel["canvas_cold_ms"],
                           "launches": kernel["canvas_launches"]},
    }]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
