#!/usr/bin/env python3
"""Drive pointslot_torch's per-frame hot path, its Systems in every SLOT
mode with their options, its loop closing and relocalization, its runner
CLI, its sharded engines on a mesh of logical shards and its pipeline
stages on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only r,s   # phases (r) and (s) alone
    python3 chip_smoke.py --only t     # phase (t) alone, beside phase 3

Run from the repository root on a machine with one NVIDIA H100 (or another
sm_90a card). Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc builds every kernel of the paths from pointslot_torch/csrc;
3. kernels against their plain versions (exact) at the four patch-gather
   call sites of frame 1's step and on edge centres, with device times from
   CUDA graphs of repeated launches, warm and L2-cold, beside the bound and
   beside the library yardstick (one advanced-indexing call on a prebuilt
   canvas);
4. fused step: a KITTI-size (1242x375) synthetic mode-4 sequence through
   FusedFrameStep on the card -- a 2048-point local map and two 256-point
   object tables of the true structure, refreshed at keyframes -- checked
   against ground truth, with the kernels' launch counts and the canvas
   builds (none) read around it; then the camera and object halves timed
   apart, a profile, and frame 1 repeated on the port's CPU path (gated);
5. System: the mode-0 System at full KITTI width (default camera, ORB,
   map and BA caps, loop closing off) on 40 frames of the scene of
   tests/test_slam_e2e.py, three ways -- (a) host tracker with sync
   mapping, (b) the device-resident fast path, (c) async mapping on the
   first 20 frames -- each gated on state, ATE, keyframes, BA calls and
   4 patch-gather launches per frame (and, for (c), no keyframe the
   mapping worker failed on); timings, a profile of 4 frames of (a) and
   (b); (a)'s first 13 frames (through the third keyframe and its bundle
   adjustment) against the port's CPU path, and (a)'s last bundle-
   adjustment problem solved again on the CPU and twice on the card (bit
   for bit);
6. mode-4 System: SLOT mode 4 (offline detections) at full KITTI width
   (default camera, ORB and ObjectConfig but tests/test_object_slot.py's
   small-object thresholds; loop closing off) on 20 frames of that file's
   two-object scene (seed 31), two ways -- (d) host tracker with sync
   mapping, the object origin at the offline centre; (e) the device-
   resident fast path with async mapping, the origin from the points and
   fine_tune_with_bbox -- each gated on state, ATE, keyframes, BA calls,
   the median object centre error, a long track flagged dynamic, an
   object BA call, no failure in the async worker and 4 patch-gather
   launches per frame plus 4 per frame with detections; a profile of 4
   frames of (d); (e)'s first 6 gated fused-step frames redone on the
   port's CPU path from the same state (pose, bindings, valid flags); (d)'s
   first 8 frames against the port's CPU path at the CPU System test's
   bounds; (d)'s last object BA problem solved twice on the card (bit for
   bit); then the options of mode 4: (i) offline-flow matching and the
   GMS filter ((d)'s configuration on the same 20 frames, each with its
   forward flow from the rendered depth and the true motion), gated on
   (d)'s camera gates, a track flow-tracked on 3 frames or more and the
   object position RMSE (tests/test_flow_tracking.py:212-239), with the
   takeovers and GMS drops per frame printed and the first matching
   guided_match and gms_filter calls redone on the CPU path (equal); (k)
   (i)'s configuration with the fast path and async mapping for 10 frames,
   save_checkpoint, a fresh System, load_checkpoint (the restored tables
   equal the saved ones) and frames 10-19: state OK, no lost frame, ATE at
   most 1.5x (i)'s + 0.1 m, the object centre error;
7. loop closing and relocalization: the default SystemConfig (loop
   closing on, the in-repo vocabulary, the global BA on its own thread) at
   full KITTI width on all 64 frames of tests/test_loop_closing.py:15's
   loop scene (make_loop_scene(n_frames=48, seed=41, radius=7.0)), two
   ways -- (f) host tracker with sync mapping, gated as that test: state
   OK, a loop closed, ATE and end-point error under 0.2 m after the GBA
   merged, the GBA's cost dropping over all the map's keyframes, no
   failure, 4 patch-gather launches per frame; (g) async mapping with the
   fast path: state OK, no lost frame, a loop closed, ATE at most 1.5x
   (f)'s + 0.1 m, no failure -- and (h) tests/test_loop_closing.py:46's
   relocalization after three black frames (LOST, then OK within 0.3 m);
   the loop closer's steps and the relocalizer timed with CUDA events;
   (f)'s first loop event redone on the card (its kernel launches counted)
   and on the port's CPU path from a copy of the state just before it
   (candidate, groups, T_lc, essential graph, fused bindings, moved points,
   GBA, at tests/test_torch_loop_system.py's bounds), and (h)'s PnP calls
   redone on the CPU with the same draws; then (j): the same 64 frames
   through a tree vocabulary of ORBvoc's shape (k = 10, L = 6, synthesized
   from seed 0, written with save_binary under build/vocab/ and loaded by
   the System through loop.vocab_path with vocab_as_tree): a loop closed,
   ATE at most 1.5x (f)'s + 0.02 m (tests/test_vocab_orbvoc_scale.py:
   142-152), the descent timed with CUDA events and its word ids on the
   card against the CPU path (equal);
8. lens distortion (l): tests/test_distortion_e2e.py's k1 = -0.05
   sequence at full width, calibrated (the fast path configured; it takes
   no frame) and uncalibrated: at least 11 of 12 frames tracked,
   calibrated ATE under 0.10 m, uncalibrated over 1.5x the calibrated;
9. SLOT modes 1-3 at full KITTI width (tests/test_modes.py's thresholds,
   loop closing off), each System run several times, the first run a
   warm-up for the times: (m) mode 1 on 12 frames of
   tests/test_modes.py:17's scene (seed 61), (m1) with the instance mask
   on every frame and (m2) with dynaslam_mode 1 and masks on frames 0 and
   6 only, the ROI tracker carrying them; gated on state, no lost frame,
   ATE under 2 % of the path, valid features inside the mask under 0.02 on
   every frame with a mask, 4 patch-gather launches per frame; (n) mode 2
   from select_rois on frame 0's offline box: a track with at least 6
   poses, 4 launches per frame plus 4 per object extraction, and the ROI
   tracker's boxes on the first 4 frames against a CPU tracker (0.5 px);
   the median object centre error printed beside the JAX package's (0.958
   m on the same input: mode 2's rectangle masks take background features
   into the object, in both packages); (o) mode 3 with the bundled
   trained detector (width 8, input 320, conf 0.3) and ReID network on 6
   frames of tests/test_modes.py:108's scene (seed 205): state OK, at least
   one object track, the same DeepSORT ids on every run (the ATE printed:
   the objects feed camera tracking until DeepSORT confirms them); frame 0's
   detections (same set and classes, boxes within 0.5 px, scores within
   1e-3), their ReID features (1e-4) and DeepSORT's ids on every frame
   against the port's CPU path; then the detector, ReID, DeepSORT (host)
   and ROI-tracker stages alone and the detector's forward at three widths
   (w8 at 320, w16 at 640, the yolov5s geometry at 640 built through
   from_ultralytics, and that one with TF32), timed with CUDA events, with
   launches (counted right after phase 3: torch.profiler counted too few
   kernels in the same calls late in the script), FLOPs and the share of
   the float32 peak;
10. (p) training and two-view: (p1) three steps of the detector's
   YoloTrainer (from the bundled w8 weights, input 320, batch 4, the
   recipe's first frames) and of the ReID training (from the bundled
   weights, a seeded head, batch 64), each from the card's state redone
   on the port's CPU path (cuDNN deterministic for the card's step): the
   loss within 1e-4 relative, gradients, BN statistics and parameters at
   tests/test_torch_train*.py's bounds; whether a card step repeats bit
   for bit under default algorithms is printed; each step's ms (CUDA
   events), host part, device ms and launches (counted early), FLOPs and
   share of the float32 peak; (p2) detect/train_synthetic.py's recipe,
   whole (300 steps) from the seeded initialisation: the mean loss of the
   last 20 steps under 0.8 x that of the first 20 (tests/test_yolo_train
   .py:50), the saved npz loaded back to bit-equal heads, (o)'s 6 frames
   run once with it and the recall of the offline boxes printed beside the
   bundled weights' (a training-set recall: seed 205 is a recipe scene);
   (p3) the ReID training whole at its defaults (64 identities, 800 steps,
   batch 64): the held-out identity margin of tests/test_reid.py:32-48
   above 0.25, the bundled weights' printed beside it; (p4)
   reconstruct_two_view on tests/test_aux.py:25's scene (K = 128), card
   against the CPU path on the same draws, that test's gates, the first
   call timed apart from the warm median;
11. (q) the runner, `pointslot_torch.run`: (q1) (d)'s 20 frames written
   as a KITTI-tracking sequence into a temporary directory without PIL
   (gray PNGs whose rows take the five filter types in turn, 16-bit
   MOTS-style instance PNGs, label_02/0000.txt, pose_gt.txt, calib.yaml),
   every PNG decoded equal to the array written by the C unfilter helper
   and by the plain one (decode ms printed), then `run.main` in mode 4 with
   sync mapping: exit 0, 20 trajectory rows, 20 ObjectDetections files
   (one at least not empty), the object trajectories, stats.json with
   frames 20, evaluation.camera within (d)'s ATE gate and
   evaluation.objects, 4 patch-gather launches per frame plus 4 per frame
   with detections; ms per frame, fps and the wait on the prefetch queue;
   (q2) mode 0 on (q1)'s 20 files with --dp 4 and without: the batched
   frames bit-equal to the single-pair frontend's, 4 launches per pair,
   the trajectories within 1e-4 m, and batch against single-pair ms per
   pair; (q3) `python -m pointslot_torch.run` in subprocesses (8
   synthetic frames; 5 frames with --save-checkpoint beside it; then
   --resume): exit 0, one JSON line, stats.json; (q4) --viz and --live
   where PIL imports, else each stops the runner with a non-zero exit and
   the reason;
12. (r) the mesh, on logical shards of the one card (a mesh may repeat a
   device; pointslot_torch/parallel/): (r1) DistributedSlotStep at
   1242x375 with the default ORB on a (2, 2) mesh of cuda:0, on
   make_example_inputs' 2 frames, 2 objects and a 32-pose, 8192-point BA
   (16 slots per point, its poses and points moved as
   tests/test_parallel.py moves them): frames bit-equal to
   StereoFrontend.batch, object poses within 1e-5 of one batched
   pose_optimize, the BA within 1e-3 (poses) and 5e-3 (points) of the local
   bundle_adjust, the sharded BA solved twice bit for bit, 4 patch-gather
   launches per pair, each phase timed against its unsharded form; (r2)
   batch_sharded over 2 shards on (q1)'s first 4 frames: bit-equal to
   batch, 4 launches per pair; (r3) (f)'s run with use_mesh holding the
   (2, 2) mesh: (f)'s gates, 4 launches per frame, and the counters
   essential_graph_distributed and gba_distributed at least 1, the
   correction and GBA ms printed beside (f)'s;
13. (s) pipeline stages: (a)'s configuration with loop closing on and
   runtime.pipeline_stages, (s1) the mapping stage in a second CUDA
   context on the card (pipeline_child_platform "") on (a)'s 40 frames,
   (s2) on the CPU (the default "cpu") on the first 20: at least one
   packet, bytes back, points in the stage's half of the table, at most 2
   frames missing from the trajectory, ATE under max(2x (a)'s, 0.15 m)
   (tests/test_pipeline_stages.py:99-135), no stage failure raised by
   shutdown, 4 launches per frame; packets, bytes and ms per track_stereo
   printed;
14. (t) the flat multi-image frontend and the last modules, at full width
   with the default ORB: (t1) the multi-image patch_gather at the three call
   sites of StereoFrontend.batch_flat on (q1)'s first 4 pairs (G = 8
   images, image g's level l at canvas row g * 8 + l), exact against its
   plain version there and on edge and out-of-range rows, timed warm and
   L2-cold beside its bytes bound and the indexing yardstick on a prebuilt
   canvas; (t2) batch_flat on (q1)'s first 8 frames as 2 batches of 4
   pairs: 3 launches per batch and no canvas, keypoints equal to batch's,
   angles, descriptor bits and stereo within the frontend tests' bounds,
   ms per pair of both from paired runs; (t3) FusedFrameStep.multi over 4
   frames of phase 4's sequence, bit-equal to 4 chained calls, ms per frame
   of both; (t4) the gated ORB call on a box gate: no keypoint outside it,
   keypoints against the port's CPU path; (t5) stagebench's frontend stage
   ms and roofline.report of them on the H100 models (JSON without NaN);
15. one JSON line with every kernel's numbers (and the times of the
   detection stages, of phase (p), of the runner, of the mesh, of the
   pipeline stages and of phase (t), which no kernel of the port covers);
16. last line: {"ok": true, "device": {...}}.

With ``--only`` (a comma list of r, s and t) it builds the kernels and runs
just those phases beside the runs they are read against -- (f) for (r),
(a) for (s), phase 3's single-pair gather sites for (t) -- with the same
gates, and prints no result lines.

Depth cuts, for the time limit: the mode-0 System runs 40 frames (async
and (s2) 20), the mode-4 System 20; the loop scene runs whole (it needs
its full circle to close); none was cut further by the later phases'
addition.
The runner's phase reuses (d)'s rendered frames, and every synthetic
sequence is rendered on RENDER_THREADS host threads (the same frames as a
serial render) to keep the whole script inside its time.
Needs no network; builds into build/kernels/.
"""

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from pointslot_torch import convert, kernels
from pointslot_torch.config import (CameraConfig, DetectorConfig, LoopConfig, ObjectConfig,
                                    ORBConfig, RuntimeConfig, SLOTMode, SystemConfig,
                                    TrackingConfig)
from pointslot_torch.datasets import synthetic
from pointslot_torch.detect.deepsort import DeepSort
from pointslot_torch.detect.layers import BatchNorm, Conv, init_weights
from pointslot_torch.detect.tracker2d import MultiTracker2D
from pointslot_torch.detect.yolo import ConvBnSiLU, Detector, YOLOv5
from pointslot_torch.geometry import pnp
from pointslot_torch.ops import patch
from pointslot_torch.ops.frontend import StereoFrontend
from pointslot_torch.ops.fused_track import FusedFrameStep
from pointslot_torch.ops.orb import ORBExtractor
from pointslot_torch.parallel import runtime
from pointslot_torch.parallel.dist_ba import distributed_bundle_adjust
from pointslot_torch.parallel.mesh import make_mesh
from pointslot_torch.parallel.step import DistributedSlotStep, make_example_inputs
from pointslot_torch.slam import checkpoint, matchers
from pointslot_torch.slam import object_system as objsys_mod
from pointslot_torch.slam.fast_path import DeviceTrackingPath
from pointslot_torch.slam.loop_closing import LoopCloser, gba_pregate
from pointslot_torch.slam.object_system import heading_y
from pointslot_torch.slam.objects import Detection
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState
from pointslot_torch.solvers import local_ba, pose_opt
from pointslot_torch.utils.profiling import PROFILER
from pointslot_torch.vocab.bow import load_vocab, train_default_vocab
from pointslot_torch.vocab.tree import SparseKeyFrameDatabase, TreeVocabulary

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
SYSTEM_FRAMES, ASYNC_FRAMES, CPU_FRAMES = 40, 20, 13
SYSTEM_SPEED = 0.8               # m/frame, tests/test_slam_e2e.py:17
MAX_ATE_SHARE = 0.02             # of the path length, tests/test_slam_e2e.py:45
PROFILE_AT = 20                  # first of the 4 profiled System frames
MAX_SYSTEM_GAP_M = 5e-3          # card vs CPU System, tests/test_torch_system.py
OBJECT_FRAMES, CPU_OBJECT_FRAMES = 20, 8
MIRRORED_FAST_FRAMES = 6         # (e)'s first fused-step frames redone on the CPU path
OBJECT_PROFILE_AT = 12           # first of the 4 profiled mode-4 frames
MIN_OBJECT_SPAN = 15             # frames both objects stay in view from frame 0
MAX_OBJ_CENTER_ERR_M = 0.5       # median, tests/test_object_slot.py:88
MAX_OBJ_GAP_M, MAX_YAW_GAP = 1e-2, 1e-3   # card vs CPU, tests/test_torch_object_system.py
MAX_OBJ_POINT_GAP = 0.05         # object point counts, same file
LOOP_SCENE_FRAMES = 48           # make_loop_scene(n_frames=48): 64 frames, tests/test_loop_closing.py:15
MIN_FLOW_FRAMES = 3              # flow-tracked frames of the best track, tests/test_flow_tracking.py:220
MAX_FLOW_RMSE_M = 0.5            # object position RMSE with flow, tests/test_flow_tracking.py:239
RESUME_AT = 10                   # (k): frames tracked before the checkpoint
ORBVOC_K, ORBVOC_DEPTH = 10, 6   # ORBvoc's shape, tests/test_vocab_orbvoc_scale.py:17
DIST_K1, DIST_FRAMES = -0.05, 12  # tests/test_distortion_e2e.py:12-13
BUILD_DIR = Path(__file__).resolve().parent / "build"   # git-ignored: checkpoint, vocabulary
RENDER_THREADS = 8               # host threads that render the synthetic frames


def render_frames(render, indices) -> list:
    """[render(i) for i in indices] on RENDER_THREADS host threads, in
    order. The synthetic renderer holds no state that a call changes, so
    the frames equal a serial render's; numpy releases the interpreter
    lock in its array work."""
    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        return list(pool.map(render, indices))


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
        # the library yardstick: one advanced-indexing call on a prebuilt
        # canvas (the canvas build is not timed)
        canvas = patch.stack_pyramid_for_patches(list(planes))
        library = lambda: patch.extract_patches_stack_plain(canvas, xyl)  # noqa: E731
        if not torch.equal(library(), fn()):
            raise SystemExit(f"patch_gather disagrees with the indexing call ({name})")
        row = dict(site=name, K=int(xyl.shape[0]), cold_ms=_cold_ms(fn, flush),
                   warm_ms=_graph_ms(fn),
                   plain_ms=_graph_ms(lambda: patch.gather_patches_plain(planes, xyl), reps=10),
                   library_ms=_cold_ms(library, flush), library_warm_ms=_graph_ms(library),
                   bound_ms=_patch_bound_ms(planes, xyl),
                   canvas_count_bound_ms=_patch_bound_ms(planes, xyl, in_plane=False))
        out.append(row)
        print(f"patch_gather {name}, K = {row['K']}: cold {row['cold_ms']:.6f} ms, bound "
              f"{row['bound_ms']:.6f} ms (bytes; canvas count "
              f"{row['canvas_count_bound_ms']:.6f}), cold/bound "
              f"{row['cold_ms'] / row['bound_ms']:.2f}; warm {row['warm_ms']:.6f} ms "
              f"(L2-resident, not held to the bound); plain {row['plain_ms']:.6f} ms; library "
              f"(advanced indexing on a prebuilt canvas) cold {row['library_ms']:.6f} ms, warm "
              f"{row['library_warm_ms']:.6f} ms")

    bodies = compare_gather_bodies(sites, flush)

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
    return dict(max_abs_err=max_err, sites=out, g1_bodies=bodies, canvas_ms=canvas_ms,
                canvas_cold_ms=canvas_cold_ms, canvas_launches=canvas_launches)


def compare_gather_bodies(sites, flush, turns: int = 3) -> list:
    """The kernel's two bodies at the single-pair sites, side by side: G = 1
    launches the single-image instance; the same planes expanded to G = 2
    with image stride 0 launch the multi-image body, which reads image 0
    for these sites' rows (all below L). Held bit-equal, then timed
    L2-cold and warm in turns (single, multi, multi, single), `turns`
    times. The kernel keeps the single instance for G = 1 while the multi
    body is slower here by more than the spread of the repeats."""
    order = ("single", "multi", "multi", "single") * turns
    rows = []
    for name, (planes, xyl) in sites.items():
        two = [p.expand(2, *p.shape) for p in planes]
        body = {"single": lambda: patch.gather_patches_cuda(planes, xyl),
                "multi": lambda: patch.gather_patches_cuda(two, xyl)}
        if not torch.equal(body["single"](), body["multi"]()):
            raise SystemExit(f"patch_gather: the two bodies disagree at G = 1 ({name})")
        t = {f"{k}_{m}_ms": [] for k in body for m in ("cold", "warm")}
        for k in order:
            t[f"{k}_cold_ms"].append(_cold_ms(body[k], flush))
            t[f"{k}_warm_ms"].append(_graph_ms(body[k]))
        rows.append(dict(site=name, K=int(xyl.shape[0]), **t))
        parts = []
        for m in ("cold", "warm"):
            one, multi = t[f"single_{m}_ms"], t[f"multi_{m}_ms"]
            parts.append(f"{m}: single {min(one):.6f}-{max(one):.6f} ms, multi "
                         f"{min(multi):.6f}-{max(multi):.6f} ms, multi / single "
                         f"{np.mean(multi) / np.mean(one):.3f}")
        print(f"patch_gather bodies at G = 1, {name}, K = {xyl.shape[0]}, bit-equal; "
              + "; ".join(parts))
    return rows


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
        self.frames = render_frames(renderer.render_with_depth, range(n_frames))
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


def _device_summary(prof, n: int, wall_ms: float, label: str, top: int = 12) -> dict:
    """Device busy time, idle share and kernel launches per frame from a
    torch.profiler run over `n` frames that took `wall_ms` in all; prints
    them and the kernels taking most device time."""
    from torch.autograd import DeviceType

    kernels_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels_ev) / 1e3
    by_name = {}
    for e in kernels_ev:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
    out = dict(wall_ms=wall_ms / n, busy_ms=busy_ms / n, idle_share=1 - busy_ms / wall_ms,
               launches=len(kernels_ev) / n)
    print(f"{label} over {n} frames: wall {out['wall_ms']:.3f} ms/frame, device busy "
          f"{out['busy_ms']:.3f} ms/frame, idle share {out['idle_share']:.3f}, "
          f"{out['launches']:.0f} kernel launches/frame")
    for name, (cnt, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {t / n:8.3f} ms/frame {cnt / n:6.0f} launches/frame  {name[:90]}")
    return out


def profile_frames(seq: Sequence, frames):
    """torch.profiler over a few whole steps: the device's busy and idle
    share, kernel launches per frame and the kernels taking most device
    time. The profiler adds host cost, so the idle share is an upper bound."""
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
    n = len(frames)
    _device_summary(prof, n, wall_ms, "profile")
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


# ---------------------------------------------------------------------------
# the mode-0 System
# ---------------------------------------------------------------------------

def system_config(**runtime) -> SystemConfig:
    """Full KITTI width: the default camera (1242x375), ORB (1000 features,
    8 levels), map caps (256 keyframes, 32768 points) and BA caps (32 / 8192
    / 16); loop closing off (not ported); the stage timers on."""
    return SystemConfig(loop=LoopConfig(enabled=False),
                        runtime=RuntimeConfig(profile=True, **runtime))


def render_system_frames(n: int):
    """The scene of tests/test_slam_e2e.py at full width: (scene, frames)."""
    scene = synthetic.make_scene(n_frames=n, n_points=2500, n_objects=0, seed=21,
                                 forward_speed=SYSTEM_SPEED)
    renderer = synthetic.SyntheticRenderer(scene)
    t0 = time.perf_counter()
    frames = [f[:2] for f in render_frames(renderer.render, range(n))]
    print(f"rendered {n} stereo pairs for the System in {time.perf_counter() - t0:.1f} s (host)")
    return scene, frames


def _ate(scene, traj, frames=None) -> float:
    errs = [np.linalg.norm(np.linalg.inv(T)[:3, 3] - scene.poses_world[f][:3, 3])
            for f, T, _ in traj if frames is None or f in frames]
    return float(np.sqrt(np.mean(np.square(errs))))


def _keyframe_ids(m):
    return sorted(int(m.kf_frame_id[k]) for k in m.keyframe_ids())


class _TimedBA:
    """Wraps local_ba.bundle_adjust and bundle_adjust_batched to time each
    call between CUDA events on the device (the callers copy the result to
    the host right after) and keep the last problem of each kind: the
    camera mapper solves with bundle_adjust, the object system with
    bundle_adjust_batched."""

    def __init__(self):
        self.single, self.batched = local_ba.bundle_adjust, local_ba.bundle_adjust_batched
        self.ms = {"camera": [], "object": []}
        self.last = {}

    def _timed(self, fn, kind, prob, kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(prob, **kw)
        end.record()
        end.synchronize()
        self.ms[kind].append(start.elapsed_time(end))
        self.last[kind] = (fn, prob, kw, out)
        return out

    def install(self):
        local_ba.bundle_adjust = lambda prob, **kw: self._timed(self.single, "camera", prob, kw)
        local_ba.bundle_adjust_batched = lambda probs, **kw: self._timed(
            self.batched, "object", probs, kw)

    def remove(self):
        local_ba.bundle_adjust, local_ba.bundle_adjust_batched = self.single, self.batched


class FastPathMirror:
    """The first `n` fused-step frames of a System's DeviceTrackingPath done
    again, before the card does them, by a DeviceTrackingPath on the port's
    CPU path: from copies of the card's device tables, its pose/velocity
    chain, the map and the tracker state, on the same images under the same
    gate (mode 4's background mask). Per frame: the same acceptance, the
    camera translation within MAX_POSE_GAP_M, the bindings and the valid
    flags differing on at most MAX_KEYPOINTS_DIFFERING of the features, and
    n_inliers within 2 (tests/test_torch_cuda.py's card-vs-CPU bounds)."""

    def __init__(self, system, n: int):
        fast, cfg = system._fast, system.cfg
        cam = cfg.camera
        self.cpu = DeviceTrackingPath(cfg, StereoFrontend(cam.height, cam.width, cam.fx, cam.bf,
                                                          cfg.orb, device="cpu"))
        self.n, self.rows = n, []
        track = fast.track

        def mirrored(tracker, left, right, frame_id, gate=None):
            if len(self.rows) >= n:
                return track(tracker, left, right, frame_id, gate=gate)
            cpu = self.cpu
            cpu.table_pts = fast.table_pts.copy()
            cpu._tables = tuple(t.cpu() for t in fast._tables)
            cpu._T_dev, cpu._vel_dev = (None if v is None else v.cpu()
                                        for v in (fast._T_dev, fast._vel_dev))
            state = SimpleNamespace(
                map=convert.map_state_from_arrays(tracker.map), ref_kf=tracker.ref_kf,
                last_frame=SimpleNamespace(T_cw=np.array(tracker.last_frame.T_cw)),
                velocity=np.array(tracker.velocity), n_matches_inliers=None)
            want = cpu.track(state, left, right, frame_id, gate=gate)
            got = track(tracker, left, right, frame_id, gate=gate)
            row = dict(frame=frame_id, gate=gate is not None, accepted=(got is not None,
                                                                       want is not None))
            if got is not None and want is not None:
                n_feat = len(want.valid)
                row.update(
                    pose_gap=float(np.abs(got.T_cw[:3, 3] - want.T_cw[:3, 3]).max()),
                    bind_differ=int((got.point_idx != want.point_idx).sum()),
                    valid_differ=int((got.valid != want.valid).sum()), features=n_feat,
                    inliers=(tracker.n_matches_inliers, state.n_matches_inliers))
            self.rows.append(row)
            return got

        fast.track = mirrored

    def check(self, name: str) -> None:
        print(f"System ({name}) fast path, card vs CPU path from the same state, first "
              f"{len(self.rows)} fused-step frames: {self.rows}")
        bad = [r for r in self.rows
               if r["accepted"][0] != r["accepted"][1]
               or ("pose_gap" in r
                   and not (r["pose_gap"] <= MAX_POSE_GAP_M
                            and r["bind_differ"] <= MAX_KEYPOINTS_DIFFERING * r["features"]
                            and r["valid_differ"] <= MAX_KEYPOINTS_DIFFERING * r["features"]
                            and abs(r["inliers"][0] - r["inliers"][1]) <= 2))]
        if len(self.rows) < self.n or bad:
            raise SystemExit(f"System ({name}): the fast path's card and CPU steps disagree "
                             f"({len(self.rows)} of {self.n} frames mirrored, failing {bad})")


def _track(system, frame, i: int):
    """One track_stereo call; a mode-4 frame carries its detections and
    instance mask, and (phase (i)) its forward flow."""
    left, right, *objs = frame
    kw = dict(detections=objs[0], instance_mask=objs[1]) if objs else {}
    if len(objs) > 2:
        kw["flow"] = objs[2]
    system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i, **kw)


def _object_center_errors(scene, tracks):
    """Translation error of every (frame, track) camera-from-object pose."""
    errs = []
    for track in tracks:
        gt = next(o for o in scene.objects if o.track_id == track.track_id)
        for f, T_co in track.poses_cf.items():
            gt_T_co = np.linalg.inv(scene.poses_world[f]) @ gt.poses_world[f]
            errs.append(np.linalg.norm(T_co[:3, 3] - gt_T_co[:3, 3]))
    return errs


def run_system(name: str, scene, frames, device="cuda", profile_at=None,
               snapshot_at=None, config_fn=None, gate_objects=True, mirror_fast=0,
               setup=None, **runtime) -> dict:
    """Drive System.track_stereo over `frames` on `device` with the patch
    gather's count set to 0 just before and read just after; `config_fn`
    (system_config by default) makes the configuration from `runtime`;
    `gate_objects` holds a mode-4 run to the object gates; `mirror_fast`
    fused-step frames are redone on the CPU path (FastPathMirror, not
    counted: its CPU wrapper launches no kernel); `setup(system)` runs
    before the first frame and may return a callable run after the last.
    Returns the run's numbers; raises SystemExit when a gate fails, and
    RuntimeError from wait_for_mapping when the async mapping worker
    failed."""
    from torch.profiler import ProfilerActivity, profile

    system = System((config_fn or system_config)(**runtime), device=device)
    objsys = system._object_system
    teardown = setup(system) if setup is not None else None
    mirror = FastPathMirror(system, mirror_fast) if mirror_fast else None
    PROFILER.reset()
    timed_ba = _TimedBA() if device == "cuda" else None
    if timed_ba is not None:
        timed_ba.install()
    prof_frames = set(range(profile_at, profile_at + 4)) if profile_at is not None else set()
    out = dict(name=name, frames=len(frames))
    patch.LAUNCHES = 0
    try:
        i = 0
        while i < len(frames):
            if i in prof_frames:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for k in sorted(prof_frames):
                        _track(system, frames[k], k)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                out["profile"] = _device_summary(prof, len(prof_frames), wall_ms,
                                                 f"System ({name}) profile", top=8)
                i += len(prof_frames)
                continue
            _track(system, frames[i], i)
            if snapshot_at is not None and i == snapshot_at - 1:
                out["snapshot"] = (system.camera_trajectory(), _keyframe_ids(system.map),
                                   system.map.n_points(),
                                   objsys and convert.copy_object_state(objsys.all_tracks))
            i += 1
        system.wait_for_mapping()
        launches = patch.LAUNCHES
    finally:
        if timed_ba is not None:
            timed_ba.remove()
        if teardown is not None:
            teardown()
    traj = system.camera_trajectory()
    summary = PROFILER.summary()["stages"]
    stats = system.shutdown()
    n = len(frames)
    # frames the profiler or the CPU mirror slowed are left out of the timing
    untimed = prof_frames | {r["frame"] for r in (mirror.rows if mirror else [])}
    host_ms = [t * 1e3 for k, t in enumerate(system.frame_times) if k not in untimed]
    lost = [e.frame_id for e in system.tracker.trajectory if e.lost]
    out.update(
        traj=traj, ate=_ate(scene, traj), path_m=SYSTEM_SPEED * n, launches=launches,
        track_ms=float(np.median(host_ms)),
        mapping_ms=summary.get("mapping", {}).get("median_ms", float("nan")),
        n_mapped=summary.get("mapping", {}).get("n", 0),
        ba_calls=system.local_mapper.ba_calls,
        ba_device_ms=timed_ba.ms["camera"] if timed_ba is not None else [],
        keyframes=stats["n_keyframes"], points=stats["n_points"],
        fast_frames=system._fast_frames, state=system.tracking_state, lost=lost,
        kf_ids=_keyframe_ids(system.map),
        ba_last=timed_ba.last.get("camera") if timed_ba is not None else None,
        mapping_errors=len(system.mapping_errors),
    )
    # patch gathers: the camera frontend on every frame, the object
    # frontend on every tracked frame with detections
    obj_frames = 0
    if objsys is not None:
        tracked = {f for f, _, _ in traj}
        obj_frames = sum(1 for k, fr in enumerate(frames)
                         if k in tracked and any(d.track_id >= 0 for d in fr[2]))
        out.update(
            tracks=objsys.all_tracks, obj_ba_calls=objsys.ba_calls,
            obj_ms=summary.get("objects", {}).get("median_ms", float("nan")),
            obj_ba_device_ms=timed_ba.ms["object"] if timed_ba is not None else [],
            obj_ba_last=timed_ba.last.get("object") if timed_ba is not None else None,
            obj_err=float(np.median(_object_center_errors(scene, objsys.all_tracks))))
        spans = {t.track_id: (min(t.poses_cf), max(t.poses_cf), len(t.poses_cf),
                              len(t.keyframes), t.n_points(), t.dynamic)
                 for t in objsys.all_tracks}
        print(f"System ({name}) objects: tracks (first frame, last frame, poses, keyframes, "
              f"points, dynamic) {spans}, median centre error {out['obj_err']:.4f} m (bound "
              f"{MAX_OBJ_CENTER_ERR_M}), object BA calls {objsys.ba_calls}, object stage "
              f"{out['obj_ms']:.3f} ms per frame (median), object bundle_adjust "
              f"{[round(t, 3) for t in out['obj_ba_device_ms']]} ms per call (CUDA events)")
    out["obj_frames"] = obj_frames
    print(f"System ({name}) on {device}, {n} frames: state {out['state']}, lost {lost}, "
          f"ATE {out['ate']:.4f} m over {out['path_m']:.1f} m, keyframes {out['keyframes']} "
          f"(ids {out['kf_ids']}), points {out['points']}, BA calls "
          f"{out['ba_calls']}, fast-path frames {out['fast_frames']}, patch_gather "
          f"launches {launches} ({launches / n:g}/frame), mapping errors "
          f"{out['mapping_errors']}")
    print(f"System ({name}): median {out['track_ms']:.3f} ms per track_stereo (host clock, "
          f"{len(host_ms)} frames outside the profile and the mirror), mapping "
          f"{out['mapping_ms']:.3f} ms per keyframe (median of {out['n_mapped']}), bundle_adjust "
          f"{[round(t, 3) for t in out['ba_device_ms']]} ms per call (CUDA events)")
    if not (out["state"] == TrackingState.OK and not lost and len(traj) == n):
        raise SystemExit(f"System ({name}): state {out['state']}, lost frames {lost}, "
                         f"{len(traj)} of {n} frames in the trajectory")
    if not out["ate"] < MAX_ATE_SHARE * out["path_m"]:
        raise SystemExit(f"System ({name}): ATE {out['ate']:.4f} m over {out['path_m']} m")
    if out["keyframes"] < 2 or out["ba_calls"] < 1:
        raise SystemExit(f"System ({name}): {out['keyframes']} keyframes, "
                         f"{out['ba_calls']} BA calls")
    if device == "cuda" and launches != 4 * (n + obj_frames):
        raise SystemExit(f"System ({name}): expected 4 patch_gather launches per frame plus 4 "
                         f"per frame with detections ({4 * (n + obj_frames)}), got {launches}")
    if mirror is not None:
        mirror.check(name)
    if objsys is not None and gate_objects:
        long_tracks = [t for t in objsys.all_tracks if len(t.poses_cf) >= 6]
        if not out["obj_err"] < MAX_OBJ_CENTER_ERR_M:
            raise SystemExit(f"System ({name}): median object centre error {out['obj_err']:.4f} m")
        if not any(t.dynamic for t in long_tracks):
            raise SystemExit(f"System ({name}): no long track flagged dynamic")
        if objsys.ba_calls < 1:
            raise SystemExit(f"System ({name}): no object BA call")
    return out


def check_bundle_adjust_on_cpu(prob, kw, got):
    """A bundle_adjust problem of the card's run solved again on the port's
    CPU path (the pose-block sums run in another order on the card), gated
    at tests/test_torch_mapping.py's bounds: poses 1e-4, obs_inlier equal,
    cost 1e-3 relative, and points 1e-3 m + 1e-4 relative for every point
    whose depth is observed (an inlier stereo observation). A point seen
    only monocularly can slide along its ray at almost no cost; for all
    points the reprojection of every inlier observation is held instead,
    within the image of the 1e-4 relative bound, fx * 1e-4 px."""
    t0 = time.perf_counter()
    cpu_prob = local_ba.BAProblem(*(t.cpu() for t in prob))
    want = local_ba.bundle_adjust(cpu_prob, **kw)
    cpu_s = time.perf_counter() - t0
    got = local_ba.BAResult(*(t.cpu() for t in got))
    pose_gap = float((got.poses - want.poses).abs().max())
    inliers_differ = int((got.obs_inlier != want.obs_inlier).sum())
    cost_rel = abs(float(got.cost) - float(want.cost)) / abs(float(want.cost))
    excess = ((got.points - want.points).abs()
              - (1e-3 + 1e-4 * want.points.abs())).amax(dim=1)
    depth_seen = (want.obs_inlier & cpu_prob.obs_stereo).any(dim=1) & cpu_prob.point_valid
    beyond = (excess > 0) & cpu_prob.point_valid
    point_gap = float((got.points - want.points)[depth_seen].abs().max())
    one = local_ba.stack_problems([cpu_prob])     # the solver's problem axis
    res_got = local_ba._residuals_only(got.poses[None], got.points[None], one, **kw)[0][0]
    res_want = local_ba._residuals_only(want.poses[None], want.points[None], one, **kw)[0][0]
    rows = torch.stack([torch.ones_like(cpu_prob.obs_stereo), torch.ones_like(cpu_prob.obs_stereo),
                        cpu_prob.obs_stereo], dim=-1) & want.obs_inlier[..., None]
    px_gap = float(torch.where(rows, (res_got - res_want).abs(), 0.0).max())
    px_bound = kw["fx"] * 1e-4
    print(f"bundle_adjust card vs CPU on (a)'s last problem ({int(cpu_prob.point_valid.sum())} "
          f"points, {int(depth_seen.sum())} with a stereo inlier; CPU {cpu_s:.1f} s): pose gap "
          f"{pose_gap:.3e} (bound 1e-4), point gap {point_gap:.3e} m on the depth-observed "
          f"points (bound 1e-3 m + 1e-4 relative), points beyond that bound {int(beyond.sum())} "
          f"({int((beyond & depth_seen).sum())} depth-observed, largest gap "
          f"{float((got.points - want.points).abs().amax(dim=1).max()):.3e} m), reprojection "
          f"gap {px_gap:.3e} px (bound {px_bound:.4f}), obs_inlier differing {inliers_differ} "
          f"of {int(cpu_prob.obs_valid.sum())} (bound 0), cost {float(got.cost):.6g} vs "
          f"{float(want.cost):.6g} (relative {cost_rel:.3e}, bound 1e-3)")
    if not (pose_gap <= 1e-4 and not bool((beyond & depth_seen).any()) and px_gap <= px_bound
            and inliers_differ == 0 and cost_rel <= 1e-3):
        raise SystemExit("bundle_adjust: card and CPU path disagree")


def profile_bundle_adjust(prob, kw):
    """torch.profiler over one bundle_adjust call on (a)'s last problem:
    device busy time, idle share and launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        local_ba.bundle_adjust(prob, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_pts = int(prob.point_valid.sum())
    n_obs = int(prob.obs_valid.sum())
    print(f"bundle_adjust problem: {int(prob.pose_valid.sum())} poses "
          f"({int((prob.pose_valid & ~prob.pose_fixed).sum())} free), {n_pts} points, "
          f"{n_obs} observations (caps {prob.poses.shape[0]} / {prob.points.shape[0]} / "
          f"{prob.obs_valid.shape[1]})")
    _device_summary(prof, 1, wall_ms, "bundle_adjust profile (one call)", top=8)


def check_ba_repeats(label: str, last) -> None:
    """The last BA problem of a run solved twice more on the card with the
    same solver: the outputs must be equal bit for bit (the pose-block and
    coupling sums run in a fixed order; torch's default algorithms)."""
    fn, prob, kw, _ = last
    one, two = fn(prob, **kw), fn(prob, **kw)
    torch.cuda.synchronize()
    differ = {name: int((a != b).sum()) for name, a, b in zip(one._fields, one, two)}
    print(f"bundle_adjust repeat on {label}: elements differing between two solves {differ}")
    if any(differ.values()):
        raise SystemExit(f"bundle_adjust does not repeat on {label}: {differ}")


def run_systems(card: str, device="cuda") -> dict:
    """(a) host tracker + sync mapping, (b) the fast path, (c) async
    mapping on the first ASYNC_FRAMES frames; (a)'s first CPU_FRAMES frames
    against the port's CPU path. `device` "cpu" rehearses the phase
    without a card (no profile, no launch gate)."""
    scene, frames = render_system_frames(SYSTEM_FRAMES)
    prof_at = PROFILE_AT if device == "cuda" else None
    a = run_system("a: host tracker, sync mapping", scene, frames, device=device,
                   profile_at=prof_at, snapshot_at=CPU_FRAMES)
    b = run_system("b: device-resident fast path", scene, frames, device=device,
                   profile_at=prof_at, device_resident_tracking=True)
    if not b["fast_frames"] > SYSTEM_FRAMES / 2:
        raise SystemExit(f"System (b): only {b['fast_frames']} of {SYSTEM_FRAMES} frames "
                         f"on the fast path")
    c = run_system("c: async mapping", scene, frames[:ASYNC_FRAMES], device=device,
                   async_mapping=True)
    a_ate = _ate(scene, a["traj"], frames=set(range(ASYNC_FRAMES)))
    print(f"System (c) ATE {c['ate']:.4f} m against (a)'s {a_ate:.4f} m over the same "
          f"{ASYNC_FRAMES} frames (bound 1.5x + 0.1 m, tests/test_async_mapping.py:131)")
    if not c["ate"] <= 1.5 * a_ate + 0.1:
        raise SystemExit("System (c): async ATE out of bound")

    cpu = run_system("a on the CPU", scene, frames[:CPU_FRAMES], device="cpu")
    traj_g, kf_g, pts_g, _ = a["snapshot"]
    tg = {f: np.linalg.inv(T)[:3, 3] for f, T, _ in traj_g}
    tc = {f: np.linalg.inv(T)[:3, 3] for f, T, _ in cpu["traj"]}
    gap = max(float(np.abs(tg[f] - tc[f]).max()) for f in tc) if set(tg) == set(tc) else np.inf
    print(f"System (a) card vs CPU over the first {CPU_FRAMES} frames: translation gap "
          f"{gap:.3e} m (bound {MAX_SYSTEM_GAP_M}), keyframe ids {kf_g} vs {cpu['kf_ids']}, "
          f"points {pts_g} vs {cpu['points']}")
    if not (gap <= MAX_SYSTEM_GAP_M and kf_g == cpu["kf_ids"]
            and abs(pts_g - cpu["points"]) <= 0.02 * cpu["points"]):
        raise SystemExit("System (a): card and CPU path disagree")
    if device == "cuda":
        check_bundle_adjust_on_cpu(*a["ba_last"][1:])
        profile_bundle_adjust(*a["ba_last"][1:3])
        check_ba_repeats("(a)'s last camera problem", a["ba_last"])
    print(f"System summary on {card}: median ms per track_stereo (a) {a['track_ms']:.3f}, "
          f"(b) {b['track_ms']:.3f}, (c) {c['track_ms']:.3f}; mapping ms per keyframe (a) "
          f"{a['mapping_ms']:.3f}, (c) {c['mapping_ms']:.3f}; bundle_adjust device ms "
          f"(a) {a['ba_device_ms']} over {a['ba_calls']} calls")
    return dict(a=a, b=b, c=c, scene=scene, frames=frames)


# ---------------------------------------------------------------------------
# the mode-4 System
# ---------------------------------------------------------------------------

def object_config(set_init_position_by_points: bool = False, **runtime) -> SystemConfig:
    """SLOT mode 4 at full KITTI width: the default camera, ORB, map, BA and
    ObjectConfig caps, with tests/test_object_slot.py:29-36's thresholds for
    the small synthetic objects (10 / 8 / 8 / 10 features and points, 350
    stereo features to initialise); the object origin at the offline centre
    unless `set_init_position_by_points` (the default of ObjectConfig:
    stereo centroid and fine_tune_with_bbox); loop closing off; the stage
    timers on."""
    return SystemConfig(
        slot_mode=SLOTMode.OFFLINE,
        objects=ObjectConfig(init_min_features=10, init_min_map_points=8,
                             min_tracked_points=8, track_min_features=10,
                             set_init_position_by_points=set_init_position_by_points),
        tracking=TrackingConfig(min_init_stereo_features=350),
        loop=LoopConfig(enabled=False),
        runtime=RuntimeConfig(profile=True, **runtime))


def render_object_frames(n: int, flow: bool = False):
    """tests/test_object_slot.py's two-object scene at full width: (scene,
    frames), each frame (left, right, detections, instance mask) with the
    offline detections of offline_detection_rows, and with `flow` the
    frame's forward flow to the next (None for the last). Fails unless both
    objects are in view from frame 0 for at least MIN_OBJECT_SPAN frames."""
    scene = synthetic.make_scene(n_frames=n, n_points=2500, n_objects=2, seed=31,
                                 forward_speed=SYSTEM_SPEED)
    renderer = synthetic.SyntheticRenderer(scene)
    rows = synthetic.offline_detection_rows(scene)
    t0 = time.perf_counter()
    frames = []
    rendered = render_frames(renderer.render_with_depth if flow else renderer.render, range(n))
    for i, views in enumerate(rendered):
        left, right, inst = views[:3]
        fr = rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]
        frames.append((left, right, [Detection.from_row24(r, mask_value=int(r[1]) + 1)
                                     for r in fr], inst))
        if flow:
            frames[-1] += (gt_forward_flow(scene, i, inst, views[3]) if i + 1 < n else None,)
    spans = {}
    for o in scene.objects:
        seen = rows[rows[:, 1] == o.track_id][:, 0].astype(int)
        spans[o.track_id] = (int(seen.min()), int(seen.max()), len(seen)) if len(seen) else None
    print(f"rendered {n} stereo pairs with instance masks for the mode-4 System in "
          f"{time.perf_counter() - t0:.1f} s (host); objects in view (first frame, last frame, "
          f"frames): {spans}")
    if len(spans) != 2 or any(sp is None or sp[0] != 0 or sp[2] < MIN_OBJECT_SPAN
                              for sp in spans.values()):
        raise SystemExit(f"the mode-4 scene does not keep both objects in view: {spans}")
    return scene, frames


def compare_objects_with_cpu(d: dict, cpu: dict) -> None:
    """(d)'s state after its first CPU_OBJECT_FRAMES frames against the same
    frames on the port's CPU path, at tests/test_torch_object_system.py's
    bounds: the same camera keyframes, camera translations within 5e-3 m;
    the same tracks, (frame, track) poses and dynamic flags; object
    translations within 1e-2 m, yaw within 1e-3 rad, point counts within
    5 %."""
    traj_g, kf_g, _, tracks_g = d["snapshot"]
    tg = {f: np.linalg.inv(T)[:3, 3] for f, T, _ in traj_g}
    tc = {f: np.linalg.inv(T)[:3, 3] for f, T, _ in cpu["traj"]}
    cam_gap = max(float(np.abs(tg[f] - tc[f]).max()) for f in tc) if set(tg) == set(tc) else np.inf
    ok = cam_gap <= MAX_SYSTEM_GAP_M and kf_g == cpu["kf_ids"]
    obj_gap = yaw_gap = point_gap = 0.0
    ids_g = [t.track_id for t in tracks_g]
    ok &= ids_g == [t.track_id for t in cpu["tracks"]]
    for g, c in zip(tracks_g, cpu["tracks"]):
        ok &= sorted(g.poses_cf) == sorted(c.poses_cf) and g.dynamic == c.dynamic
        for f in set(g.poses_cf) & set(c.poses_cf):
            obj_gap = max(obj_gap, float(np.abs(g.poses_cf[f][:3, 3] - c.poses_cf[f][:3, 3]).max()))
            yaw_gap = max(yaw_gap, abs(heading_y(g.poses_cf[f][:3, :3])
                                       - heading_y(c.poses_cf[f][:3, :3])))
        point_gap = max(point_gap, abs(g.n_points() - c.n_points()) / max(c.n_points(), 1))
    print(f"System (d) card vs CPU over the first {CPU_OBJECT_FRAMES} frames: camera translation "
          f"gap {cam_gap:.3e} m (bound {MAX_SYSTEM_GAP_M}), keyframe ids {kf_g} vs "
          f"{cpu['kf_ids']}, tracks {ids_g}, object translation gap {obj_gap:.3e} m (bound "
          f"{MAX_OBJ_GAP_M}), yaw gap {yaw_gap:.3e} rad (bound {MAX_YAW_GAP}), object point "
          f"count gap {point_gap:.3%} (bound {MAX_OBJ_POINT_GAP:.0%}), dynamic flags "
          f"{[t.dynamic for t in tracks_g]} vs {[t.dynamic for t in cpu['tracks']]}")
    if not (ok and obj_gap <= MAX_OBJ_GAP_M and yaw_gap <= MAX_YAW_GAP
            and point_gap <= MAX_OBJ_POINT_GAP):
        raise SystemExit("System (d): card and CPU path disagree")


def run_objects(card: str, device="cuda") -> dict:
    """(d) host tracker + sync mapping, (e) fast path + async mapping with
    fine_tune_with_bbox, on OBJECT_FRAMES frames; (d)'s first
    CPU_OBJECT_FRAMES frames against the port's CPU path; (d)'s last object
    BA problem solved twice. `device` "cpu" rehearses the phase without a
    card (no profile, no launch gate, no repeat check)."""
    scene, frames = render_object_frames(OBJECT_FRAMES)
    d = run_system("d: mode 4, host tracker, sync mapping", scene, frames, device=device,
                   profile_at=OBJECT_PROFILE_AT if device == "cuda" else None,
                   snapshot_at=CPU_OBJECT_FRAMES, config_fn=object_config)
    e = run_system("e: mode 4, fast path, async mapping", scene, frames, device=device,
                   config_fn=object_config, set_init_position_by_points=True,
                   device_resident_tracking=True, async_mapping=True,
                   mirror_fast=MIRRORED_FAST_FRAMES)
    if not e["fast_frames"] > OBJECT_FRAMES / 2:
        raise SystemExit(f"System (e): only {e['fast_frames']} of {OBJECT_FRAMES} frames on "
                         f"the fast path")
    cpu = run_system("d on the CPU", scene, frames[:CPU_OBJECT_FRAMES], device="cpu",
                     config_fn=object_config, gate_objects=False)
    compare_objects_with_cpu(d, cpu)
    if device == "cuda":
        check_ba_repeats("(d)'s last object problem", d["obj_ba_last"])
    print(f"mode-4 summary on {card}: median ms per track_stereo (d) {d['track_ms']:.3f}, "
          f"(e) {e['track_ms']:.3f}; object stage ms per frame (d) {d['obj_ms']:.3f}, (e) "
          f"{e['obj_ms']:.3f}; object bundle_adjust ms per call (d) {d['obj_ba_device_ms']}, "
          f"(e) {e['obj_ba_device_ms']}; patch_gather launches (d) {d['launches']} over "
          f"{d['frames']} frames ({d['obj_frames']} with detections), (e) {e['launches']} over "
          f"{e['frames']} ({e['obj_frames']})")
    return dict(d=d, e=e, scene=scene, frames=frames)


# ---------------------------------------------------------------------------
# loop closing and relocalization
# ---------------------------------------------------------------------------

def loop_config(**runtime) -> SystemConfig:
    """Full KITTI width with the defaults of every cap and of LoopConfig
    (loop closing on, the in-repo vocabulary, the global BA on its own
    thread); the stage timers on."""
    return SystemConfig(runtime=RuntimeConfig(profile=True, **runtime))


def _anchored_errors(scene, traj):
    """Translation error of every frame, the estimate's world anchored at
    its first frame (tests/test_loop_closing.py:24-30)."""
    A = scene.poses_world[traj[0][0]]
    return [float(np.linalg.norm((A @ np.linalg.inv(T))[:3, 3] - scene.poses_world[f][:3, 3]))
            for f, T, _ in traj]


class _StepTimer:
    """Wraps methods of an object to time each call between CUDA events on
    the calling thread's stream (each step ends by copying its results to
    the host): ms per call, by label."""

    def __init__(self):
        self.ms = {}

    def wrap(self, obj, name: str, label: str):
        fn = getattr(obj, name)

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            end.synchronize()
            self.ms.setdefault(label, []).append(start.elapsed_time(end))
            return out

        setattr(obj, name, timed)


_LOOP_STEPS = (("_detect_loop", "detection"), ("_geometric_verification", "verification"),
               ("_correct_loop", "correction"), ("_optimize_essential_graph", "essential graph"),
               ("_search_and_fuse", "fuse"), ("_gba_solve", "GBA solve"))


def _loop_state(closer):
    """A copy of a LoopCloser's map and loop state (convert.copy_loop_state)."""
    return (convert.map_state_from_arrays(closer.map), SimpleNamespace(
        db=SimpleNamespace(vectors=closer.db.vectors.copy(), present=closer.db.present.copy()),
        _consistent_groups=[(set(g), c) for g, c in closer._consistent_groups],
        last_loop_kf=closer.last_loop_kf, loops_closed=closer.loops_closed))


def run_loop(name: str, scene, frames, device="cuda", capture_first_event=False,
             loop=None, **runtime) -> dict:
    """The default configuration (loop closing on; `loop`, a LoopConfig, in
    place of the default one) over the loop scene: per-frame track_stereo
    with the patch gather's count set to 0 just before and read just
    after; the loop closer's steps and the relocalizer timed with CUDA
    events; with `capture_first_event`, a copy of the map and loop state
    just before the first keyframe that closes a loop. Returns the run's
    numbers (no gate)."""
    cfg = loop_config(**runtime)
    system = System(cfg if loop is None else cfg.replace(loop=loop), device=device)
    lc = system.loop_closer
    timer = _StepTimer()
    if device == "cuda":
        for method, label in _LOOP_STEPS:
            timer.wrap(lc, method, label)
        timer.wrap(system.tracker.relocalizer, "relocalize", "relocalization")
    out = dict(name=name, frames=len(frames), first_event=None)
    if capture_first_event:
        on_keyframe = lc.on_keyframe

        def capture(kf):
            before = _loop_state(lc) if out["first_event"] is None else None
            closed = on_keyframe(kf)
            if closed and before is not None:
                out["first_event"] = (kf,) + before
            return closed

        lc.on_keyframe = capture
    PROFILER.reset()
    patch.LAUNCHES = 0
    for i, (left, right) in enumerate(frames):
        system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    system.wait_for_mapping()
    lc.wait_for_gba()
    launches = patch.LAUNCHES
    traj = system.camera_trajectory()
    stats = system.shutdown()
    errs = _anchored_errors(scene, traj)
    out.update(
        system=system, traj=traj, launches=launches, state=system.tracking_state,
        lost=[e.frame_id for e in system.tracker.trajectory if e.lost],
        loops=lc.loops_closed, gba=lc.last_gba_stats, keyframes=stats["n_keyframes"],
        points=stats["n_points"], ate=float(np.sqrt(np.mean(np.square(errs)))), end_err=errs[-1],
        track_ms=float(np.median([t * 1e3 for t in system.frame_times])),
        fast_frames=system._fast_frames, steps=timer.ms,
        errors=len(system.mapping_errors) + len(lc.gba_errors))
    print(f"System ({name}) on {device}, {len(frames)} frames: state {out['state']}, lost "
          f"{out['lost']}, loops closed {out['loops']}, ATE {out['ate']:.4f} m, end-point error "
          f"{out['end_err']:.4f} m, keyframes {out['keyframes']}, points {out['points']}, GBA "
          f"{out['gba']}, fast-path frames {out['fast_frames']}, patch_gather launches "
          f"{launches} ({launches / len(frames):g}/frame), failures {out['errors']}; median "
          f"{out['track_ms']:.3f} ms per track_stereo (host clock)")
    if timer.ms:
        print(f"System ({name}) loop steps, ms per call (CUDA events): "
              f"{ {k: [round(t, 3) for t in v] for k, v in timer.ms.items()} }")
    return out


def _replay(cfg, event, device):
    """The loop event `event` (keyframe, map copy, loop state) redone by a
    LoopCloser on `device` from copies of that state, the global BA inline;
    every step's result is recorded."""
    kf, m, state = event
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, background_gba=False))
    closer = LoopCloser(cfg, convert.map_state_from_arrays(m), train_default_vocab(device=device),
                        device=device)
    convert.copy_loop_state(state, closer)
    log = {}
    for method, _ in _LOOP_STEPS:
        fn = getattr(closer, method)

        def wrapped(*args, _fn=fn, _name=method):
            if _name == "_gba_solve":
                mm = closer.map
                log["pre_gba"] = (mm.kf_pose.copy(), mm.pt_pos.copy(), mm.pt_valid.copy(),
                                  mm.kf_point_idx.copy())
                log["gba_prob"] = args[0]["prob"]
            result = _fn(*args)
            log[_name] = result
            if _name == "_detect_loop":
                log["groups"] = sorted((sorted(g), c) for g, c in closer._consistent_groups)
            return result

        setattr(closer, method, wrapped)
    closed = closer.on_keyframe(kf)
    return closed, log, closer


def compare_loop_event_with_cpu(event) -> dict:
    """(f)'s first loop event redone on the card and on the port's CPU path
    from the same copy of the state, at the CPU tests' bounds
    (tests/test_torch_loop_system.py): the same candidate and consistent
    groups, T_lc and the essential graph within 1e-4, the same fused
    bindings and valid points, the moved points within 1e-3 m + 1e-4
    relative, and the global BA's poses within 1e-3 m + 1e-4 relative or
    twice the CPU solve's distance from the float64 solve of its problem,
    its depth-observed points as close to the float64 solve as the CPU's,
    the same inliers and costs within 1e-3 relative. Returns the card
    replay's kernel launches."""
    cfg = loop_config()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        closed, g, _ = _replay(cfg, event, "cuda")
        torch.cuda.synchronize()
    launches = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    t0 = time.perf_counter()
    cpu_closed, c, cpu = _replay(cfg, event, "cpu")
    cpu_s = time.perf_counter() - t0
    checks = dict(closed=closed and cpu_closed,
                  candidate=g["_detect_loop"] == c["_detect_loop"],
                  groups=g["groups"] == c["groups"])
    gaps = {}
    if checks["closed"]:
        gaps["T_lc"] = float(np.abs(g["_geometric_verification"][1]
                                    - c["_geometric_verification"][1]).max())
        gaps["essential graph"] = float(np.abs(g["_optimize_essential_graph"]
                                               - c["_optimize_essential_graph"]).max())
        pose, pos, valid, bind = g["pre_gba"]
        cpose, cpos, cvalid, cbind = c["pre_gba"]
        checks["fused bindings"] = bool((bind == cbind).all() and (valid == cvalid).all())
        moved = np.abs(pos[cvalid] - cpos[cvalid]) <= 1e-3 + 1e-4 * np.abs(cpos[cvalid])
        checks["moved points"] = bool(moved.all())
        (res, stats), (cres, cstats) = g["_gba_solve"], c["_gba_solve"]
        prob = gba_pregate(c["gba_prob"], cpu._cam_args)
        exact = local_ba.bundle_adjust(local_ba.BAProblem(
            *(x.double() if x.is_floating_point() else x for x in prob)), **cpu._cam_args)
        own = np.abs(cres.poses - exact.poses.numpy()).max(axis=(1, 2), keepdims=True)
        bound = np.maximum(1e-3 + 1e-4 * np.abs(cres.poses), 2.0 * own)
        gaps["GBA poses"] = float(np.abs(res.poses - cres.poses).max())
        checks["GBA poses"] = bool((np.abs(res.poses - cres.poses) <= bound).all())
        stereo_in = (cres.obs_inlier & prob.obs_stereo.numpy()).any(axis=1)
        g_err = np.abs(res.points - exact.points.numpy()).max(axis=1)[stereo_in]
        c_err = np.abs(cres.points - exact.points.numpy()).max(axis=1)[stereo_in]
        gaps["GBA points to float64 (median, p99, max), card"] = [
            float(np.percentile(g_err, q)) for q in (50, 99, 100)]
        gaps["GBA points to float64 (median, p99, max), CPU"] = [
            float(np.percentile(c_err, q)) for q in (50, 99, 100)]
        checks["GBA points"] = all(np.percentile(g_err, q) <= max(1e-3, np.percentile(c_err, q))
                                   for q in (50, 99, 100))
        checks["GBA inliers"] = bool((res.obs_inlier == cres.obs_inlier).all())
        checks["GBA costs"] = all(abs(stats[k] - cstats[k]) <= 1e-3 * abs(cstats[k])
                                  for k in ("cost_before", "cost_after"))
        gaps["GBA size"] = (stats["n_kfs"], stats["n_points"], stats["n_obs"])
    ok = (all(checks.values()) and gaps.get("T_lc", 1.0) <= 1e-4
          and gaps.get("essential graph", 1.0) <= 1e-4)
    print(f"loop event at keyframe {event[0]}, card vs CPU from the same state (CPU "
          f"{cpu_s:.1f} s): candidate {g.get('_detect_loop')} vs {c.get('_detect_loop')}, "
          f"checks {checks}, gaps {gaps} (bounds: T_lc and essential graph 1e-4); the card "
          f"replay launched {launches} kernels")
    if not ok:
        raise SystemExit("the loop event: card and CPU path disagree")
    return dict(launches=launches, gaps=gaps)


def render_loop_frames():
    """tests/test_loop_closing.py:15's loop scene at full width, all of it."""
    scene = synthetic.make_loop_scene(n_frames=LOOP_SCENE_FRAMES, seed=41, radius=7.0)
    renderer = synthetic.SyntheticRenderer(scene)
    t0 = time.perf_counter()
    frames = [f[:2] for f in render_frames(renderer.render, range(scene.n_frames))]
    print(f"rendered {len(frames)} stereo pairs of the loop scene in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    return scene, frames


def check_loop_run(out: dict) -> None:
    """(f)'s gates, tests/test_loop_closing.py:14-41."""
    n_kfs = len(out["system"].map.keyframe_ids())
    gba = out["gba"]
    bad = []
    if out["state"] != TrackingState.OK:
        bad.append(f"state {out['state']}")
    if out["loops"] < 1:
        bad.append("no loop closed")
    if not (out["ate"] < 0.2 and out["end_err"] < 0.2):
        bad.append(f"ATE {out['ate']:.4f} m, end-point error {out['end_err']:.4f} m (bounds 0.2)")
    if gba is None or not gba["cost_after"] < gba["cost_before"] or gba["n_kfs"] != n_kfs:
        bad.append(f"GBA {gba} with {n_kfs} keyframes in the map")
    if out["errors"]:
        bad.append(f"{out['errors']} worker or GBA failures")
    if bad:
        raise SystemExit(f"System ({out['name']}): " + "; ".join(bad))


def relocalize_after_blackout(device="cuda") -> dict:
    """(h): tests/test_loop_closing.py:46 at full width: LOST after three
    black frames, OK again at the revisit of frame 5, within 0.3 m of the
    pose tracked there. The PnP call of the relocalization is recorded."""
    scene = synthetic.make_scene(n_frames=10, n_points=2500, n_objects=0, seed=43,
                                 forward_speed=0.6)
    renderer = synthetic.SyntheticRenderer(scene)
    system = System(loop_config(), device=device)
    timer = _StepTimer()
    if device == "cuda":
        timer.wrap(system.tracker.relocalizer, "relocalize", "relocalization")
    solves = []
    ransac = pnp.pnp_ransac

    def recorded(*args, **kw):
        result = ransac(*args, **kw)
        solves.append((args, kw, result))
        return result

    rendered = [renderer.render(i)[:2] for i in range(10)]
    patch.LAUNCHES = 0
    pnp.pnp_ransac = recorded
    try:
        for i, (left, right) in enumerate(rendered):
            system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
        pose_at_5 = next(T for f, T, _ in system.camera_trajectory() if f == 5)
        black = np.zeros_like(rendered[0][0])
        states = []
        for j in range(3):
            system.track_stereo(black, black, timestamp=1.0 + j * 0.1, frame_id=10 + j)
            states.append(system.tracking_state)
        frame = system.track_stereo(*rendered[5], timestamp=1.4, frame_id=13)
    finally:
        pnp.pnp_ransac = ransac
    launches = patch.LAUNCHES
    err = float(np.linalg.norm(frame.T_cw[:3, 3] - pose_at_5[:3, 3]))
    out = dict(name="h: relocalization", frames=14, launches=launches, err=err,
               state=system.tracking_state, states=states, solves=solves, steps=timer.ms)
    system.shutdown()
    print(f"System (h: relocalization) on {device}: states after the black frames {states}, "
          f"at the revisit {out['state']}, pose error {err:.4f} m (bound 0.3), PnP calls "
          f"{len(solves)}, relocalize ms per call (CUDA events) "
          f"{[round(t, 3) for t in timer.ms.get('relocalization', [])]}, patch_gather launches "
          f"{launches} over 14 frames")
    if not (states[-1] == TrackingState.LOST and out["state"] == TrackingState.OK and err < 0.3):
        raise SystemExit(f"System (h): states {states} then {out['state']}, error {err:.4f} m")
    return out


def compare_pnp_with_cpu(solves) -> None:
    """The relocalization's PnP calls redone on the CPU path with the same
    correspondences and draws, at tests/test_torch_loop.py's relocalization
    bounds: the same outcome; where both succeed, translations within
    0.05 m and rotation entries within 0.01. The inlier sets are printed,
    not held: the 128 float32 six-point DLTs (cuSOLVER's eigh on the card,
    LAPACK's on the CPU) can pick another best hypothesis and refine on
    another inlier set."""
    rows = []
    for args, kw, got in solves:
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
        want = pnp.pnp_ransac(*cpu_args, **kw)
        ok, T, inl = convert.host(got.ok, got.T, got.inliers)
        row = dict(ok=(bool(ok), bool(want.ok)), n=int(args[2].sum()),
                   inliers=(int(inl.sum()), int(want.inliers.sum())))
        if ok and want.ok:
            both = (inl & want.inliers.numpy()).sum()
            row.update(t_gap=float(np.abs(T[:3, 3] - want.T.numpy()[:3, 3]).max()),
                       r_gap=float(np.abs(T[:3, :3] - want.T.numpy()[:3, :3]).max()),
                       shared=float(both / max(inl.sum(), want.inliers.sum())))
        rows.append(row)
    print(f"relocalization PnP, card vs CPU with the same draws: {rows}")
    bad = [r for r in rows if r["ok"][0] != r["ok"][1]
           or ("t_gap" in r and not (r["t_gap"] <= 0.05 and r["r_gap"] <= 0.01))]
    if not rows or bad:
        raise SystemExit(f"relocalization PnP: card and CPU path disagree ({bad})")


def run_loop_closing(card: str, device="cuda") -> dict:
    """(f) sync mapping with the background GBA, (g) async mapping with the
    fast path, (h) relocalization; (f)'s first loop event and (h)'s PnP on
    the card against the port's CPU path. `device` "cpu" rehearses the
    runs without a card (no timers, no comparison)."""
    scene, frames = render_loop_frames()
    f = run_loop("f: loop closing, sync mapping", scene, frames, device=device,
                 capture_first_event=True)
    check_loop_run(f)
    print(f"System (f): {len(frames)} frames, patch_gather launches {f['launches']}")
    if device == "cuda" and f["launches"] != 4 * len(frames):
        raise SystemExit(f"System (f): expected {4 * len(frames)} patch_gather launches")
    g = run_loop("g: loop closing, async mapping, fast path", scene, frames, device=device,
                 async_mapping=True, device_resident_tracking=True)
    bad = []
    if g["state"] != TrackingState.OK or g["lost"] or g["loops"] < 1 or g["errors"]:
        bad.append(f"state {g['state']}, lost {g['lost']}, loops {g['loops']}, "
                   f"failures {g['errors']}")
    if not g["ate"] <= 1.5 * f["ate"] + 0.1:
        bad.append(f"ATE {g['ate']:.4f} m against (f)'s {f['ate']:.4f} m (bound 1.5x + 0.1 m)")
    if device == "cuda" and g["launches"] != 4 * len(frames):
        bad.append(f"{g['launches']} patch_gather launches, expected {4 * len(frames)}")
    if bad:
        raise SystemExit("System (g): " + "; ".join(bad))
    h = relocalize_after_blackout(device)
    if device == "cuda" and h["launches"] != 4 * h["frames"]:
        raise SystemExit(f"System (h): expected {4 * h['frames']} patch_gather launches, got "
                         f"{h['launches']}")
    t0 = time.perf_counter()
    j = run_orbvoc_loop(scene, frames, f, device)
    print(f"phase (j) took {time.perf_counter() - t0:.1f} s")
    out = dict(f=f, g=g, h=h, j=j, scene=scene, frames=frames)
    if device == "cuda":
        out["event"] = compare_loop_event_with_cpu(f["first_event"])
        compare_pnp_with_cpu(h["solves"])
        steps = f["steps"]
        print(f"loop summary on {card}: median ms per track_stereo (f) {f['track_ms']:.3f}, (g) "
              f"{g['track_ms']:.3f}; (f) per loop event: detection "
              f"{steps.get('detection')}, verification {steps.get('verification')}, correction "
              f"and fuse {steps.get('correction')} (of which essential graph "
              f"{steps.get('essential graph')}, fuse {steps.get('fuse')}), GBA solve "
              f"{steps.get('GBA solve')} ms for (keyframes, points, observations) "
              f"{out['event']['gaps'].get('GBA size')}; (g) GBA solve "
              f"{g['steps'].get('GBA solve')} ms; relocalization {h['steps']} ms; kernel "
              f"launches per loop event (card replay) {out['event']['launches']}")
    return out


# ---------------------------------------------------------------------------
# the options of modes 0 and 4: offline flow and GMS, an ORBvoc-scale tree
# vocabulary from a file, checkpoint and resume, lens distortion
# ---------------------------------------------------------------------------

def gt_forward_flow(scene, i: int, inst, depth) -> np.ndarray:
    """Dense forward flow frame i -> i+1 from frame i's rendered depth and
    the true camera and object poses (tests/test_flow_tracking.py:144-172)."""
    H, W = depth.shape
    cam = scene.camera
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    z = depth.astype(np.float64)
    valid = z < 1e8
    pc = np.stack([(us - cam.cx) * z / cam.fx, (vs - cam.cy) * z / cam.fy, z], -1)
    T_wc = scene.poses_world[i]
    T_cw_next = np.linalg.inv(scene.poses_world[i + 1])
    pw = pc @ T_wc[:3, :3].T + T_wc[:3, 3]
    pw_next = pw.copy()
    for obj in scene.objects:
        m = inst == (obj.track_id + 1)
        if not m.any():
            continue
        T_rel = obj.poses_world[i + 1] @ np.linalg.inv(obj.poses_world[i])
        pw_next[m] = pw[m] @ T_rel[:3, :3].T + T_rel[:3, 3]
    pc2 = pw_next @ T_cw_next[:3, :3].T + T_cw_next[:3, 3]
    z2 = np.maximum(pc2[..., 2], 1e-6)
    flow = np.stack([cam.fx * pc2[..., 0] / z2 + cam.cx - us,
                     cam.fy * pc2[..., 1] / z2 + cam.cy - vs], -1).astype(np.float32)
    flow[~valid] = 0.0
    return flow


def flow_object_config(**runtime) -> SystemConfig:
    """(d)'s configuration with offline-flow matching and the GMS filter on."""
    cfg = object_config(**runtime)
    return cfg.replace(objects=dataclasses.replace(cfg.objects, use_offline_flow=True,
                                                   use_gms=True))


class _FlowGmsRecorder:
    """Phase (i)'s setup: per object step, the flow-guided takeovers and the
    GMS drops (the profiler's counters read around it); the first
    guided_match and gms_filter calls that match something, their inputs
    and outputs kept for the CPU check."""

    def __init__(self):
        self.per_frame = []
        self.calls = {}

    def _record(self, name, fn, matched):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if name not in self.calls and matched(out):
                self.calls[name] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                                    kw, out)
            return out
        return wrapped

    def __call__(self, system):
        objsys = system._object_system
        track = objsys._track_objects_batched
        guided, gms = matchers.guided_match, objsys_mod.gms_filter
        counters = PROFILER.counters

        def counted(items, *args, **kw):
            before = counters["obj_flow_takeovers"], counters["obj_gms_dropped"]
            out = track(items, *args, **kw)
            self.per_frame.append((items[0][0].frame_id if items else None,
                                   int(counters["obj_flow_takeovers"] - before[0]),
                                   int(counters["obj_gms_dropped"] - before[1])))
            return out

        objsys._track_objects_batched = counted
        matchers.guided_match = self._record("guided_match", guided,
                                             lambda r: bool((r.n_matches >= 5).any()))
        objsys_mod.gms_filter = self._record("gms_filter", gms,
                                             lambda keep: bool((~keep).any() & keep.any()))

        def teardown():
            matchers.guided_match, objsys_mod.gms_filter = guided, gms
        return teardown


def compare_matches_with_cpu(calls) -> None:
    """The recorded guided_match and gms_filter calls of the card redone on
    the port's CPU path: equal bindings, counts and keep masks."""
    if set(calls) != {"guided_match", "gms_filter"}:
        raise SystemExit(f"System (i): guided_match or gms_filter never matched ({sorted(calls)})")
    rows = {}
    for name, (args, kw, out) in calls.items():
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
        if name == "guided_match":
            got = matchers.guided_match(*cpu_args, **kw)
            equal = (torch.equal(got.point_for_feature, out.point_for_feature.cpu())
                     and torch.equal(got.n_matches, out.n_matches.cpu()))
            rows[name] = dict(shape=tuple(args[0].shape), matches=out.n_matches.tolist(),
                              equal=equal)
        else:
            got = objsys_mod.gms_filter(*cpu_args, **kw)
            rows[name] = dict(shape=tuple(args[0].shape), kept=int(out.sum()),
                              valid=int(args[2].sum()), equal=torch.equal(got, out.cpu()))
    print(f"System (i) card vs CPU path on the first matching calls: {rows}")
    if not all(r["equal"] for r in rows.values()):
        raise SystemExit("System (i): guided_match or gms_filter differs between card and CPU")


def _object_world_rmse(scene, tracks) -> float:
    """Object position RMSE in the world (tests/test_flow_tracking.py:223-239)."""
    gt = {o.track_id: o for o in scene.objects}
    errs = [np.linalg.norm(T_wo[:3, 3] - gt[t.track_id].poses_world[f][:3, 3])
            for t in tracks if t.track_id in gt for f, T_wo in t.poses_world.items()]
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("inf")


def run_flow_objects(card: str, device="cuda") -> dict:
    """(i): mode 4 with offline flow and GMS, host tracker and sync mapping,
    on OBJECT_FRAMES frames of the two-object scene with their forward
    flow; gated on (d)'s camera gates, a track flow-tracked on at least
    MIN_FLOW_FRAMES frames and the object position RMSE; the first matching
    guided_match and gms_filter calls redone on the CPU path."""
    scene, frames = render_object_frames(OBJECT_FRAMES, flow=True)
    rec = _FlowGmsRecorder()
    t0 = time.perf_counter()
    i = run_system("i: mode 4, offline flow + GMS, host tracker, sync mapping", scene, frames,
                   device=device, config_fn=flow_object_config, gate_objects=False, setup=rec)
    i["seconds"] = time.perf_counter() - t0
    flow_frames = {t.track_id: t.flow_tracked_frames for t in i["tracks"]}
    rmse = _object_world_rmse(scene, i["tracks"])
    print(f"System (i) per object step (frame, flow-guided takeovers, GMS drops): "
          f"{rec.per_frame}; flow-tracked frames per track {flow_frames} (gate >= "
          f"{MIN_FLOW_FRAMES}); object position RMSE {rmse:.4f} m (bound {MAX_FLOW_RMSE_M}); "
          f"object stage {i['obj_ms']:.3f} ms per frame (median); {i['seconds']:.1f} s")
    if not (max(flow_frames.values(), default=0) >= MIN_FLOW_FRAMES
            and rmse < MAX_FLOW_RMSE_M):
        raise SystemExit("System (i): the flow gates failed")
    if not sum(r[2] for r in rec.per_frame) >= 1:
        raise SystemExit("System (i): GMS dropped no binding")
    compare_matches_with_cpu(rec.calls)
    i.update(per_frame=rec.per_frame, flow_frames=flow_frames, rmse=rmse)
    return dict(i=i, scene=scene, frames=frames)


def _checkpoint_tables(system) -> dict:
    """Everything a checkpoint restores, as named host arrays."""
    out = {f"map/{f}": np.array(getattr(system.map, f)) for f in checkpoint._MAP_FIELDS}
    out["map/next_uid"] = np.int64(system.map._next_uid)
    tr = system.tracker
    out["tracker"] = np.array([tr.state, tr.ref_kf, tr.last_kf_frame_id])
    for f, T, lost in system.camera_trajectory():
        out[f"traj/{f}"] = np.append(T.ravel(), lost)
    for t in system._object_system.all_tracks:
        for a in checkpoint._TRACK_SCALARS + checkpoint._TRACK_ARRAYS:
            out[f"obj/{t.track_id}/{a}"] = np.array(getattr(t, a))
        for f in t.poses_cf:
            out[f"obj/{t.track_id}/pose/{f}"] = np.stack([t.poses_cf[f], t.poses_world[f]])
        for j, okf in enumerate(t.keyframes):
            for a in checkpoint._OKF_ARRAYS:
                out[f"obj/{t.track_id}/okf/{j}/{a}"] = np.array(getattr(okf, a))
    return out


def run_checkpoint_resume(scene, frames, i_run: dict, device="cuda") -> dict:
    """(k): (i)'s configuration with the fast path and async mapping: the
    first RESUME_AT frames, save_checkpoint, a fresh System, load_checkpoint
    (the restored tables must equal the saved ones), then the remaining
    frames; gated on state OK after the first resumed frame, no lost frame,
    camera ATE over all frames at most 1.5x (i)'s + 0.1 m, and the median
    object centre error."""
    cfg = flow_object_config(device_resident_tracking=True, async_mapping=True)
    path = BUILD_DIR / "checkpoints" / "k.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    n = len(frames)
    t0 = time.perf_counter()
    patch.LAUNCHES = 0
    first = System(cfg, device=device)
    for k in range(RESUME_AT):
        _track(first, frames[k], k)
    first.wait_for_mapping()
    t1 = time.perf_counter()
    checkpoint.save_checkpoint(str(path), first)
    save_ms = (time.perf_counter() - t1) * 1e3
    saved, fast_before = _checkpoint_tables(first), first._fast_frames
    first.shutdown()

    second = System(cfg, device=device)
    t1 = time.perf_counter()
    checkpoint.load_checkpoint(str(path), second)
    load_ms = (time.perf_counter() - t1) * 1e3
    restored = _checkpoint_tables(second)
    differ = sorted(k for k in set(saved) | set(restored)
                    if k not in saved or k not in restored
                    or not np.array_equal(saved[k], restored[k]))
    states = []
    for k in range(RESUME_AT, n):
        _track(second, frames[k], k)
        states.append(second.tracking_state)
    second.wait_for_mapping()
    launches = patch.LAUNCHES
    traj = second.camera_trajectory()
    lost = [e.frame_id for e in second.tracker.trajectory if e.lost]
    objsys = second._object_system
    obj_err = float(np.median(_object_center_errors(scene, objsys.all_tracks)))
    out = dict(name="k: checkpoint and resume", frames=n, launches=launches,
               ate=_ate(scene, traj), lost=lost, states=states, obj_err=obj_err,
               fast_frames=(fast_before, second._fast_frames),
               flow_frames={t.track_id: t.flow_tracked_frames for t in objsys.all_tracks},
               save_ms=save_ms, load_ms=load_ms, file_bytes=path.stat().st_size)
    second.shutdown()
    out["seconds"] = time.perf_counter() - t0
    obj_frames = sum(1 for k, fr in enumerate(frames)
                     if k in {f for f, _, _ in traj} and any(d.track_id >= 0 for d in fr[2]))
    bound = 1.5 * i_run["ate"] + 0.1
    print(f"System (k: checkpoint after frame {RESUME_AT - 1}, resume in a fresh System) on "
          f"{device}: {len(saved)} saved tables, {len(differ)} differing after the load "
          f"{differ[:5]}; save {save_ms:.1f} ms, load {load_ms:.1f} ms, file {out['file_bytes']} "
          f"bytes; states after the resumed frames {states}, lost {lost}; ATE over {n} frames "
          f"{out['ate']:.4f} m (bound {bound:.4f}: 1.5x (i)'s {i_run['ate']:.4f} + 0.1); median "
          f"object centre error {obj_err:.4f} m (bound {MAX_OBJ_CENTER_ERR_M}); fast-path frames "
          f"before / after {out['fast_frames']}; flow-tracked frames {out['flow_frames']}; "
          f"patch_gather launches {launches} over {n} frames ({obj_frames} with detections); "
          f"{out['seconds']:.1f} s")
    bad = []
    if differ or not saved:
        bad.append(f"{len(differ)} tables differ after the load")
    if not (states[0] == TrackingState.OK and all(st == TrackingState.OK for st in states)
            and not lost and len(traj) == n):
        bad.append(f"states {states}, lost {lost}, {len(traj)} of {n} frames")
    if not out["ate"] <= bound:
        bad.append(f"ATE {out['ate']:.4f} m")
    if not obj_err < MAX_OBJ_CENTER_ERR_M:
        bad.append(f"object centre error {obj_err:.4f} m")
    if device == "cuda" and launches != 4 * (n + obj_frames):
        bad.append(f"{launches} patch_gather launches, expected {4 * (n + obj_frames)}")
    if bad:
        raise SystemExit("System (k): " + "; ".join(bad))
    return out


def run_orbvoc_loop(scene, frames, f: dict, device="cuda") -> dict:
    """(j): (f)'s loop scene through a tree of ORBvoc's shape (k = 10,
    L = 6, TreeVocabulary.synthesize(seed=0)) written with save_binary and
    loaded by the System through loop.vocab_path with vocab_as_tree; gated
    on a loop closed and ATE at most 1.5x (f)'s + 0.02 m
    (tests/test_vocab_orbvoc_scale.py:142-152); one frame's word ids on the
    card against the CPU path; the descent timed with CUDA events."""
    path = BUILD_DIR / "vocab" / f"synth_k{ORBVOC_K}_L{ORBVOC_DEPTH}_s0.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    synth = TreeVocabulary.synthesize(k=ORBVOC_K, depth=ORBVOC_DEPTH, seed=0, device="cpu")
    synth.save_binary(str(path))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vocab = load_vocab(str(path), as_tree=True, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    cam = CameraConfig()
    ext = ORBExtractor(cam.height, cam.width, ORBConfig(), device=device)
    feats = ext(frames[0][0])
    desc, valid = feats.desc, feats.valid
    descent_ms = []
    if device == "cuda":
        for _ in range(25):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            vocab.transform_device(desc, valid)
            end.record()
            end.synchronize()
            descent_ms.append(start.elapsed_time(end))
    cpu_vocab = TreeVocabulary(vocab.node_desc, vocab.children, vocab.node_weights,
                               vocab.is_leaf, vocab.k, vocab.depth, device="cpu")
    words = vocab.word_ids(desc, valid)
    words_cpu = cpu_vocab.word_ids(desc.cpu(), valid.cpu())
    words_equal = bool(np.array_equal(words, words_cpu))
    n_bytes, depth, n_words = vocab.device_bytes, vocab.depth, vocab.n_words
    del synth, vocab, cpu_vocab

    j = run_loop("j: loop closing through an ORBvoc-scale tree file", scene, frames,
                 device=device, loop=LoopConfig(vocab_path=str(path), vocab_as_tree=True))
    db = j["system"].loop_closer.db
    postings = [len(p) for p in db._inv.values()]
    j.update(words_equal=words_equal, device_bytes=n_bytes, load_s=load_s, write_s=write_s,
             descent_ms=float(np.median(descent_ms)) if descent_ms else float("nan"),
             posting_mean=float(np.mean(postings)) if postings else 0.0,
             posting_words=len(postings), n_words=n_words)
    bound = 1.5 * f["ate"] + 0.02
    print(f"System (j) vocabulary: {n_words} words, depth {depth} (L + 1 after the file), "
          f"{n_bytes} bytes of node tables on {device}, file written in {write_s:.1f} s, "
          f"loaded in {load_s:.2f} s; descent of a keyframe's {len(valid)} feature rows "
          f"({int(valid.sum())} valid) {j['descent_ms']:.4f} ms (median of {len(descent_ms)}, "
          f"CUDA events); "
          f"word ids card vs CPU equal: {words_equal}; database {type(db).__name__}, "
          f"{len(postings)} words with postings, mean posting-list length "
          f"{j['posting_mean']:.3f}; ATE {j['ate']:.4f} m against (f)'s {f['ate']:.4f} m (bound "
          f"{bound:.4f}), loops closed {j['loops']}")
    bad = []
    if not words_equal:
        bad.append("word ids differ between card and CPU")
    if j["state"] != TrackingState.OK or j["loops"] < 1 or j["errors"]:
        bad.append(f"state {j['state']}, loops {j['loops']}, failures {j['errors']}")
    if not j["ate"] <= bound:
        bad.append(f"ATE {j['ate']:.4f} m")
    if not isinstance(db, SparseKeyFrameDatabase):
        bad.append(f"database {type(db).__name__}")
    if device == "cuda" and j["launches"] != 4 * len(frames):
        bad.append(f"{j['launches']} patch_gather launches, expected {4 * len(frames)}")
    if bad:
        raise SystemExit("System (j): " + "; ".join(bad))
    return j


def distort_image(img: np.ndarray, cam: CameraConfig, k1: float) -> np.ndarray:
    """Render through a distorting lens (tests/test_distortion_e2e.py:16-37):
    sample the pinhole image at the undistorted position of every output
    pixel, so a point whose pinhole projection is u_p appears at u_d with
    undistort(u_d) = u_p."""
    from scipy.ndimage import map_coordinates

    h, w = img.shape
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (u - cam.cx) / cam.fx
    yn = (v - cam.cy) / cam.fy
    xu, yu = xn.copy(), yn.copy()
    for _ in range(5):
        rad = 1.0 + k1 * (xu * xu + yu * yu)
        xu = xn / rad
        yu = yn / rad
    out = map_coordinates(img.astype(np.float32), [yu * cam.fy + cam.cy, xu * cam.fx + cam.cx],
                          order=1, mode="nearest")
    return out.astype(np.uint8)


def run_distortion(device="cuda") -> dict:
    """(l): tests/test_distortion_e2e.py's k1 = -0.05 sequence at full width
    (DIST_FRAMES frames rendered through the pinhole camera, then through
    the lens), tracked calibrated (the fast path configured: it must take no
    frame) and uncalibrated; gated on at least DIST_FRAMES - 1 frames
    tracked, calibrated ATE under 0.10 m, uncalibrated ATE over 1.5x the
    calibrated (:72-87)."""
    pin = CameraConfig()
    scene = synthetic.make_scene(n_frames=DIST_FRAMES, n_objects=0, seed=21, camera=pin,
                                 forward_speed=0.5, yaw_rate=0.03)
    renderer = synthetic.SyntheticRenderer(scene)
    t0 = time.perf_counter()
    frames = render_frames(lambda i: tuple(distort_image(x, pin, DIST_K1)
                                           for x in renderer.render(i)[:2]), range(DIST_FRAMES))
    render_s = time.perf_counter() - t0
    runs = {}
    for calibrated in (True, False):
        cfg = SystemConfig(camera=dataclasses.replace(pin, k1=DIST_K1 if calibrated else 0.0),
                           tracking=TrackingConfig(min_init_stereo_features=150),
                           loop=LoopConfig(enabled=False),
                           runtime=RuntimeConfig(profile=True,
                                                 device_resident_tracking=calibrated))
        system = System(cfg, device=device)
        patch.LAUNCHES = 0
        for i, (left, right) in enumerate(frames):
            system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
        launches = patch.LAUNCHES
        traj = system.camera_trajectory()
        errs = [np.linalg.norm(np.linalg.inv(T)[:3, 3] - scene.poses_world[f][:3, 3])
                for f, T, lost in traj if not lost]
        runs[calibrated] = dict(
            ate=float(np.sqrt(np.mean(np.square(errs)))) if errs else float("inf"),
            tracked=len(errs), state=system.tracking_state, fast_frames=system._fast_frames,
            launches=launches, track_ms=float(np.median(system.frame_times)) * 1e3)
        system.shutdown()
    cal, raw = runs[True], runs[False]
    print(f"System (l: k1 = {DIST_K1}) on {device}, {DIST_FRAMES} frames (distorted in "
          f"{render_s:.1f} s on the host): calibrated ATE {cal['ate']:.4f} m (bound 0.10), "
          f"{cal['tracked']} frames tracked, state {cal['state']}, fast-path frames "
          f"{cal['fast_frames']} (the fast path configured, off for a distorted camera), median "
          f"{cal['track_ms']:.3f} ms per track_stereo; uncalibrated ATE {raw['ate']:.4f} m "
          f"(bound > {1.5 * cal['ate']:.4f}); patch_gather launches {cal['launches']} / "
          f"{raw['launches']}")
    bad = []
    if not (cal["state"] == TrackingState.OK and cal["tracked"] >= DIST_FRAMES - 1
            and cal["ate"] < 0.10):
        bad.append(f"calibrated run: state {cal['state']}, {cal['tracked']} frames, "
                   f"ATE {cal['ate']:.4f} m")
    if not raw["ate"] > 1.5 * cal["ate"]:
        bad.append(f"uncalibrated ATE {raw['ate']:.4f} m not over 1.5x the calibrated")
    if cal["fast_frames"]:
        bad.append(f"the fast path took {cal['fast_frames']} frames of a distorted camera")
    if device == "cuda" and not cal["launches"] == raw["launches"] == 4 * DIST_FRAMES:
        bad.append(f"patch_gather launches {cal['launches']} / {raw['launches']}, expected "
                   f"{4 * DIST_FRAMES}")
    if bad:
        raise SystemExit("System (l): " + "; ".join(bad))
    return dict(name="l: lens distortion", frames=2 * DIST_FRAMES,
                launches=cal["launches"] + raw["launches"], calibrated=cal, uncalibrated=raw)


# ---------------------------------------------------------------------------
# SLOT modes 1-3: dynamic masks, manual ROIs, the online detector
# ---------------------------------------------------------------------------

MODE_SCENE = dict(n_objects=1, seed=61, forward_speed=0.7)    # tests/test_modes.py:17
MODE_FRAMES = 12
DYNA_MASK_FRAMES = (0, 6)        # (m2): masks given; the ROI tracker carries them between
MAX_IN_MASK_SHARE = 0.02         # valid features inside the mask, tests/test_modes.py:66
ONLINE_SCENE = dict(n_objects=2, seed=205, forward_speed=0.8)  # tests/test_modes.py:108
ONLINE_FRAMES = 6
W8_WEIGHTS = Path(__file__).resolve().parent / "pointslot_tpu/detect/weights/synthetic_yolo_w8.npz"
SLOT_RUNS = {"m1": 3, "m2": 3, "n": 3, "o": 5}   # runs of each; the first is the warm-up
STAGE_CALLS, STAGE_WARMUP = 25, 3
F32_PEAK_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores (data sheet)
TF32_PEAK_FLOPS = 495e12         # H100 SXM TF32 dense (data sheet)
MAX_DET_BOX_GAP_PX, MAX_DET_SCORE_GAP = 0.5, 1e-3   # card vs CPU detector
MAX_REID_GAP = 1e-4              # card vs CPU ReID features
MAX_ROI_GAP_PX, ROI_CPU_FRAMES = 0.5, 4   # card vs CPU ROI tracker boxes
# (n)'s median object centre error in the JAX package on the same 12 frames
# (its System on the CPU): mode 2's rectangle masks carry background
# features into the object and its size is a uniform prior, so the object
# centre sits 0.5-1.1 m off in both packages
MODE2_REFERENCE_ERR_M = 0.958


def slot_config(mode: int, **fields) -> SystemConfig:
    """tests/test_modes.py's _slot_cfg at full KITTI width (default camera,
    ORB, map and BA caps): the small-object thresholds (10 / 8 / 8 / 10) and
    350 stereo features to initialise; loop closing off; the stage timers
    on."""
    return SystemConfig(
        slot_mode=mode,
        objects=ObjectConfig(init_min_features=10, init_min_map_points=8,
                             min_tracked_points=8, track_min_features=10),
        tracking=TrackingConfig(min_init_stereo_features=350),
        loop=LoopConfig(enabled=False), runtime=RuntimeConfig(profile=True), **fields)


def online_config() -> SystemConfig:
    """Mode 3 with the bundled trained detector (width 8, input 320, conf
    0.3) and the bundled ReID network, as tests/test_modes.py:118-121."""
    return slot_config(SLOTMode.AUTONOMOUS_DRIVING, detector=DetectorConfig(
        weights_path=str(W8_WEIGHTS), input_size=320, network_width=8, conf_threshold=0.3))


def render_slot_frames(spec: dict, n: int):
    scene = synthetic.make_scene(n_frames=n, **spec)
    renderer = synthetic.SyntheticRenderer(scene)
    t0 = time.perf_counter()
    frames = render_frames(renderer.render, range(n))
    print(f"rendered {n} stereo pairs of make_scene({spec}) in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    return scene, frames, synthetic.offline_detection_rows(scene)


def _event_ms(fn, calls: int = STAGE_CALLS, warmup: int = STAGE_WARMUP, setup=None) -> float:
    """Median ms of `calls` calls of `fn` after `warmup`, each between two
    CUDA events and waited for (host work in `fn` counts too); `setup()`
    runs untimed before each call and its result is passed to `fn`."""
    times = []
    for k in range(warmup + calls):
        arg = setup() if setup is not None else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg) if setup is not None else fn()
        end.record()
        end.synchronize()
        if k >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def drive_slot(name: str, cfg: SystemConfig, scene, frames, rows, device="cuda",
               masks=None, rois=None, system=None, gate_ate=True) -> dict:
    """One System over `frames` with the patch gather's count set to 0
    just before and read just after: each call between CUDA events (on the
    card), the in-mask share of the valid features on every frame with a
    mask, the ROI tracker's boxes, the detector's output and DeepSORT's ids
    per frame. `masks(i, inst)` gives frame i's instance mask (or None);
    `rois` are registered on frame 0 with select_rois. Gated on the state,
    no lost frame, the ATE (unless not `gate_ate`), the in-mask share and 4
    patch-gather launches per frame plus 4 per object extraction."""
    system = system or System(cfg, device=device)
    out = dict(name=name, frames=len(frames), boxes=[], ids=[], raw=[], in_mask={},
               in_true_mask={}, event_ms=[], obj_extractions=0)
    objsys = system._object_system
    if objsys is not None:
        extract = objsys._extract_object_features

        def counted(*args):
            out["obj_extractions"] += 1
            return extract(*args)

        objsys._extract_object_features = counted
    if system.detector is not None:
        run = system.detector.run
        system.detector.run = lambda img: out["raw"].append(run(img)) or out["raw"][-1]
    if system.mot is not None:
        update = system.mot.update

        def recorded(dets, image=None):
            tracks = update(dets, image)
            out["ids"].append(sorted(t["track_id"] for t in tracks))
            return tracks

        system.mot.update = recorded
    cuda = device == "cuda"
    PROFILER.reset()
    patch.LAUNCHES = 0
    for i, (left, right, inst) in enumerate(frames):
        if rois and i == 0:
            system.select_rois(left, rois)
        mask = masks(i, inst) if masks is not None else None
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        frame = system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i,
                                    instance_mask=mask)
        if cuda:
            end.record()
            end.synchronize()
            out["event_ms"].append(start.elapsed_time(end))
        xy = frame.xy[frame.valid]
        yi = np.clip(np.round(xy[:, 1]).astype(int), 0, inst.shape[0] - 1)
        xi = np.clip(np.round(xy[:, 0]).astype(int), 0, inst.shape[1] - 1)
        out["in_true_mask"][i] = round(float((inst[yi, xi] != 0).mean()), 4) if len(xy) else 0.0
        if mask is not None:
            out["in_mask"][i] = float((mask[yi, xi] != 0).mean()) if len(xy) else 0.0
        if system.roi_tracker is not None:
            out["boxes"].append([t.bbox.copy() for t in system.roi_tracker.tracks if t.alive])
    system.wait_for_mapping()
    launches = patch.LAUNCHES
    traj = system.camera_trajectory()
    lost = [e.frame_id for e in system.tracker.trajectory if e.lost]
    n = len(frames)
    path_m = scene.poses_world[n - 1][:3, 3] - scene.poses_world[0][:3, 3]
    system.shutdown()
    out.update(system=system, traj=traj, state=system.tracking_state, lost=lost,
               ate=_ate(scene, traj), path_m=float(np.linalg.norm(path_m)), launches=launches,
               host_ms=[t * 1e3 for t in system.frame_times],
               stages=PROFILER.summary()["stages"],
               tracks=list(objsys.all_tracks) if objsys is not None else [])
    expect = 4 * (n + out["obj_extractions"])
    print(f"System ({name}) on {device}, {n} frames: state {out['state']}, lost {lost}, ATE "
          f"{out['ate']:.4f} m over {out['path_m']:.2f} m, keyframes {system.map.n_keyframes()}, "
          f"object tracks {[(t.track_id, len(t.poses_cf)) for t in out['tracks']]}, in-mask "
          f"share of valid features {out['in_mask']}, patch_gather launches {launches} "
          f"({launches / n:g}/frame; {out['obj_extractions']} object extractions), "
          f"track_stereo ms (CUDA events) {[round(t, 1) for t in out['event_ms']]}")
    if not (out["state"] == TrackingState.OK and not lost and len(traj) == n):
        raise SystemExit(f"System ({name}): state {out['state']}, lost {lost}")
    if gate_ate and not out["ate"] < MAX_ATE_SHARE * out["path_m"]:
        raise SystemExit(f"System ({name}): ATE {out['ate']:.4f} m over {out['path_m']:.2f} m")
    if any(v >= MAX_IN_MASK_SHARE for v in out["in_mask"].values()):
        raise SystemExit(f"System ({name}): valid features inside the mask {out['in_mask']}")
    if cuda and launches != expect:
        raise SystemExit(f"System ({name}): expected {expect} patch_gather launches, got "
                         f"{launches}")
    return out


def _timed_runs(label: str, runs) -> dict:
    """ms per track_stereo over the runs after the first (the warm-up):
    the median of the CUDA-event times and of the host clock."""
    timed = [t for r in runs[1:] for t in r["event_ms"]]
    host = [t for r in runs[1:] for t in r["host_ms"]]
    ms = float(np.median(timed)) if timed else float("nan")
    print(f"System ({label}): median {ms:.3f} ms per track_stereo (CUDA events, {len(timed)} "
          f"calls of {len(runs) - 1} runs after a warm-up run; host clock "
          f"{float(np.median(host)):.3f} ms)")
    return dict(track_ms=ms, calls=len(timed), host_ms=float(np.median(host)))


def run_mode1(device="cuda") -> dict:
    """(m): mode 1 on MODE_FRAMES frames of tests/test_modes.py:17's scene at
    full width, (m1) the true instance mask on every frame, (m2)
    dynaslam_mode 1 with masks on DYNA_MASK_FRAMES only and the ROI tracker
    carrying the regions in between."""
    scene, frames, _ = render_slot_frames(MODE_SCENE, MODE_FRAMES)
    out = {}
    for key, fields, masks in (
            ("m1", {}, lambda i, inst: inst),
            ("m2", {"dynaslam_mode": 1},
             lambda i, inst: inst if i in DYNA_MASK_FRAMES else None)):
        runs = [drive_slot(f"{key}: mode 1{', dynaslam_mode 1' if fields else ''}",
                           slot_config(SLOTMode.DYNAMIC_SLAM, **fields), scene, frames, None,
                           device=device, masks=masks) for _ in range(SLOT_RUNS[key])]
        r = runs[-1]
        if key == "m2":
            carried = [k for k, b in enumerate(r["boxes"]) if b and k not in DYNA_MASK_FRAMES]
            print(f"System (m2): the ROI tracker carried boxes on frames {carried}: "
                  f"{[[np.round(b, 1).tolist() for b in bs] for bs in r['boxes']]}; valid "
                  f"features inside the true instance mask per frame {r['in_true_mask']} "
                  f"(not gated on carried frames: the carried box is a rectangle)")
            between = set(range(DYNA_MASK_FRAMES[0] + 1, DYNA_MASK_FRAMES[1]))
            if not between <= set(carried):
                raise SystemExit(f"System (m2): the ROI tracker carried the mask on frames "
                                 f"{carried}, not on every frame of {sorted(between)}")
        out[key] = dict(r, **_timed_runs(key, runs), runs=len(runs))
    return out


def run_mode2(device="cuda") -> dict:
    """(n): mode 2 on MODE_FRAMES frames of the same scene, the offline box
    of frame 0 registered with select_rois (tests/test_modes.py:69-87):
    gated on a track with at least MODE_FRAMES // 2 poses; the median
    object centre error printed beside the JAX package's on the same input
    (MODE2_REFERENCE_ERR_M); the ROI tracker's boxes on the first
    ROI_CPU_FRAMES frames against a tracker on the port's CPU path."""
    scene, frames, rows = render_slot_frames(MODE_SCENE, MODE_FRAMES)
    r0 = rows[(rows[:, 0] == 0) & (rows[:, 1] >= 0)][0]
    roi, gt_id = tuple(r0[5:9]), int(r0[1])
    runs = [drive_slot("n: mode 2, manual ROI", slot_config(SLOTMode.MANUAL_TRACKING), scene,
                       frames, rows, device=device, rois=[roi]) for _ in range(SLOT_RUNS["n"])]
    r = runs[-1]
    best = max(r["tracks"], key=lambda t: len(t.poses_cf), default=None)
    errs = []
    if best is not None:
        gt = next(o for o in scene.objects if o.track_id == gt_id)
        for f, T_co in best.poses_cf.items():
            gt_T_co = np.linalg.inv(scene.poses_world[f]) @ gt.poses_world[f]
            errs.append(float(np.linalg.norm(T_co[:3, 3] - gt_T_co[:3, 3])))
    err = float(np.median(errs)) if errs else float("inf")
    print(f"System (n): best track {best and best.track_id} with "
          f"{best and len(best.poses_cf)} poses (gate >= {MODE_FRAMES // 2}), object BA calls "
          f"{r['system']._object_system.ba_calls}; median object centre error {err:.4f} m "
          f"(per frame {[round(e, 3) for e in errs]}); the {MAX_OBJ_CENTER_ERR_M} m bound is "
          f"{'met' if err < MAX_OBJ_CENTER_ERR_M else 'NOT met, not gated'}: the JAX package "
          f"gives {MODE2_REFERENCE_ERR_M} m on the same input (ROADMAP Queue 3)")
    if best is None or len(best.poses_cf) < MODE_FRAMES // 2:
        raise SystemExit("System (n): the manual ROI produced no track of "
                         f"{MODE_FRAMES // 2} poses")
    cpu = MultiTracker2D(device="cpu")
    cpu.add(frames[0][0], roi)
    gaps = []
    for k in range(ROI_CPU_FRAMES):
        cpu.update(frames[k][0])   # the System updates from frame 0, after select_rois
        want = [t.bbox for t in cpu.tracks if t.alive]
        got = r["boxes"][k]
        if len(got) != len(want):
            raise SystemExit(f"System (n): frame {k}: {len(got)} ROI boxes on the card, "
                             f"{len(want)} on the CPU path")
        gaps += [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    print(f"System (n) ROI tracker, card vs CPU path over frames 0-{ROI_CPU_FRAMES - 1}: box "
          f"gaps {gaps} px (bound {MAX_ROI_GAP_PX})")
    if not max(gaps) <= MAX_ROI_GAP_PX:
        raise SystemExit("System (n): the ROI tracker's card and CPU boxes disagree")
    return dict(n=dict(r, **_timed_runs("n", runs), runs=len(runs), obj_err=err,
                       roi_gap=max(gaps)), roi=roi, frames=frames)


def compare_online_with_cpu(r: dict, frames) -> dict:
    """(o) on the card against the port's CPU path: frame 0's detector output
    (the same valid set and classes, boxes within MAX_DET_BOX_GAP_PX, scores
    within MAX_DET_SCORE_GAP), the ReID features of those boxes (within
    MAX_REID_GAP), and DeepSORT's ids on every frame, from a CPU detector
    and a CPU DeepSORT with a CPU ReID network over the same images."""
    cpu = System(online_config(), device="cpu")   # the same detection stages, built alike
    cpu_det, cpu_emb = cpu.detector, cpu.mot.embedder
    want = cpu_det.run(frames[0][0])
    got = r["raw"][0]
    ok = [d["class_id"] for d in got] == [d["class_id"] for d in want] and len(want) >= 1
    box_gap = max((float(np.abs(g["bbox"] - w["bbox"]).max()) for g, w in zip(got, want)),
                  default=0.0)
    score_gap = max((abs(g["score"] - w["score"]) for g, w in zip(got, want)), default=0.0)
    boxes = np.array([d["bbox"] for d in want])
    card_emb = r["system"].mot.embedder
    reid_gap = float(np.abs(card_emb(frames[0][0], boxes) - cpu_emb(frames[0][0], boxes)).max())
    mot = cpu.mot
    cpu_ids = [sorted(t["track_id"] for t in mot.update(cpu_det.run(f[0]), f[0]))
               for f in frames]
    print(f"System (o) card vs CPU path: frame 0 detections card {len(got)} / CPU {len(want)} "
          f"(classes {[d['class_id'] for d in got]}), box gap {box_gap:.3e} px (bound "
          f"{MAX_DET_BOX_GAP_PX}), score gap {score_gap:.3e} (bound {MAX_DET_SCORE_GAP}); ReID "
          f"features of {len(boxes)} boxes gap {reid_gap:.3e} (bound {MAX_REID_GAP}); DeepSORT "
          f"ids card {r['ids']} / CPU {cpu_ids}")
    if not (ok and box_gap <= MAX_DET_BOX_GAP_PX and score_gap <= MAX_DET_SCORE_GAP
            and reid_gap <= MAX_REID_GAP and cpu_ids == r["ids"]):
        raise SystemExit("System (o): the card and the CPU path disagree")
    return dict(det_box_gap=box_gap, det_score_gap=score_gap, reid_gap=reid_gap)


def run_mode3(device="cuda") -> dict:
    """(o): mode 3 with the bundled trained detector and ReID network on
    ONLINE_FRAMES frames of tests/test_modes.py:108's scene; gated on the
    state and at least one object track (:123-130), the ATE printed (the
    moving objects feed the camera's map until DeepSORT confirms them on
    the third frame); then against the CPU path."""
    scene, frames, _ = render_slot_frames(ONLINE_SCENE, ONLINE_FRAMES)
    runs = [drive_slot("o: mode 3, trained detector + DeepSORT + ReID", online_config(), scene,
                       frames, None, device=device, gate_ate=False)
            for _ in range(SLOT_RUNS["o"])]
    r = runs[-1]
    print(f"System (o): detections per frame {[len(d) for d in r['raw']]}, DeepSORT ids "
          f"{r['ids']}, stage medians (host clock, ms) "
          f"{ {k: round(v['median_ms'], 3) for k, v in r['stages'].items()} }")
    if not r["tracks"]:
        raise SystemExit("System (o): the online network produced no object track")
    if any(x["ids"] != r["ids"] for x in runs):
        raise SystemExit(f"System (o): DeepSORT ids differ between runs: "
                         f"{[x['ids'] for x in runs]}")
    gaps = compare_online_with_cpu(r, frames)
    return dict(o=dict(r, **_timed_runs("o", runs), **gaps, runs=len(runs)), frames=frames)


def _seeded_ultralytics_state_dict(seed: int = 0) -> dict:
    """A yolov5s state dict in the ultralytics key layout (model.<N>.conv.
    weight, ...), with seeded weights and BN statistics: the port's seeded
    YOLOv5(width=32, torch_pad=True) written out through the converter's
    own layer map."""
    from pointslot_torch.detect import convert as yconvert

    model = init_weights(YOLOv5(width=32, torch_pad=True), seed)
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mean.copy_(torch.randn(m.mean.shape, generator=g) * 0.1)
            m.var.copy_(torch.rand(m.var.shape, generator=g) + 0.5)
    sd = model.state_dict()
    out = {}

    def conv_bn(prefix, path):
        out[f"{prefix}.conv.weight"] = sd[f"{path}.Conv_0.weight"]
        for a, b in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                     ("running_var", "var")):
            out[f"{prefix}.bn.{a}"] = sd[f"{path}.BatchNorm_0.{b}"]

    for idx, name, n_bn in yconvert._LAYER_MAP:
        prefix = f"model.{idx}"
        if name.startswith("ConvBnSiLU"):
            conv_bn(prefix, name)
            continue
        for cv in range(2 if name.startswith("SPPF") else 3):
            conv_bn(f"{prefix}.cv{cv + 1}", f"{name}.ConvBnSiLU_{cv}")
        for i in range(n_bn or 0):
            for cv in range(2):
                conv_bn(f"{prefix}.m.{i}.cv{cv + 1}", f"{name}.Bottleneck_{i}.ConvBnSiLU_{cv}")
    for idx, sub, name in yconvert._HEADS:
        out[f"model.{idx}.{sub}.weight"] = sd[f"{name}.weight"]
        out[f"model.{idx}.{sub}.bias"] = sd[f"{name}.bias"]
    return out


def _conv_flops(model, x) -> int:
    """FLOPs of the convolutions and dense layers of one forward (2 x
    MACs), from the shapes; the elementwise BN, SiLU, ReLU, pools and adds
    are left out. (ConvBnSiLU runs its Conv's weight directly, so the hook
    sits on the block; a Conv called as a module is counted by its own.)"""
    flops = [0]

    def hook(mod, inp, out):
        w = mod.conv.weight if isinstance(mod, ConvBnSiLU) else mod.weight
        flops[0] += 2 * out.numel() * w[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (ConvBnSiLU, Conv, torch.nn.Linear))]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return flops[0]


def forward_detectors() -> list:
    """(label, Detector) on the card at three widths: the bundled w8 at
    320, DetectorConfig()'s default (width 16 at 640, seeded) and the
    yolov5s geometry (width 32, torch padding, at 640, built through
    from_ultralytics from a seeded state dict), each with its input."""
    dets = [("w8 @ 320 (bundled)", Detector(input_size=320, width=8, device="cuda")),
            ("w16 @ 640 (DetectorConfig default, seeded)", Detector(device="cuda")),
            ("w32 @ 640 (yolov5s geometry, torch_pad, from_ultralytics)",
             Detector.from_ultralytics(_seeded_ultralytics_state_dict(), device="cuda"))]
    dets[0][1].load_npz(str(W8_WEIGHTS))
    return [(label, det, torch.rand((1, 3, det.input_size, det.input_size),
                                    generator=torch.Generator().manual_seed(det.input_size)).cuda())
            for label, det in dets]


def count_detection_launches(forwards) -> dict:
    """Kernel launches per call of the detection stages and of the
    `forwards`, counted early in the process (torch.profiler counted too
    few kernels in the same calls late in this script: the ReID stage none
    at all), on the inputs of the timed calls: frame 0 of (o)'s scene
    through the w8 detector and the ReID network on its boxes, DeepSORT's
    update on them (host numpy), the ROI tracker on (n)'s frame 1 from
    frame 0's offline box."""
    system = System(online_config(), device="cuda")   # built as (o)'s
    det, emb = system.detector, system.mot.embedder
    img = synthetic.SyntheticRenderer(synthetic.make_scene(
        n_frames=ONLINE_FRAMES, **ONLINE_SCENE)).render(0)[0]
    raw = det.run(img)
    boxes = np.array([d["bbox"] for d in raw]).reshape(-1, 4)
    feats = emb(img, boxes)
    mot = DeepSort(system.cfg.detector, embedder=lambda image, b: feats)
    scene = synthetic.make_scene(n_frames=MODE_FRAMES, **MODE_SCENE)
    renderer = synthetic.SyntheticRenderer(scene)
    rows = synthetic.offline_detection_rows(scene)
    tracker = MultiTracker2D(device="cuda")
    tracker.add(renderer.render(0)[0], tuple(rows[(rows[:, 0] == 0) & (rows[:, 1] >= 0)][0][5:9]))
    frame1 = renderer.render(1)[0]
    out = {"detector": _count_kernels(lambda: det.run(img)),
           "reid": _count_kernels(lambda: emb(img, boxes)),
           "deepsort (host)": _count_kernels(lambda: mot.update(raw, img)),
           "roi tracker": _count_kernels(lambda: tracker.update(frame1))}
    for label, d, x in forwards:
        out[label] = _count_kernels(lambda: d.heads(x))
    system.shutdown()
    print(f"kernel launches per call, counted early (torch.profiler): {out}")
    return out


def detector_forwards(forwards, launches: dict) -> list:
    """The detector's forward alone on the card at the three widths of
    `forwards`, each timed per call with CUDA events (median of STAGE_CALLS
    after STAGE_WARMUP, the host's launches included) and as device time
    (a CUDA graph of STAGE_CALLS calls), with its launches (counted early),
    conv FLOPs, weight bytes and the share of the float32 peak that the
    device time reaches; the yolov5s forward again with TF32 convolutions,
    for what TF32 would save."""
    rows = []
    for label, det, x in forwards:
        s = det.input_size
        fwd = lambda: det.heads(x)   # noqa: E731
        ms = _event_ms(fwd)
        device_ms = _graph_ms(fwd, reps=STAGE_CALLS)
        flops = _conv_flops(det.model, x)
        wbytes = 4 * sum(v.numel() for v in det.model.state_dict().values())
        row = dict(label=label, input=s, width=det.model.width, ms=ms, device_ms=device_ms,
                   launches=launches[label], gflops=flops / 1e9, weight_bytes=wbytes,
                   f32_share=flops / F32_PEAK_FLOPS * 1e3 / device_ms)
        if det.model.width == 32:
            want = fwd()
            torch.backends.cudnn.allow_tf32 = True
            try:
                row["tf32_ms"] = _event_ms(fwd)
                row["tf32_device_ms"] = _graph_ms(fwd, reps=STAGE_CALLS)
                got = fwd()
                row["tf32_rel_gap"] = max(float((g - w).abs().max() / w.abs().max())
                                          for g, w in zip(got, want))
            finally:
                torch.backends.cudnn.allow_tf32 = False
        rows.append(row)
        print(f"detector forward {label}: {ms:.4f} ms per call (CUDA events, median of "
              f"{STAGE_CALLS}), {device_ms:.4f} ms of device time (a CUDA graph of "
              f"{STAGE_CALLS} calls), {row['launches']} kernel launches, {row['gflops']:.3f} GFLOP "
              f"of convolutions, {wbytes} weight bytes; the device time is "
              f"{row['f32_share']:.2%} of the {F32_PEAK_FLOPS / 1e12:g} TFLOP/s float32 peak"
              + (f"; with TF32 convolutions {row['tf32_ms']:.4f} ms per call, "
                 f"{row['tf32_device_ms']:.4f} ms of device time (heads within "
                 f"{row['tf32_rel_gap']:.2e} of max|head|)" if "tf32_ms" in row else ""))
    return rows


def time_online_stages(o: dict, n: dict, frames_o, frames_n, launches: dict) -> dict:
    """The stages of modes 2-3 alone on the card, each the median of
    STAGE_CALLS calls after STAGE_WARMUP (CUDA events around the call,
    host work included), with its kernel launches (counted early): the
    detector's run on frame 0, the ReID network on frame 0's detections,
    DeepSORT's update (host; the ReID features precomputed, on a fresh copy
    of the tracker state each call) and the ROI tracker's update."""
    import copy

    system = o["system"]
    det, mot = system.detector, system.mot
    img = frames_o[0][0]
    run = lambda: Detector.run(det, img)   # noqa: E731 (not the System's recording wrapper)
    raw = run()
    boxes = np.array([d["bbox"] for d in raw]).reshape(-1, 4)
    emb = mot.embedder
    feats = emb(img, boxes)
    out = {}
    out["detector"] = _event_ms(run)
    out["reid"] = _event_ms(lambda: emb(img, boxes))
    embedder, mot.embedder = mot.embedder, None
    state = copy.deepcopy(mot)
    mot.embedder = embedder

    def fresh():
        m = copy.deepcopy(state)
        m.embedder = lambda image, b: feats
        return m

    # the class's update: the System's instance carries a recording wrapper
    update = DeepSort.update
    out["deepsort (host)"] = _event_ms(lambda m: update(m, raw, img), setup=fresh)
    tracker = MultiTracker2D(device="cuda")
    tracker.add(frames_n[0][0], n["roi"])
    out["roi tracker"] = _event_ms(lambda: tracker.update(frames_n[1][0]))
    print("stage times on the card (CUDA events, median of "
          f"{STAGE_CALLS} after {STAGE_WARMUP}; kernel launches per call, counted early): "
          + ", ".join(f"{k} {ms:.4f} ms / {launches[k]} launches" for k, ms in out.items())
          + f"; {len(raw)} detections, {len(boxes)} ReID crops")
    return {k: dict(ms=ms, launches=launches[k]) for k, ms in out.items()}


def run_slot_modes(card: str, device="cuda", forwards=None, launches=None) -> dict:
    """Phases (m), (n), (o), then (on the card) the stage times and the
    detector `forwards` with the `launches` count_detection_launches
    counted for them early in the process."""
    t0 = time.perf_counter()
    out = run_mode1(device)
    print(f"phase (m) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n = run_mode2(device)
    out["n"] = n["n"]
    print(f"phase (n) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    o = run_mode3(device)
    out["o"], out["frames_o"] = o["o"], o["frames"]
    print(f"phase (o) took {time.perf_counter() - t0:.1f} s")
    if device == "cuda":
        t0 = time.perf_counter()
        out["stages"] = time_online_stages(out["o"], dict(n["n"], roi=n["roi"]), o["frames"],
                                           n["frames"], launches)
        out["forwards"] = detector_forwards(forwards, launches)
        print(f"stage and forward timings took {time.perf_counter() - t0:.1f} s")
    print(f"modes 1-3 summary on {card}: median ms per track_stereo (CUDA events) "
          + ", ".join(f"({k}) {out[k]['track_ms']:.3f} over {out[k]['calls']} calls"
                      for k in ("m1", "m2", "n", "o"))
          + "; patch_gather launches per frame "
          + ", ".join(f"({k}) {out[k]['launches'] / out[k]['frames']:g}"
                      for k in ("m1", "m2", "n", "o")))
    return out


# ---------------------------------------------------------------------------
# (p): the detector's and the ReID network's training, and the two-view
# initialiser
# ---------------------------------------------------------------------------

TRAIN_SIZE, TRAIN_STEPS_COMPARED = 320, 3   # (p1): input, steps held against the CPU
MAX_TRAIN_LOSS_REL = 1e-4        # card vs CPU step loss
# card vs CPU gradients, of each tensor's largest (tests/test_torch_train.py,
# tests/test_torch_train_reid.py: ReLU kinks in the ReID network)
YOLO_GRAD_REL, REID_GRAD_REL = 1e-3, 3e-2
MAX_TRAIN_STATS_GAP = 1e-5       # BN running statistics
TRAIN_PARAM_ATOL = 1e-6          # the Adam rule's floor
RECIPE_LOSS_FALL = 0.8           # tests/test_yolo_train.py:50, over the first and last 20 steps
RECIPE_WINDOW = 20
MIN_REID_MARGIN = 0.25           # tests/test_reid.py:46
REID_HELD_OUT = dict(n_ids=8, seed=101, crops=64, rng=0)   # tests/test_reid.py:34-36
RECALL_IOU = 0.5
LOW_CONF = 0.1                   # (p2)'s second recall: the recipe's 300 steps score lower
TWO_VIEW_N, TWO_VIEW_OUTLIERS, TWO_VIEW_K = 200, 20, 128   # tests/test_aux.py:25-47
# card vs CPU on the same draws: cuSOLVER's float32 eigen- and singular-value
# solves land farther from the exact pose than LAPACK's (on an NVIDIA H100 80GB
# HBM3 at 700 W: rotation error 1.81e-04 on the card, 1.4e-06 on the CPU path,
# T21 gap 4.97e-04)
MAX_TWO_VIEW_T21_GAP = 5e-3
TRAIN_PROFILE_STEPS = 3


def _flat_grads(model) -> dict:
    return {k: p.grad.detach().cpu().numpy() for k, p in model.named_parameters()}


def _network(trainer):
    """The trained module of a YoloTrainer or a ReIDTrainer."""
    return trainer.model if hasattr(trainer, "model") else trainer.net


def _copy_training_state(src, dst) -> None:
    """dst (a trainer on another device) takes src's weights, running
    statistics, softmax head and optimizer state."""
    _network(dst).load_state_dict(_network(src).state_dict())
    if hasattr(src, "head"):
        with torch.no_grad():
            dst.head.copy_(src.head)
    dst.opt.load_state_dict(copy.deepcopy(src.opt.state_dict()))


def _held_step_gaps(label: str, card_tr, cpu_tr, step, grad_rel: float, lr: float) -> dict:
    """One step on the card and one on the CPU path from the same state
    (cuDNN deterministic for the card's), held to the CPU's: the loss within
    MAX_TRAIN_LOSS_REL, each gradient within `grad_rel` of its tensor's
    largest, the BN statistics within MAX_TRAIN_STATS_GAP, and each
    parameter under the Adam rule of tests/test_torch_train.py: within
    TRAIN_PARAM_ATOL + 2 lr min(1, 2 max(d, 1e-6) / |g|) for a gradient gap d."""
    _copy_training_state(card_tr, cpu_tr)
    torch.backends.cudnn.deterministic = True
    try:
        loss_card = float(step(card_tr))
    finally:
        torch.backends.cudnn.deterministic = False
    loss_cpu = float(step(cpu_tr))
    net_card, net_cpu = _network(card_tr), _network(cpu_tr)
    g_card, g_cpu = _flat_grads(net_card), _flat_grads(net_cpu)
    p_card = {k: v.detach().cpu().numpy() for k, v in net_card.state_dict().items()}
    p_cpu = {k: v.detach().numpy() for k, v in net_cpu.state_dict().items()}
    if hasattr(card_tr, "head"):
        g_card["head"], g_cpu["head"] = card_tr.head.grad.cpu().numpy(), cpu_tr.head.grad.numpy()
        p_card["head"], p_cpu["head"] = card_tr.head.detach().cpu().numpy(), \
            cpu_tr.head.detach().numpy()
    out = dict(loss_rel=abs(loss_card - loss_cpu) / abs(loss_cpu), grad_rel=0.0, stats_gap=0.0,
               adam_ratio=0.0)
    for k, want in p_cpu.items():
        gap = np.abs(p_card[k] - want)
        if k not in g_cpu:
            out["stats_gap"] = max(out["stats_gap"], float(gap.max()))
            continue
        g_gap = np.abs(g_card[k] - g_cpu[k])
        out["grad_rel"] = max(out["grad_rel"], float(g_gap.max() / np.abs(g_cpu[k]).max()))
        bound = TRAIN_PARAM_ATOL + 2 * lr * np.minimum(
            1.0, 2 * np.maximum(g_gap, 1e-6) / np.maximum(np.abs(g_cpu[k]), 1e-30))
        out["adam_ratio"] = max(out["adam_ratio"], float((gap / bound).max()))
    ok = (out["loss_rel"] <= MAX_TRAIN_LOSS_REL and out["grad_rel"] <= grad_rel
          and out["stats_gap"] <= MAX_TRAIN_STATS_GAP and out["adam_ratio"] <= 1.0)
    print(f"({label}) card vs CPU step: loss {loss_card:.6f} / {loss_cpu:.6f} (rel gap "
          f"{out['loss_rel']:.2e}, bound {MAX_TRAIN_LOSS_REL}), gradients {out['grad_rel']:.2e} "
          f"of a tensor's largest (bound {grad_rel}), BN statistics {out['stats_gap']:.2e} (bound "
          f"{MAX_TRAIN_STATS_GAP}), parameters at {out['adam_ratio']:.3f} of the Adam rule's bound")
    if not ok:
        raise SystemExit(f"({label}): the card's training step disagrees with the CPU path's")
    return out


def _step_repeats(card_tr, step) -> bool:
    """Whether one card step (default cuDNN algorithms) from a state gives
    the same bits twice."""
    state = copy.deepcopy(card_tr.opt.state_dict())
    net = _network(card_tr)
    weights = {k: v.clone() for k, v in net.state_dict().items()}
    head = card_tr.head.detach().clone() if hasattr(card_tr, "head") else None
    outs = []
    for _ in range(2):
        net.load_state_dict(weights)
        if head is not None:
            with torch.no_grad():
                card_tr.head.copy_(head)
        card_tr.opt.load_state_dict(copy.deepcopy(state))
        step(card_tr)
        outs.append([v.clone() for v in net.state_dict().values()])
    return all(torch.equal(a, b) for a, b in zip(*outs))


def recipe_batch(imgs: torch.Tensor, frame_boxes, size: int = TRAIN_SIZE):
    """(p1)'s fixed batch: the recipe's first BATCH staged frames and their
    boxes, as the recipe builds a batch (no flip)."""
    from pointslot_torch.detect import train_synthetic as recipe

    boxes = np.zeros((recipe.BATCH, recipe.MAX_BOXES, 4), np.float32)
    classes = np.full((recipe.BATCH, recipe.MAX_BOXES), recipe.CAR, np.int64)
    n_boxes = np.zeros(recipe.BATCH, np.int64)
    for b in range(recipe.BATCH):
        bb = frame_boxes[b][:recipe.MAX_BOXES]
        boxes[b, :len(bb)] = bb
        n_boxes[b] = len(bb)
    return imgs[:recipe.BATCH].cpu(), (boxes, classes, n_boxes)


def _yolo_step(images_cpu, labels):
    """One YoloTrainer step on a fixed batch, on the trainer's device."""
    def step(trainer):
        return trainer.step_tensors(images_cpu.to(trainer.device), trainer.targets(*labels))[0]
    return step


def _reid_step(crops, ids):
    """One ReIDTrainer step on fixed crops, on the trainer's device."""
    x, y = torch.from_numpy(crops).permute(0, 3, 1, 2), torch.from_numpy(ids.astype(np.int64))

    def step(trainer):
        return trainer.step_tensors(x.to(trainer.device), y.to(trainer.device))[0]
    return step


def _train_flops(model, x) -> int:
    """FLOPs of one training step's convolutions and dense layers: the
    forward's (2 x MACs, _conv_flops) three times (forward, input gradient,
    weight gradient); the elementwise work and the optimizer are left out."""
    was = model.training
    model.eval()
    try:
        return 3 * _conv_flops(model, x)
    finally:
        model.train(was)


def profile_training_steps(imgs_cpu=None) -> dict:
    """Kernel launches and device busy ms per training step (torch.profiler,
    TRAIN_PROFILE_STEPS steps after one), counted early in the process as
    count_detection_launches does: the detector (bundled w8, input 320,
    batch 4, random images with the recipe's box count) and the ReID network
    (batch 64)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pointslot_torch.detect import reid as reid_mod
    from pointslot_torch.detect import train_reid

    g = torch.Generator().manual_seed(5)
    yolo = convert.yolo_trainer_from_flax(dict(np.load(W8_WEIGHTS)), input_size=TRAIN_SIZE,
                                          lr=2e-3, device="cuda")
    images = torch.rand((4, 3, TRAIN_SIZE, TRAIN_SIZE), generator=g)
    boxes = np.tile(np.array([[[100, 150, 60, 40], [220, 160, 90, 50]]], np.float32), (4, 1, 1))
    labels = (boxes, np.full((4, 2), 2, np.int64), np.full(4, 2, np.int64))
    net = convert.reid_from_flax(dict(np.load(reid_mod.ReIDEmbedder.bundled_weights_path())))
    reid = train_reid.ReIDTrainer(net, torch.randn((128, 64), generator=g) * 0.05, 1e-3, "cuda")
    crops, ids = train_reid.sample_crops(train_reid.make_identity_bank(64, 0),
                                         np.random.default_rng(0), 64)
    out = {}
    for name, tr, step in (("detector", yolo, _yolo_step(images, labels)),
                           ("reid", reid, _reid_step(crops, ids))):
        step(tr)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRAIN_PROFILE_STEPS):
                step(tr)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out[name] = dict(launches=len(kernels) / TRAIN_PROFILE_STEPS,
                         device_ms=sum(e.device_time_total for e in kernels) / 1e3
                         / TRAIN_PROFILE_STEPS)
    print(f"training steps, counted early (torch.profiler, {TRAIN_PROFILE_STEPS} steps): "
          + ", ".join(f"{k} {v['launches']:g} launches and {v['device_ms']:.4f} ms of device "
                      f"time per step" for k, v in out.items()))
    return out


def _iou(a, b) -> float:
    """IoU of two (x, y, w, h) boxes."""
    ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / max(a[2] * a[3] + b[2] * b[3] - inter, 1e-9)


def _recall(dets_per_frame, rows) -> float:
    """Share of the offline boxes of the frames matched by a detection at
    IoU >= RECALL_IOU."""
    hit = total = 0
    for i, dets in enumerate(dets_per_frame):
        for r in rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]:
            total += 1
            hit += any(_iou(d["bbox"], r[5:9]) >= RECALL_IOU for d in dets)
    return hit / max(total, 1)


def _reid_margin(net) -> float:
    """tests/test_reid.py:32-48's identity margin of `net` on the held-out
    bank: mean cosine of same-identity pairs less that of different ones."""
    from pointslot_torch.detect import train_reid

    h = REID_HELD_OUT
    crops, ids = train_reid.sample_crops(train_reid.make_identity_bank(h["n_ids"], h["seed"]),
                                         np.random.default_rng(h["rng"]), h["crops"])
    dev = next(net.parameters()).device
    with torch.no_grad():
        feats = net.eval()(torch.from_numpy(crops).permute(0, 3, 1, 2).to(dev)).cpu().numpy()
    sim = feats @ feats.T
    same = ids[:, None] == ids[None, :]
    off = ~np.eye(len(ids), dtype=bool)
    return float(sim[same & off].mean() - sim[~same].mean())


def _time_steps(step_fn, host_fn, calls: int = 20, warmup: int = 3) -> dict:
    """ms per training step (CUDA events around the whole step with its
    host work, median of `calls` after `warmup`) and the host part's ms
    (host clock, median)."""
    ms = _event_ms(step_fn, calls=calls, warmup=warmup)
    host = []
    for _ in range(calls):
        t0 = time.perf_counter()
        host_fn()
        host.append((time.perf_counter() - t0) * 1e3)
    return dict(ms=ms, host_ms=float(np.median(host)))


def two_view_scene():
    """tests/test_aux.py:25-37's correspondences (its rng fixture, seed 42)
    and the true T21."""
    rng = np.random.default_rng(42)
    n = TWO_VIEW_N
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(4, 20, n)], 1)
    from pointslot_torch.geometry import se3

    T21 = se3.se3_exp(torch.tensor([0.6, 0.05, 0.05, 0.01, 0.08, 0.01])).numpy()
    p1 = pts[:, :2] / pts[:, 2:3]
    pc2 = pts @ T21[:3, :3].T + T21[:3, 3]
    p2 = pc2[:, :2] / pc2[:, 2:3]
    p2[:TWO_VIEW_OUTLIERS] += rng.uniform(0.05, 0.2, size=(TWO_VIEW_OUTLIERS, 2))
    return p1.astype(np.float32), p2.astype(np.float32), T21


def run_two_view(device="cuda") -> dict:
    """(p4): reconstruct_two_view on tests/test_aux.py's scene, K = 128: the
    first call timed apart (cuSOLVER's start-up), then the warm median
    (CUDA events); card against the CPU path on the same draws (ok,
    used_homography, inliers equal, T21 within MAX_TWO_VIEW_T21_GAP); gated
    on that test's rules: ok, cos(t) > 0.99, rotation error < 0.02."""
    from pointslot_torch.geometry import two_view

    p1, p2, T21 = two_view_scene()
    args = [torch.from_numpy(p1), torch.from_numpy(p2), torch.ones(TWO_VIEW_N, dtype=torch.bool)]
    idx_h, idx_f = two_view.draw_index_sets(args[2], TWO_VIEW_K, 2)
    dev = [a.to(device) for a in args]
    solve = lambda: two_view.reconstruct_two_view_from_sets(*dev, idx_h, idx_f)  # noqa: E731
    t0 = time.perf_counter()
    res = solve()
    bool(res.ok)
    first_ms = (time.perf_counter() - t0) * 1e3
    warm_ms = _event_ms(solve) if device == "cuda" else float("nan")
    cpu = two_view.reconstruct_two_view_from_sets(*args, idx_h, idx_f)
    t_est = res.T21[:3, 3].cpu().numpy()
    cos = float(np.dot(t_est, T21[:3, 3]) / (np.linalg.norm(t_est) * np.linalg.norm(T21[:3, 3])))
    rot = float(np.abs(res.T21[:3, :3].cpu().numpy() @ T21[:3, :3].T - np.eye(3)).max())
    same = (bool(res.ok) == bool(cpu.ok)
            and bool(res.used_homography) == bool(cpu.used_homography)
            and torch.equal(res.inliers.cpu(), cpu.inliers))
    gap = float((res.T21.cpu() - cpu.T21).abs().max())
    print(f"(p4) two-view on {device}: ok {bool(res.ok)}, homography {bool(res.used_homography)}, "
          f"{int(res.inliers.sum())} inliers ({int(res.inliers[:TWO_VIEW_OUTLIERS].sum())} of the "
          f"{TWO_VIEW_OUTLIERS} outliers), cos(t) {cos:.6f} (gate > 0.99), rotation error "
          f"{rot:.2e} (gate < 0.02); card vs CPU path on the same draws: flags and inliers "
          f"{'equal' if same else 'DIFFER'}, T21 gap {gap:.2e} (bound {MAX_TWO_VIEW_T21_GAP}); "
          f"first call {first_ms:.1f} ms (host clock), warm {warm_ms:.4f} ms (CUDA events, "
          f"median of {STAGE_CALLS})")
    if not (bool(res.ok) and cos > 0.99 and rot < 0.02):
        raise SystemExit("(p4): two-view reconstruction misses tests/test_aux.py's gates")
    if not (same and gap <= MAX_TWO_VIEW_T21_GAP):
        raise SystemExit("(p4): the card's two-view reconstruction disagrees with the CPU path's")
    return dict(first_ms=first_ms, ms=warm_ms, t21_gap=gap, inliers=int(res.inliers.sum()))


def run_training(card: str, frames_o, train_profile: dict, device="cuda",
                 recipe_steps=None, reid_steps=None) -> dict:
    """Phase (p): (p1) card against CPU training steps of the detector and
    the ReID network, (p2) the detector recipe whole on the card, (p3) the
    ReID training whole on the card, (p4) two-view. `recipe_steps` and
    `reid_steps` cut (p2) and (p3) for a rehearsal on the CPU."""
    from pointslot_torch.detect import reid as reid_mod
    from pointslot_torch.detect import train as train_mod
    from pointslot_torch.detect import train_reid
    from pointslot_torch.detect import train_synthetic as recipe

    out = {}
    t0 = time.perf_counter()
    imgs, frame_boxes = recipe.training_set(TRAIN_SIZE, device)
    out["render_s"] = time.perf_counter() - t0
    print(f"(p) the recipe's training set: {len(frame_boxes)} frames rendered on host threads, "
          f"letterboxed and staged on {device} in {out['render_s']:.1f} s")

    # (p1) card vs CPU, from the bundled weights, on one fixed batch
    images_cpu, labels = recipe_batch(imgs, frame_boxes)
    bundled = dict(np.load(W8_WEIGHTS))
    yolo_card = convert.yolo_trainer_from_flax(bundled, TRAIN_SIZE, recipe.LR, device)
    yolo_cpu = convert.yolo_trainer_from_flax(bundled, TRAIN_SIZE, recipe.LR, "cpu")
    ystep = _yolo_step(images_cpu, labels)
    crops, ids = train_reid.sample_crops(train_reid.make_identity_bank(64, 0),
                                         np.random.default_rng(0), 64)
    head = torch.randn((128, 64), generator=torch.Generator().manual_seed(0)) * 0.05
    rnet = lambda: convert.reid_from_flax(  # noqa: E731
        dict(np.load(reid_mod.ReIDEmbedder.bundled_weights_path())))
    reid_card = train_reid.ReIDTrainer(rnet(), head, 1e-3, device)
    reid_cpu = train_reid.ReIDTrainer(rnet(), head, 1e-3, "cpu")
    rstep = _reid_step(crops, ids)
    held = {"detector": [], "reid": []}
    for _ in range(TRAIN_STEPS_COMPARED):
        held["detector"].append(_held_step_gaps("p1 detector", yolo_card, yolo_cpu, ystep,
                                                YOLO_GRAD_REL, recipe.LR))
        held["reid"].append(_held_step_gaps("p1 ReID", reid_card, reid_cpu, rstep,
                                            REID_GRAD_REL, 1e-3))
    repeats = {"detector": _step_repeats(yolo_card, ystep), "reid": _step_repeats(reid_card, rstep)}
    print(f"(p1) a card step from one state twice, default cuDNN algorithms: bit-equal "
          f"{repeats} (a finding, not gated)")
    bundled_margin = _reid_margin(rnet())
    del reid_cpu

    # the step's numbers: ms (CUDA events), the host part, FLOPs
    x = images_cpu.to(device)
    targets = lambda: yolo_card.targets(*labels)  # noqa: E731
    timing = {}
    if device == "cuda":
        timing["detector"] = _time_steps(lambda: yolo_card.step_tensors(x, targets()),
                                         lambda: train_mod.build_targets(*labels, TRAIN_SIZE))
        bank = train_reid.make_identity_bank(64, 0)
        rng = np.random.default_rng(1)
        timing["reid"] = _time_steps(lambda: reid_card.step(*train_reid.sample_crops(
            bank, rng, 64)), lambda: train_reid.sample_crops(bank, rng, 64))
        flops = {"detector": _train_flops(yolo_card.model, x),
                 "reid": _train_flops(reid_card.net, torch.from_numpy(crops).permute(
                     0, 3, 1, 2).to(device))}
        for k, t in timing.items():
            t.update(train_profile[k], flops=flops[k])
            t["f32_share"] = flops[k] / F32_PEAK_FLOPS * 1e3 / t["device_ms"]
            t["host_share"] = t["host_ms"] / t["ms"]
            print(f"(p) {k} training step on {card}: {t['ms']:.4f} ms per step (CUDA events, "
                  f"median of 20, host work included), of it {t['host_ms']:.4f} ms on the host "
                  f"({'build_targets' if k == 'detector' else 'sample_crops'}, "
                  f"{t['host_share']:.1%}); {t['device_ms']:.4f} ms of device time and "
                  f"{t['launches']:g} kernel launches per step (counted early); "
                  f"{t['flops'] / 1e9:.3f} GFLOP per step, {t['f32_share']:.2%} of the "
                  f"{F32_PEAK_FLOPS / 1e12:g} TFLOP/s float32 peak")
    del yolo_card, reid_card, yolo_cpu
    out.update(held=held, repeats=repeats, timing=timing)

    # (p2) the recipe, whole, from the port's seeded initialisation
    steps = recipe_steps or 300
    trainer = train_mod.YoloTrainer(input_size=TRAIN_SIZE, width=recipe.WIDTH, lr=recipe.LR,
                                    device=device)
    t0 = time.perf_counter()
    losses = recipe.train(trainer, imgs, frame_boxes, steps, log_every=100)
    out["recipe_s"] = time.perf_counter() - t0
    w = min(RECIPE_WINDOW, len(losses) // 2)
    first, last = float(losses[:w].mean()), float(losses[-w:].mean())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "synthetic_yolo_w8_card.npz"
    trainer.save_npz(str(path))
    det = Detector(input_size=TRAIN_SIZE, width=recipe.WIDTH, conf=0.3, device=device)
    det.load_npz(str(path))
    probe = torch.rand((1, 3, TRAIN_SIZE, TRAIN_SIZE),
                       generator=torch.Generator().manual_seed(3)).to(device)
    trainer.model.eval()
    with torch.no_grad():
        same = all(torch.equal(a, b) for a, b in zip(trainer.model(probe), det.heads(probe)))
    print(f"(p2) the recipe on {device}: {steps} steps in {out['recipe_s']:.1f} s, mean loss of "
          f"the first {w} steps {first:.4f}, of the last {w} {last:.4f} (gate < "
          f"{RECIPE_LOSS_FALL} x); saved to {path.name} and loaded back: heads bit-equal {same}")
    if not (last < RECIPE_LOSS_FALL * first and same):
        raise SystemExit("(p2): the recipe's loss did not fall, or its saved weights differ")
    scene = synthetic.make_scene(n_frames=ONLINE_FRAMES, **ONLINE_SCENE)
    rows = synthetic.offline_detection_rows(scene)
    cfg = online_config()
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector, weights_path=str(path)))
    run = drive_slot("p2: mode 3 with the card-trained detector", cfg, scene, frames_o, rows,
                     device=device, gate_ate=False)
    low = {}
    for name, weights in (("card", path), ("bundled", W8_WEIGHTS)):
        d = Detector(input_size=TRAIN_SIZE, width=recipe.WIDTH, conf=LOW_CONF, device=device)
        d.load_npz(str(weights))
        low[name] = [d.run(f[0]) for f in frames_o]
    out["recall"] = _recall(run["raw"], rows)
    out["bundled_recall"] = _recall([[x for x in dets if x["score"] >= 0.3]
                                     for dets in low["bundled"]], rows)
    out["recall_low"], out["bundled_recall_low"] = (_recall(low["card"], rows),
                                                    _recall(low["bundled"], rows))
    top = [round(max((x["score"] for x in dets), default=0.0), 3) for dets in low["card"]]
    print(f"(p2) recall of (o)'s offline boxes at IoU >= {RECALL_IOU} on its {len(frames_o)} "
          f"frames (seed 205 is one of the recipe's scenes: a training-set recall), at the "
          f"System's conf 0.3: card-trained {out['recall']:.3f}, bundled "
          f"{out['bundled_recall']:.3f}; at conf {LOW_CONF}: {out['recall_low']:.3f} and "
          f"{out['bundled_recall_low']:.3f}; the card-trained detector's top score per frame "
          f"{top}; object tracks {[(t.track_id, len(t.poses_cf)) for t in run['tracks']]} "
          f"(printed, not gated)")
    out.update(recipe_first=first, recipe_last=last, launches=run["launches"],
               frames=run["frames"])

    # (p3) the ReID training, whole, at its defaults
    t0 = time.perf_counter()
    net, acc = train_reid.train(steps=reid_steps or 800, device=device)
    out["reid_s"] = time.perf_counter() - t0
    out["reid_margin"], out["bundled_reid_margin"] = _reid_margin(net), bundled_margin
    print(f"(p3) ReID training on {device}: {reid_steps or 800} steps in {out['reid_s']:.1f} s "
          f"(last batch's id-accuracy {acc:.3f}); held-out identity margin "
          f"{out['reid_margin']:.4f} (gate > {MIN_REID_MARGIN}), the bundled weights' "
          f"{bundled_margin:.4f}")
    if not out["reid_margin"] > MIN_REID_MARGIN:
        raise SystemExit("(p3): the card-trained ReID network does not separate identities")

    # (p4)
    out["two_view"] = run_two_view(device)
    return out


# ---------------------------------------------------------------------------
# (q): the runner on the card: a KITTI sequence on disk, the batched
# frontend, the entry point as users start it, the viewers
# ---------------------------------------------------------------------------

RUNNER_FRAMES = 20              # (q1): (d)'s scene, written as a KITTI-tracking sequence
DP_BATCH = 4                    # (q2), on (q1)'s files in mode 0
MAX_DP_GAP_M = 1e-4             # (q2): --dp against no --dp, per frame
CLI_FRAMES, CLI_SAVE_AT = 8, 5  # (q3)
RUNNER_TIMEOUT_S = 300          # each runner subprocess


def write_kitti_fixture(root: Path, scene, frames) -> dict:
    """`frames` of `scene` as KITTI-tracking sequence 0000 under `root`:
    gray PNGs whose rows take the five filter types in turn (write_png),
    MOTS-style 16-bit instance PNGs (write_png16),
    label_02/0000.txt (Y at the box's bottom centre), pose_gt.txt and a
    reference-schema calib.yaml: the default camera, and of (d)'s
    thresholds those the schema can set. Returns {path: array written}."""
    from pointslot_torch.datasets.png16 import write_png, write_png16

    dirs = [root / "image_02" / "0000", root / "image_03" / "0000",
            root / "instances" / "0000", root / "label_02"]
    for d in dirs:
        d.mkdir(parents=True)
    written = {}
    for i, (left, right, _, inst) in enumerate(frames):
        name = f"{i:06d}.png"
        for d, img in zip(dirs[:2], (left, right)):
            write_png(d / name, np.asarray(img, np.uint8), cycle_filters=True)
            written[d / name] = np.asarray(img, np.uint8)
        raw = np.where(inst > 0, 2000 + inst.astype(np.int32), 0).astype(np.uint16)
        write_png16(dirs[2] / name, raw)
        written[dirs[2] / name] = raw
    (dirs[3] / "0000.txt").write_text(synthetic.kitti_label_text(scene, len(frames)))
    np.savetxt(root / "pose_gt.txt", np.stack([T[:3, :4].reshape(-1)
                                               for T in scene.poses_world[:len(frames)]]))
    cam = CameraConfig()
    keys = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                height=cam.height, bf=cam.bf, fps=cam.fps)
    (root / "calib.yaml").write_text(
        "%YAML:1.0\n" + "".join(f"Camera.{k}: {v}\n" for k, v in keys.items())
        + "SLOT.MODE: 4\nTracking.MinInitStereoFeatures: 350\n"
          "Object.EnInitDetObjORBFeaturesNum: 10\nObject.EbSetInitPositionByPoints: 0\n")
    return written


def check_decodes(root: Path, written: dict) -> dict:
    """Every PNG written decoded by the C helper and by the plain unfilter,
    held to the array written; then decode ms per 1242x375 image, gray (as
    written) and RGB (one written here), for both."""
    from pointslot_torch.datasets import png16

    grays = sorted(p for p in written if p.parent.parent.name.startswith("image_"))
    rgb = np.stack([written[grays[0]], written[grays[1]], written[grays[2]]], axis=-1)
    png16.write_png(root / "rgb.png", rgb, cycle_filters=True)
    cases = {**written, root / "rgb.png": rgb}
    for path, arr in cases.items():
        for plain in (False, True):
            got = png16.read_png(str(path), plain=plain)
            if got.dtype != arr.dtype or not np.array_equal(got, arr):
                raise SystemExit(f"(q1) {path} decoded {'plainly' if plain else 'by the C helper'} "
                                 f"differs from the array written")
    out = {}
    for what, paths in (("gray", grays[:8]), ("rgb", [root / "rgb.png"] * 5)):
        for plain in (False, True):
            ts = []
            for p in paths:
                t0 = time.perf_counter()
                png16.read_png(str(p), plain=plain)
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{what}_{'plain' if plain else 'c'}_ms"] = float(np.median(ts))
    print(f"(q1) {len(cases)} PNGs (rows filtered 0-4 in turn; gray, RGB and 16-bit instance "
          f"maps) decoded equal to the arrays written, by the C helper and by the plain "
          f"unfilter; decode ms per {rgb.shape[1]}x{rgb.shape[0]} image (host clock, median): "
          f"gray C {out['gray_c_ms']:.3f}, plain {out['gray_plain_ms']:.3f}; RGB C "
          f"{out['rgb_c_ms']:.3f}, plain {out['rgb_plain_ms']:.3f}")
    return out


def _kitti_frames_timed(run_mod, waits: list):
    """run._kitti_frames with the tracking loop's wait on the prefetch queue
    appended to `waits` per frame (seconds)."""
    inner = run_mod._kitti_frames

    def kitti_frames(args, cfg):
        frames, ctx = inner(args, cfg)

        def timed():
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(frames)
                    except StopIteration:
                        return
                    waits.append(time.perf_counter() - t0)
                    yield item
            finally:
                frames.close()
        return timed(), ctx
    return kitti_frames


def _runner(argv) -> tuple:
    """pointslot_torch.run.main in this process: (exit code, stdout, stderr)."""
    import contextlib
    import io

    from pointslot_torch import run as run_mod

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = run_mod.main([str(a) for a in argv])
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _translations(path: Path) -> np.ndarray:
    return np.loadtxt(path, ndmin=2).reshape(-1, 3, 4)[:, :, 3]


def run_runner_kitti(card: str, tmp: Path, scene, frames, device="cuda") -> dict:
    """(q1): mode 4 through pointslot_torch.run.main on the KITTI files."""
    from pointslot_torch import run as run_mod
    from pointslot_torch.datasets.kitti import KittiTrackingSequence

    root, out_dir = tmp / "kitti", tmp / "q1"
    t0 = time.perf_counter()
    written = write_kitti_fixture(root, scene, frames)
    print(f"(q1) wrote {len(written)} PNGs and the labels of {len(frames)} frames in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    decode = check_decodes(root, written)
    seq_rows = KittiTrackingSequence(str(root), "0000").rows
    det_frames = {int(f) for f in seq_rows[(seq_rows[:, 1] >= 0) & (seq_rows[:, 17] > 0), 0]}
    waits = []
    inner, run_mod._kitti_frames = run_mod._kitti_frames, _kitti_frames_timed(run_mod, waits)
    patch.LAUNCHES = 0
    try:
        rc, stdout, stderr = _runner([
            "--data", root, "--sequence", "0000", "--config", root / "calib.yaml",
            "--mode", "4", "--sync-mapping", "--no-loop", "--out", out_dir,
            "--platform", "cuda" if device == "cuda" else "cpu"])
        launches = patch.LAUNCHES
    finally:
        run_mod._kitti_frames = inner
    if rc != 0:
        raise SystemExit(f"(q1) the runner exited {rc}: {stderr[-2000:]}")
    traj = np.loadtxt(out_dir / "CameraTrajectory.txt", ndmin=2)
    stats = json.loads((out_dir / "stats.json").read_text())
    n = stats["frames"]
    det_dir = out_dir / "ObjectDetections"
    det_files = sorted(p.name for p in det_dir.iterdir())
    non_empty = sum(1 for f in det_files if (det_dir / f).read_text().strip())
    obj_files = sorted(p.name for p in out_dir.glob("CameraAndObjectTrajectory*.txt"))
    ev = stats.get("evaluation", {})
    ate = ev.get("camera", {}).get("ate", {}).get("rmse", float("inf"))
    objs = ev.get("objects", {})
    gate_ate = MAX_ATE_SHARE * SYSTEM_SPEED * len(frames)
    expected = 4 * (len(frames) + len(det_frames))
    ms = stats["wall_s"] / max(n, 1) * 1e3
    print(f"(q1) runner, mode 4, sync mapping, on {card}: exit {rc}, {traj.shape[0]} trajectory "
          f"rows of {traj.shape[1]} floats, {len(det_files)} ObjectDetections files "
          f"({non_empty} not empty), object trajectories {obj_files}, evaluation.camera ATE "
          f"{ate:.4f} m (gate {gate_ate:.2f} m), evaluation.objects {objs.get('n_matched')} "
          f"of {objs.get('n_gt')} GT rows matched (centre RMSE {objs.get('center_rmse')}); "
          f"patch_gather launches {launches} "
          f"(expected {expected}: 4 per frame + 4 per frame with detections, "
          f"{len(det_frames)})")
    wait_ms = [w * 1e3 for w in waits]
    print(f"(q1) on {card}: {ms:.3f} ms per frame, {stats['fps']:.3f} fps (runner wall clock, "
          f"decoding included); the tracking loop's wait on the prefetch queue per frame: "
          f"median {np.median(wait_ms):.3f} ms, first {wait_ms[0]:.3f} ms, max "
          f"{max(wait_ms):.3f} ms over {len(wait_ms)} frames")
    ok = (traj.shape == (len(frames), 12) and n == len(frames)
          and det_files == [f"{i:06d}.txt" for i in range(len(frames))] and non_empty >= 1
          and "CameraAndObjectTrajectory.txt" in obj_files and len(obj_files) >= 2
          and (out_dir / "ObjectPosesCF.txt").exists() and ate < gate_ate and objs)
    if not ok:
        raise SystemExit("(q1): the runner's artifacts or evaluation fail the gates")
    if device == "cuda" and launches != expected:
        raise SystemExit(f"(q1): {launches} patch_gather launches, expected {expected}")
    return dict(launches=launches, frames=n, ms=ms, fps=stats["fps"],
                wait_ms=float(np.median(wait_ms)), wait_first_ms=wait_ms[0],
                wait_max_ms=float(max(wait_ms)), ate=ate, decode=decode)


def run_runner_dp(card: str, tmp: Path, root: Path, n: int, device="cuda") -> dict:
    """(q2): mode 0 on (q1)'s `n` KITTI frames under `root`, with --dp
    DP_BATCH and without; the batched frames held to the single-pair
    frontend's. (Files, not --synthetic: the synthetic renderer costs
    about 0.7 s per full-width frame on the host, inside the runner's
    loop.)"""
    recorded = []
    batch = StereoFrontend.batch

    def recording(fe, lefts, rights):
        sf = batch(fe, lefts, rights)
        recorded.append((fe, lefts, rights, sf))
        return sf

    platform = "cuda" if device == "cuda" else "cpu"
    common = ["--data", root, "--sequence", "0000", "--config", root / "calib.yaml",
              "--mode", "0", "--sync-mapping", "--no-loop", "--platform", platform]
    runs = {}
    for name, extra in (("dp", ["--dp", DP_BATCH]), ("single", [])):
        StereoFrontend.batch = recording
        patch.LAUNCHES = 0
        try:
            rc, _, stderr = _runner(common + ["--out", tmp / f"q2_{name}"] + extra)
            launches = patch.LAUNCHES
        finally:
            StereoFrontend.batch = batch
        if rc != 0:
            raise SystemExit(f"(q2) the runner ({name}) exited {rc}: {stderr[-2000:]}")
        stats = json.loads((tmp / f"q2_{name}" / "stats.json").read_text())
        runs[name] = dict(launches=launches, frames=stats["frames"],
                          ms=stats["wall_s"] / stats["frames"] * 1e3)
    pairs = sum(len(r[1]) for r in recorded)
    differ = []
    for fe, lefts, rights, sf in recorded:
        for i in range(len(lefts)):
            one = fe(lefts[i], rights[i])
            differ += [n for n, b, s in zip(one._fields, sf, one) if not torch.equal(b[i], s)]
    gap = float(np.abs(_translations(tmp / "q2_dp" / "CameraTrajectory.txt")
                       - _translations(tmp / "q2_single" / "CameraTrajectory.txt")).max())
    print(f"(q2) mode 0, (q1)'s {n} frames, on {card}: --dp {DP_BATCH} "
          f"{runs['dp']['ms']:.3f} ms per frame, {runs['dp']['launches']} patch_gather launches; "
          f"without --dp {runs['single']['ms']:.3f} ms per frame, {runs['single']['launches']} "
          f"launches; {pairs} batched pairs against the single-pair frontend: fields that "
          f"differ {sorted(set(differ))}; largest camera translation difference between the two "
          f"trajectories {gap:.3e} m (gate {MAX_DP_GAP_M})")
    if pairs != n or differ:
        raise SystemExit(f"(q2): {pairs} batched pairs, fields differing {sorted(set(differ))}")
    if device == "cuda" and any(r["launches"] != 4 * n for r in runs.values()):
        raise SystemExit(f"(q2): expected {4 * n} patch_gather launches per run, got "
                         f"{[r['launches'] for r in runs.values()]}")
    if not gap <= MAX_DP_GAP_M:
        raise SystemExit(f"(q2): --dp and no --dp trajectories differ by {gap:.3e} m")
    return dict(runs, gap=gap)


def time_batch(card: str, frames) -> dict:
    """StereoFrontend.batch ms per pair on the first DP_BATCH full-width
    pairs of `frames` against the single-pair frontend (CUDA events,
    medians of 10 after 2)."""
    pairs = [f[:2] for f in frames[:DP_BATCH]]
    cam = CameraConfig()
    fe = StereoFrontend(cam.height, cam.width, cam.fx, cam.bf, device="cuda")
    lefts = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    rights = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    out = {"batch_ms_per_pair": _event_ms(lambda: fe.batch(lefts, rights), 10, 2) / DP_BATCH,
           "single_ms": _event_ms(lambda: [fe.run(lefts[i], rights[i])
                                           for i in range(DP_BATCH)], 10, 2) / DP_BATCH}
    print(f"(q2) StereoFrontend.batch on {card}: {out['batch_ms_per_pair']:.3f} ms per pair "
          f"over {DP_BATCH} pairs, the single-pair frontend {out['single_ms']:.3f} ms per pair "
          f"(CUDA events, host launches included)")
    return out


def run_runner_cli(card: str, tmp: Path, device="cuda") -> dict:
    """(q3): `python -m pointslot_torch.run` as users start it: a run of
    CLI_FRAMES frames beside a run that saves a checkpoint after
    CLI_SAVE_AT frames, then a resume from that checkpoint (beside the
    first run if it is still going)."""
    platform = [] if device == "cuda" else ["--platform", "cpu"]
    base = [sys.executable, "-m", "pointslot_torch.run", "--synthetic", str(CLI_FRAMES),
            "--mode", "0", "--no-loop", *platform]
    ckpt = tmp / "q3.npz"
    cwd = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    procs = {"plain": subprocess.Popen(base + ["--out", str(tmp / "q3_plain")], cwd=cwd,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             "save": subprocess.Popen(base + ["--out", str(tmp / "q3_save"), "--max-frames",
                                              str(CLI_SAVE_AT), "--save-checkpoint", str(ckpt)],
                                      cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)}
    results = {}
    try:
        for name in ("save", "resume", "plain"):
            if name == "resume":     # beside the plain run, once the checkpoint is saved
                procs[name] = subprocess.Popen(
                    base + ["--out", str(tmp / "q3_resume"), "--resume", str(ckpt)], cwd=cwd,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            out, err = procs[name].communicate(timeout=RUNNER_TIMEOUT_S)
            results[name] = (procs[name].returncode, out, err)
    except subprocess.TimeoutExpired:
        raise SystemExit(f"(q3) a runner process took over {RUNNER_TIMEOUT_S} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    summary = {}
    for name, (rc, out, err) in results.items():
        lines = [ln for ln in out.splitlines() if ln.strip()]
        try:
            stats = json.loads(lines[-1]) if len(lines) == 1 else None
        except ValueError:
            stats = None
        on_disk = (tmp / f"q3_{name}" / "stats.json").exists()
        summary[name] = dict(rc=rc, stdout_lines=len(lines), stats_json=on_disk,
                             frames=stats and stats.get("frames"),
                             keyframes=stats and stats.get("n_keyframes"))
        if not (rc == 0 and stats is not None and on_disk):
            raise SystemExit(f"(q3) python -m pointslot_torch.run ({name}) exited {rc} with "
                             f"{len(lines)} stdout lines: {err[-2000:]}")
    print(f"(q3) python -m pointslot_torch.run on {card}, three processes in {seconds:.1f} s: "
          f"{summary}; checkpoint {ckpt.stat().st_size} bytes")
    want = {"plain": CLI_FRAMES, "save": CLI_SAVE_AT, "resume": CLI_FRAMES}
    if (any(summary[k]["frames"] != v for k, v in want.items())
            or not summary["resume"]["keyframes"]):
        raise SystemExit(f"(q3): frames {summary}")
    return dict(summary, seconds=seconds)


def run_viewers(card: str, tmp: Path, device="cuda") -> dict:
    """(q4): --viz and --live where PIL imports; else each flag stops the
    runner before the first frame with the reason."""
    import importlib.util

    platform = "cuda" if device == "cuda" else "cpu"
    base = ["--synthetic", 2, "--mode", "0", "--no-loop", "--platform", platform]
    have_pil = importlib.util.find_spec("PIL") is not None
    out = {"pil": have_pil}
    import socket

    with socket.socket() as sock:         # a free port on this host for --live
        sock.bind(("127.0.0.1", 0))
        live_port = sock.getsockname()[1]
    for flag, value in (("--viz", 1), ("--live", live_port)):
        rc, _, err = _runner(base + ["--out", tmp / f"q4{flag[2:]}", flag, value])
        out[flag] = rc
        if have_pil:
            made = (tmp / "q4viz" / "map_topdown.png").exists() if flag == "--viz" else True
            if rc != 0 or not made:
                raise SystemExit(f"(q4) {flag} with PIL: exit {rc}: {err[-2000:]}")
        elif rc == 0 or "PIL" not in err:
            raise SystemExit(f"(q4) {flag} without PIL: exit {rc}, stderr {err[-500:]!r}")
        print(f"(q4) {flag} on {card}: PIL {'present' if have_pil else 'missing'}, exit {rc}"
              + ("" if have_pil else f", stderr: {err.strip().splitlines()[-1]}"))
    return out


def run_runner(card: str, scene, frames, device="cuda") -> dict:
    """Phase (q): (q1) the runner in mode 4 on (d)'s frames written as a
    KITTI-tracking sequence, (q2) --dp against no --dp, (q3) the entry
    point in subprocesses with a checkpoint and a resume, (q4) the
    viewers' flags."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_q_") as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        q1 = run_runner_kitti(card, tmp, scene, frames[:RUNNER_FRAMES], device)
        print(f"phase (q1) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        q2 = run_runner_dp(card, tmp, tmp / "kitti", q1["frames"], device)
        if device == "cuda":
            q2.update(time_batch(card, frames))
        print(f"phase (q2) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        q3 = run_runner_cli(card, tmp, device)
        q4 = run_viewers(card, tmp, device)
        print(f"phase (q3, q4) took {time.perf_counter() - t0:.1f} s")
    return dict(q1=q1, q2=q2, q3=q3, q4=q4)


# ---------------------------------------------------------------------------
# (r) the mesh on logical shards of the one card, (s) pipeline stages
# ---------------------------------------------------------------------------

MESH_SHARDS, MESH_SHAPE = 4, (2, 2)   # (r1), (r3): logical shards of cuda:0
STEP_FRAMES, STEP_OBJECTS = 2, 2      # (r1): make_example_inputs' frames and objects
STEP_P_CAP, STEP_L_CAP = 32, 8192     # (r1): the BA caps of mode 0
STEP_E_CAP = 8 * STEP_L_CAP           # (r1): 16 observation slots per point
MAX_STEP_OBJ_GAP = 1e-5               # (r1): object poses, sharded vs one batched LM
MAX_STEP_POSE_GAP, MAX_STEP_POINT_GAP = 1e-3, 5e-3   # tests/test_parallel.py:77-86
SHARDED_PAIRS, SHARDED_SHARDS = 4, 2  # (r2): (q1)'s first 4 KITTI frames over 2 shards
PIPE_CPU_FRAMES = 20                  # (s2): the first 20 of (a)'s 40 frames


def shard_devices(device: str, n: int) -> list:
    return [torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")] * n


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def perturb_problem(prob, seed: int = 42):
    """The example BA problem's free poses and its points moved as
    tests/test_parallel.py:28-31 moves them (its observations are exact, so
    the solve has work to do)."""
    rng = np.random.default_rng(seed)
    poses = prob.poses.cpu().numpy().copy()
    poses[1:, :3, 3] += rng.normal(scale=0.05, size=(poses.shape[0] - 1, 3))
    points = prob.points.cpu().numpy()
    points = points + rng.normal(scale=0.05, size=points.shape).astype(np.float32)
    dev = prob.points.device
    return prob._replace(poses=torch.from_numpy(poses).to(dev),
                         points=torch.from_numpy(points).to(dev))


def run_step(card: str, device="cuda") -> dict:
    """(r1) DistributedSlotStep at full width with the default ORB on a
    (2, 2) mesh of logical shards: frames against ``batch``, object poses
    against one batched ``pose_optimize``, the sharded BA against the local
    one and against itself solved again; the phases timed against their
    unsharded forms (CUDA events)."""
    cam = CameraConfig()
    mesh = make_mesh(devices=shard_devices(device, MESH_SHARDS), shape=MESH_SHAPE)
    step = DistributedSlotStep(mesh, cam.height, cam.width, orb_config=ORBConfig())
    lefts, rights, obj_T, obj_edges, prob = make_example_inputs(
        mesh, cam.height, cam.width, n_frames=STEP_FRAMES, n_objects=STEP_OBJECTS,
        P_cap=STEP_P_CAP, L_cap=STEP_L_CAP, E_cap=STEP_E_CAP)
    prob = perturb_problem(prob)
    kw = dict(step.cam, stage_iters=(3,), use_huber_stages=(False,))
    patch.LAUNCHES = 0
    t0 = time.perf_counter()
    frames, obj, (ba_poses, ba_points) = step(lefts, rights, obj_T, obj_edges, prob)
    _sync(device)
    first_s = time.perf_counter() - t0
    launches = patch.LAUNCHES
    want = step.frontend.batch(lefts, rights)
    frames_equal = all(torch.equal(a, b) for a, b in zip(frames, want))
    one = pose_opt.pose_optimize(obj_T, *obj_edges, **step.cam, stages=2, iters_per_stage=5)
    local = local_ba.bundle_adjust(prob, **kw)
    again = distributed_bundle_adjust(prob, mesh, **kw)
    pv = prob.point_valid
    out = dict(name="r1", frames=STEP_FRAMES, launches=launches, first_s=first_s,
               frames_equal=frames_equal,
               obj_gap=float((obj.T - one.T).abs().max()),
               pose_gap=float((ba_poses - local.poses).abs().max()),
               point_gap=float((ba_points[pv] - local.points[pv]).abs().max()),
               repeats=bool(torch.equal(again.poses, ba_poses)
                            and torch.equal(again.points, ba_points)),
               n_obs=int(prob.obs_valid.sum()))
    if device == "cuda":
        sharded_fe = lambda: step.frontend.batch_sharded(lefts, rights, mesh)  # noqa: E731
        out["ms"] = {
            "step": _event_ms(lambda: step(lefts, rights, obj_T, obj_edges, prob), 3, 1),
            "frontend sharded": _event_ms(sharded_fe, 5, 1),
            "frontend batch": _event_ms(lambda: step.frontend.batch(lefts, rights), 5, 1),
            "objects sharded": _event_ms(lambda: step.solve_objects(obj_T, obj_edges), 5, 1),
            "objects batched": _event_ms(lambda: pose_opt.pose_optimize(
                obj_T, *obj_edges, **step.cam, stages=2, iters_per_stage=5), 5, 1),
            "BA sharded": _event_ms(lambda: distributed_bundle_adjust(prob, mesh, **kw), 5, 1),
            "BA local": _event_ms(lambda: local_ba.bundle_adjust(prob, **kw), 5, 1)}
    print(f"(r1) DistributedSlotStep on {device}, {MESH_SHAPE} mesh of logical shards, "
          f"{cam.width}x{cam.height}, {STEP_FRAMES} frames, {STEP_OBJECTS} objects, BA "
          f"{STEP_P_CAP} poses x {STEP_L_CAP} points ({out['n_obs']} observations): frames "
          f"bit-equal to batch {frames_equal}, object pose gap {out['obj_gap']:.3e} (bound "
          f"{MAX_STEP_OBJ_GAP}), BA pose gap {out['pose_gap']:.3e} (bound {MAX_STEP_POSE_GAP}), "
          f"point gap {out['point_gap']:.3e} (bound {MAX_STEP_POINT_GAP}), sharded BA repeats "
          f"bit for bit {out['repeats']}, patch_gather launches {launches}, first step "
          f"{first_s:.1f} s; ms (CUDA events) {out.get('ms')}")
    bad = []
    if not (frames_equal and out["repeats"]):
        bad.append("frames or the repeated BA not bit-equal")
    if not (out["obj_gap"] <= MAX_STEP_OBJ_GAP and out["pose_gap"] <= MAX_STEP_POSE_GAP
            and out["point_gap"] <= MAX_STEP_POINT_GAP):
        bad.append("a gap over its bound")
    if device == "cuda" and launches != 4 * STEP_FRAMES:
        bad.append(f"{launches} patch_gather launches, expected {4 * STEP_FRAMES}")
    if bad:
        raise SystemExit("(r1): " + "; ".join(bad))
    return out


def run_sharded_batch(card: str, frames, device="cuda") -> dict:
    """(r2) StereoFrontend.batch_sharded over 2 logical shards on (q1)'s
    first 4 frames (the arrays its PNGs decode to) against ``batch``."""
    cam = CameraConfig()
    fe = StereoFrontend(cam.height, cam.width, cam.fx, cam.bf, device=device)
    mesh = make_mesh(devices=shard_devices(device, SHARDED_SHARDS), shape=(SHARDED_SHARDS, 1))
    lefts = np.stack([f[0] for f in frames[:SHARDED_PAIRS]])
    rights = np.stack([f[1] for f in frames[:SHARDED_PAIRS]])
    patch.LAUNCHES = 0
    got = fe.batch_sharded(lefts, rights, mesh)
    launches = patch.LAUNCHES
    equal = all(torch.equal(a, b) for a, b in zip(got, fe.batch(lefts, rights)))
    out = dict(name="r2", frames=SHARDED_PAIRS, launches=launches, equal=equal)
    if device == "cuda":
        lt, rt = torch.from_numpy(lefts).cuda(), torch.from_numpy(rights).cuda()
        out["sharded_ms_per_pair"] = _event_ms(lambda: fe.batch_sharded(lt, rt, mesh), 5, 1) \
            / SHARDED_PAIRS
        out["batch_ms_per_pair"] = _event_ms(lambda: fe.batch(lt, rt), 5, 1) / SHARDED_PAIRS
    print(f"(r2) batch_sharded on {device} over {SHARDED_SHARDS} shards, {SHARDED_PAIRS} "
          f"pairs: bit-equal to batch {equal}, patch_gather launches {launches}; ms per pair "
          f"sharded {out.get('sharded_ms_per_pair')}, batch {out.get('batch_ms_per_pair')} "
          f"(CUDA events)")
    if not equal or (device == "cuda" and launches != 4 * SHARDED_PAIRS):
        raise SystemExit(f"(r2): equal {equal}, {launches} launches for {SHARDED_PAIRS} pairs")
    return out


def run_loop_on_mesh(card: str, scene, frames, f: dict, device="cuda") -> dict:
    """(r3) (f)'s run with a 4-shard mesh attached: (f)'s gates, and both
    sharded engines counted."""
    mesh = make_mesh(devices=shard_devices(device, MESH_SHARDS), shape=MESH_SHAPE)
    with runtime.use_mesh(mesh):
        r3 = run_loop("r3: loop closing on a 4-shard mesh", scene, frames, device=device)
    counters = {k: PROFILER.counters.get(k, 0) for k in ("essential_graph_distributed",
                                                          "gba_distributed")}
    r3["counters"] = counters
    check_loop_run(r3)
    if device == "cuda" and r3["launches"] != 4 * len(frames):
        raise SystemExit(f"System (r3): expected {4 * len(frames)} patch_gather launches")
    if not all(v >= 1 for v in counters.values()):
        raise SystemExit(f"System (r3): the sharded engines did not run: {counters}")
    print(f"(r3) against (f) on {card}: median ms per track_stereo {r3['track_ms']:.3f} vs "
          f"{f['track_ms']:.3f}; ms per loop event (CUDA events): correction "
          f"{r3['steps'].get('correction')} vs {f['steps'].get('correction')}, essential graph "
          f"{r3['steps'].get('essential graph')} vs {f['steps'].get('essential graph')}, GBA "
          f"solve {r3['steps'].get('GBA solve')} vs {f['steps'].get('GBA solve')}; counters "
          f"{counters}")
    return r3


def run_mesh(card: str, runner_frames, loop: dict, device="cuda") -> dict:
    """Phase (r): (r1) the step, (r2) batch_sharded, (r3) loop closing on a
    mesh of logical shards of the one card."""
    t0 = time.perf_counter()
    r1 = run_step(card, device)
    r2 = run_sharded_batch(card, runner_frames, device)
    print(f"phase (r1, r2) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r3 = run_loop_on_mesh(card, loop["scene"], loop["frames"], loop["f"], device)
    print(f"phase (r3) took {time.perf_counter() - t0:.1f} s")
    return dict(r1=r1, r2=r2, r3=r3)


def run_pipelined(name: str, scene, frames, platform: str, a_ate: float,
                  device="cuda") -> dict:
    """(a)'s configuration with loop closing on and pipeline_stages, the
    mapping stage on `platform`: tests/test_pipeline_stages.py:99-135's
    gates."""
    cfg = SystemConfig(runtime=RuntimeConfig(profile=True, pipeline_stages=True,
                                             pipeline_child_platform=platform))
    system = System(cfg, device=device)
    patch.LAUNCHES = 0
    for i, (left, right) in enumerate(frames):
        system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    launches = patch.LAUNCHES
    traj = system.camera_trajectory()
    t0 = time.perf_counter()
    try:
        stats = system.shutdown()
    except RuntimeError as e:
        raise SystemExit(f"System ({name}): {e}")
    hi = system.map.max_points // 2
    out = dict(name=name, frames=len(frames), launches=launches, ate=_ate(scene, traj),
               traj_len=len(traj), drain_s=time.perf_counter() - t0,
               packets=stats["pipeline_packets"], bytes_sent=stats["pipeline_bytes_sent"],
               bytes_received=stats["pipeline_bytes_received"],
               high_points=int(system.map.pt_valid[hi:].sum()),
               keyframes=stats["n_keyframes"],
               track_ms=float(np.median([t * 1e3 for t in system.frame_times])))
    print(f"System ({name}) on {device}, stage on {platform or 'the System device'}, "
          f"{len(frames)} frames: ATE {out['ate']:.4f} m (bound "
          f"{max(2 * a_ate, 0.15):.4f}), {out['traj_len']} trajectory rows, keyframes "
          f"{out['keyframes']}, packets {out['packets']}, bytes sent {out['bytes_sent']}, "
          f"received {out['bytes_received']}, points in the stage's half {out['high_points']}, "
          f"patch_gather launches {launches}, median {out['track_ms']:.3f} ms per "
          f"track_stereo (host clock), shutdown drained in {out['drain_s']:.1f} s")
    bad = []
    if not (out["packets"] >= 1 and out["bytes_received"] > 0 and out["high_points"] > 0):
        bad.append("the stage exchanged nothing")
    if out["traj_len"] < len(frames) - 2:
        bad.append(f"{out['traj_len']} trajectory rows")
    if not out["ate"] < max(2 * a_ate, 0.15):
        bad.append(f"ATE {out['ate']:.4f} m")
    if device == "cuda" and launches != 4 * len(frames):
        bad.append(f"{launches} patch_gather launches, expected {4 * len(frames)}")
    if bad:
        raise SystemExit(f"System ({name}): " + "; ".join(bad))
    return out


def run_pipeline_stages(card: str, scene, frames, a: dict, device="cuda") -> dict:
    """Phase (s): (s1) the stage in a second context on the System's card,
    (s2) on the CPU (the default) on the first 20 frames."""
    t0 = time.perf_counter()
    s1 = run_pipelined("s1: pipeline stages, stage on the card", scene, frames, "", a["ate"],
                       device)
    print(f"phase (s1) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    a_ate = _ate(scene, a["traj"], frames=set(range(PIPE_CPU_FRAMES)))
    s2 = run_pipelined("s2: pipeline stages, stage on the CPU", scene, frames[:PIPE_CPU_FRAMES],
                       "cpu", a_ate, device)
    print(f"phase (s2) took {time.perf_counter() - t0:.1f} s")
    print(f"(s) on {card}: median ms per track_stereo (s1) {s1['track_ms']:.3f}, (s2) "
          f"{s2['track_ms']:.3f}, (a) {a['track_ms']:.3f}")
    return dict(s1=s1, s2=s2)


# ---------------------------------------------------------------------------
# (t): the flat multi-image frontend, FusedFrameStep.multi, the gated ORB
# call and the stage timings
# ---------------------------------------------------------------------------

FLAT_PAIRS, FLAT_BATCHES = 4, 2       # (t1), (t2): B = 4 pairs (G = 8 images), twice
FLAT_SITES = ("flat ORB", "flat right SAD", "flat fine")   # the flat batch's gathers
MULTI_FRAMES = 4                      # (t3): S frames of phase 4's sequence
MAX_FLAT_ANGLE_GAP = 1e-4             # rad, tests/test_torch_orb.py:86
MAX_FLAT_DESC_FLIPS = 1e-3            # of the valid bits, tests/test_torch_orb.py:84
MAX_FLAT_DEPTH_FLIPS = 5e-3           # depth validity, tests/test_torch_fused.py:70
GATE_BOX = (100, 300, 300, 900)       # (t4): rows, cols of the allowed region
STAGE_N = 10                          # (t5): timeit_ms's n


def record_flat_sites(fe, lefts: torch.Tensor, rights: torch.Tensor) -> dict:
    """The three patch gathers of one flat batch, as batch_flat makes them:
    {site: (planes, xyl)}, in call order."""
    calls = []
    launch = patch.gather_patches_cuda

    def record(planes, xyl):
        calls.append((tuple(planes), xyl))
        return launch(planes, xyl)

    patch.gather_patches_cuda = record
    try:
        fe.batch_flat(lefts, rights)
    finally:
        patch.gather_patches_cuda = launch
    torch.cuda.synchronize()
    if len(calls) != len(FLAT_SITES):
        raise SystemExit(f"expected {len(FLAT_SITES)} patch gathers per flat batch, got "
                         f"{len(calls)}")
    return dict(zip(FLAT_SITES, calls))


def check_flat_gather(fe, lefts: torch.Tensor, rights: torch.Tensor) -> list:
    """(t1) The multi-image gather at the flat batch's three call sites
    (recorded from batch_flat on B pairs) and on edge and out-of-range rows:
    exact against its plain version, timed warm and L2-cold beside its
    bytes bound and the indexing yardstick on a prebuilt canvas."""
    sites = record_flat_sites(fe, lefts, rights)
    planes, xyl0 = sites["flat ORB"]
    G, L = planes[0].shape[0], len(planes)
    Hp, Wp = patch.canvas_shape(planes)
    R = G * L
    edges = torch.tensor([[0, 0, 0], [Wp - 1, Hp - 1, R - 1], [Wp + 5, Hp + 9, R],
                          [-1, -1, L], [-Wp - 3, -2, R + 3], [3, 4, -1], [17, -60, -R - 2],
                          [40, 30, L + 7], [600, 200, R - L]], dtype=torch.int32,
                         device=xyl0.device)
    for name, (pl, xyl) in dict(sites, **{"flat edge rows": (planes, edges)}).items():
        got = patch.gather_patches_cuda(pl, xyl)
        want = patch.gather_patches_plain(pl, xyl)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"(t1) the multi-image gather disagrees with its plain version "
                             f"({name}): {float((got - want).abs().max())}")
        print(f"(t1) patch_gather {name}: shape {tuple(got.shape)}, G = {G}, bit-equal to "
              f"its plain version")
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=xyl0.device)
    flush = lambda: scratch.fill_(1.0)   # noqa: E731
    out = []
    for name, (pl, xyl) in sites.items():
        fn = lambda: patch.gather_patches_cuda(pl, xyl)  # noqa: E731
        canvas = patch.stack_pyramid_for_patches_multi(list(pl))
        library = lambda: patch.extract_patches_stack_plain(canvas, xyl)  # noqa: E731
        if not torch.equal(library(), fn()):
            raise SystemExit(f"(t1) patch_gather disagrees with the indexing call ({name})")
        # the canvas rows as 2-D planes, image g's level l at row g * L + l
        rows = [p[g] for g in range(G) for p in pl]
        row = dict(site=name, K=int(xyl.shape[0]), G=G, cold_ms=_cold_ms(fn, flush),
                   warm_ms=_graph_ms(fn),
                   plain_ms=_graph_ms(lambda: patch.gather_patches_plain(pl, xyl), reps=5),
                   library_ms=_cold_ms(library, flush), library_warm_ms=_graph_ms(library),
                   bound_ms=_patch_bound_ms(rows, xyl))
        del canvas
        out.append(row)
        print(f"(t1) patch_gather {name}, G = {G}, G*K = {row['K']}: cold "
              f"{row['cold_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms (bytes), cold/bound "
              f"{row['cold_ms'] / row['bound_ms']:.2f}; warm {row['warm_ms']:.6f} ms; plain "
              f"{row['plain_ms']:.6f} ms; library (advanced indexing on a prebuilt canvas) "
              f"cold {row['library_ms']:.6f} ms, warm {row['library_warm_ms']:.6f} ms")
    return out


def _frame_gaps(got, want) -> dict:
    """batch_flat's frames against batch's: keypoint fields exact, angles,
    descriptor bits, stereo (the frontend tests' bounds)."""
    same_kp = bool(torch.equal(got.xy, want.xy) and torch.equal(got.level, want.level)
                   and torch.equal(got.valid, want.valid))
    v = want.valid & got.valid
    n_valid = int(v.sum())
    flips = int(np.unpackbits(convert.desc_to_numpy(got.desc[v] ^ want.desc[v])
                              .view(np.uint8)).sum())
    sv = v & (got.depth > 0) & (want.depth > 0)
    return dict(keypoints_equal=same_kp, response_equal=bool(torch.equal(got.response,
                                                                          want.response)),
                angle_gap=float((got.angle[v] - want.angle[v]).abs().max()) if n_valid else 0.0,
                desc_flips=flips, valid_bits=256 * n_valid,
                depth_flips=int(((got.depth > 0) != (want.depth > 0))[v].sum()),
                u_right_gap=float((got.u_right[sv] - want.u_right[sv]).abs().max())
                if bool(sv.any()) else 0.0,
                depth_rel_gap=float(((got.depth[sv] - want.depth[sv]).abs()
                                     / want.depth[sv]).max()) if bool(sv.any()) else 0.0,
                n=int(got.valid.numel()))


def run_flat_frontend(card: str, fe, frames, device="cuda") -> dict:
    """(t2) batch_flat on the first FLAT_PAIRS * FLAT_BATCHES frames of
    (q1), B = FLAT_PAIRS pairs at a time: 3 gathers per batch and no canvas
    on the card, the frames against batch's; ms per pair of both, from
    paired runs (CUDA events)."""
    dev = torch.device(device)
    out = dict(name="t2", launches=0, frames=0, batches=[])
    for b in range(FLAT_BATCHES):
        part = frames[b * FLAT_PAIRS:(b + 1) * FLAT_PAIRS]
        lefts = torch.from_numpy(np.stack([f[0] for f in part])).to(dev)
        rights = torch.from_numpy(np.stack([f[1] for f in part])).to(dev)
        patch.LAUNCHES = 0
        patch.CANVAS_BUILDS = 0
        got = fe.batch_flat(lefts, rights)
        _sync(device)
        launches, builds = patch.LAUNCHES, patch.CANVAS_BUILDS
        gaps = _frame_gaps(got, fe.batch(lefts, rights))
        gaps.update(launches=launches, canvas_builds=builds)
        out["batches"].append(gaps)
        out["launches"] += launches
        out["frames"] += FLAT_PAIRS
        print(f"(t2) batch_flat on {device}, batch {b}, {FLAT_PAIRS} pairs: patch_gather "
              f"launches {launches}, canvas builds {builds}; against batch: {gaps}")
        bad = []
        if device == "cuda" and (launches != 3 or builds != 0):
            bad.append(f"{launches} launches and {builds} canvas builds, expected 3 and 0")
        if not gaps["keypoints_equal"]:
            bad.append("keypoints differ from batch's")
        if not (gaps["angle_gap"] <= MAX_FLAT_ANGLE_GAP
                and gaps["desc_flips"] <= MAX_FLAT_DESC_FLIPS * gaps["valid_bits"]
                and gaps["depth_flips"] <= MAX_FLAT_DEPTH_FLIPS * gaps["n"]
                and gaps["u_right_gap"] <= 1e-3 and gaps["depth_rel_gap"] <= 1e-4):
            bad.append("angles, descriptors or stereo past the frontend tests' bounds")
        if bad:
            raise SystemExit("(t2): " + "; ".join(bad))
    if device == "cuda":
        flat_ms, batch_ms = [], []
        for _ in range(2):      # flat, batch, batch, flat
            flat_ms.append(_event_ms(lambda: fe.batch_flat(lefts, rights), 5, 1))
            batch_ms.append(_event_ms(lambda: fe.batch(lefts, rights), 5, 1))
            batch_ms.append(_event_ms(lambda: fe.batch(lefts, rights), 5, 1))
            flat_ms.append(_event_ms(lambda: fe.batch_flat(lefts, rights), 5, 1))
        out["flat_ms_per_pair"] = float(np.median(flat_ms)) / FLAT_PAIRS
        out["batch_ms_per_pair"] = float(np.median(batch_ms)) / FLAT_PAIRS
        print(f"(t2) on {card}: ms per pair, batch_flat {out['flat_ms_per_pair']:.3f}, batch "
              f"{out['batch_ms_per_pair']:.3f} (CUDA events, host launches included; paired "
              f"runs, flat / batch / batch / flat, medians of 5 after 1)")
    return out


def run_multi(card: str, seq: Sequence, device="cuda") -> dict:
    """(t3) FusedFrameStep.multi over MULTI_FRAMES frames of phase 4's
    sequence from frame 0's tables, against as many chained __call__s from
    the same state: equal bit for bit; ms per frame of both."""
    full = seq.full
    left0, right0 = seq.frames[0][:2]
    seq.keyframe(0, convert.to_numpy(full.frontend(left0, right0)))
    eye = torch.eye(4, device=seq.dev)
    ins = [seq.inputs(i) for i in range(1, MULTI_FRAMES + 1)]
    lefts = torch.stack([x[0] for x in ins])
    rights = torch.stack([x[1] for x in ins])

    def chained():
        T, vel, To, vo = eye, eye, seq.To, seq.vo
        poses, n_cam, n_obj = [], [], []
        for left, right in ins:
            r, To, vo, n_o = full(left, right, T, vel, *seq.map, *seq.obj, To, vo)
            T, vel = r.T_cw, r.velocity
            poses.append(T)
            n_cam.append(r.n_inliers)
            n_obj.append(n_o)
        return (T, vel, To, vo), (torch.stack(poses), torch.stack(n_cam), torch.stack(n_obj))

    def multi():
        return full.multi(lefts, rights, eye, eye, *seq.map, *seq.obj, seq.To, seq.vo)

    got, want = multi(), chained()
    equal = all(torch.equal(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1]))
    errs = [seq.gt_error(i + 1, got[1][0][i]) for i in range(MULTI_FRAMES)]
    out = dict(name="t3", equal=equal, gt_errors=errs, n_inliers=got[1][1].tolist(),
               obj_n_inliers=got[1][2].tolist())
    if device == "cuda":
        m_ms, c_ms = [], []
        for _ in range(2):      # multi, chained, chained, multi
            m_ms.append(_event_ms(multi, 2, 1))
            c_ms.append(_event_ms(chained, 2, 1))
            c_ms.append(_event_ms(chained, 2, 1))
            m_ms.append(_event_ms(multi, 2, 1))
        out["multi_ms_per_frame"] = float(np.median(m_ms)) / MULTI_FRAMES
        out["chained_ms_per_frame"] = float(np.median(c_ms)) / MULTI_FRAMES
    print(f"(t3) FusedFrameStep.multi on {device}, S = {MULTI_FRAMES}: bit-equal to "
          f"{MULTI_FRAMES} chained calls {equal}; translation errors "
          f"{[round(e, 4) for e in errs]} m, camera inliers {out['n_inliers']}, object inliers "
          f"{out['obj_n_inliers']}; ms per frame multi {out.get('multi_ms_per_frame')}, "
          f"chained {out.get('chained_ms_per_frame')} (CUDA events, paired runs)")
    if not equal or max(errs) >= MAX_TRANS_ERR_M:
        raise SystemExit(f"(t3): bit-equal {equal}, translation errors {errs}")
    return out


def _gate_violations(ext, feats, gate: torch.Tensor) -> int:
    """Valid keypoints whose level pixel the gate, resized to the level as
    the extractor resizes it, does not allow."""
    bad = 0
    for lvl, (rows, cols) in enumerate(ext.gate_index):
        sel = feats.valid & (feats.level == lvl)
        if not bool(sel.any()):
            continue
        xy = feats.xy[sel] / ext._level_scale[lvl]
        x = torch.round(xy[:, 0]).long().clamp(0, cols.numel() - 1)
        y = torch.round(xy[:, 1]).long().clamp(0, rows.numel() - 1)
        bad += int((~gate[rows[y], cols[x]]).sum())
    return bad


def run_gated_orb(card: str, frames, device="cuda") -> dict:
    """(t4) ORBExtractor(img, gate) with a box gate on (q1)'s first left
    image: every keypoint inside the gate; the keypoints against the
    port's CPU path."""
    cam = CameraConfig()
    img = frames[0][0]
    gate = np.zeros((cam.height, cam.width), bool)
    r0, r1, c0, c1 = GATE_BOX
    gate[r0:r1, c0:c1] = True
    got = ORBExtractor(cam.height, cam.width, device=device)(img, gate)
    cpu_ext = ORBExtractor(cam.height, cam.width, device="cpu")
    want = cpu_ext(img, gate)
    g = type(got)(*[x.cpu() for x in got])
    bad = _gate_violations(cpu_ext, g, torch.from_numpy(gate))
    differ = int((~((g.xy == want.xy).all(dim=1) & (g.level == want.level)
                    & (g.valid == want.valid))).sum())
    out = dict(name="t4", valid=int(g.valid.sum()), outside=bad, differing=differ,
               capacity=int(g.valid.numel()))
    print(f"(t4) gated ORB on {device}, box rows {r0}:{r1} cols {c0}:{c1}: {out['valid']} "
          f"valid keypoints, {bad} outside the gate, {differ} of {out['capacity']} differing "
          f"from the CPU path (bound {MAX_KEYPOINTS_DIFFERING})")
    if bad or out["valid"] == 0 or differ > MAX_KEYPOINTS_DIFFERING * out["capacity"]:
        raise SystemExit(f"(t4): {out}")
    return out


def run_stage_times(card: str, fe, frames) -> dict:
    """(t5) frontend_stage_ms on (q1)'s first pair and roofline.report of
    the frontend's H100 models at those times; the JSON holds no NaN."""
    from pointslot_torch.utils import roofline, stagebench

    left, right = (torch.from_numpy(x).cuda() for x in frames[0][:2])
    stages = stagebench.frontend_stage_ms(fe, left, right, n=STAGE_N)
    models = roofline.h100_frontend_models(fe)
    report = roofline.report({k: (models[k], ms) for k, ms in stages.items()})
    line = json.dumps({"stages_ms": stages, "roofline": report}, allow_nan=False)
    print(f"(t5) frontend stage ms on {card} (prefix deltas, CUDA events, n = {STAGE_N}): "
          f"{line}")
    return dict(stages_ms=stages, roofline=report)


def run_flat(card: str, seq: Sequence, frames, device="cuda") -> dict:
    """Phase (t): (t1)-(t5) at full width with the default ORB."""
    t0 = time.perf_counter()
    cam = CameraConfig()
    fe = StereoFrontend(cam.height, cam.width, cam.fx, cam.bf, device=device)
    out = {}
    if device == "cuda":
        part = frames[:FLAT_PAIRS]
        lefts = torch.from_numpy(np.stack([f[0] for f in part])).cuda()
        rights = torch.from_numpy(np.stack([f[1] for f in part])).cuda()
        out["t1"] = check_flat_gather(fe, lefts, rights)
    out["t2"] = run_flat_frontend(card, fe, frames, device)
    out["t3"] = run_multi(card, seq, device)
    out["t4"] = run_gated_orb(card, frames, device)
    if device == "cuda":
        out["t5"] = run_stage_times(card, fe, frames)
    print(f"phase (t) took {time.perf_counter() - t0:.1f} s")
    return out


def run_selected(card: str, only: set) -> None:
    """Phases (r), (s) and (t) alone (``--only``), each beside the run it is
    read against: (f) for (r), (a) for (s), phase 3's single-pair gather
    sites for (t)."""
    if "r" in only:
        _, frames_o = render_object_frames(OBJECT_FRAMES)
        scene, frames = render_loop_frames()
        t0 = time.perf_counter()
        f = run_loop("f: loop closing, sync mapping", scene, frames)
        check_loop_run(f)
        print(f"phase (f) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_mesh(card, frames_o, dict(scene=scene, frames=frames, f=f))
        print(f"phase (r) took {time.perf_counter() - t0:.1f} s")
    if "s" in only:
        scene, frames = render_system_frames(SYSTEM_FRAMES)
        t0 = time.perf_counter()
        a = run_system("a: host tracker, sync mapping", scene, frames)
        print(f"phase (a) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_pipeline_stages(card, scene, frames, a)
        print(f"phase (s) took {time.perf_counter() - t0:.1f} s")
    if "t" in only:
        cam = CameraConfig()
        full = FusedFrameStep(SystemConfig().replace(camera=cam), device="cuda")
        seq = Sequence(full, cam, n_frames=WARMUP_FRAMES + TIMED_FRAMES + 1)
        check_patch_gather(seq)
        run_flat(card, seq, render_object_frames(OBJECT_FRAMES)[1])


def main() -> int:
    parser = argparse.ArgumentParser(description="pointslot_torch on one CUDA card")
    parser.add_argument("--only", default="",
                        help="comma list of phases to run alone: r (the mesh), s (the stages), "
                             "t (the flat frontend, multi, the gated ORB call, stage times)")
    only = {p for p in parser.parse_args().only.split(",") if p}
    if only - {"r", "s", "t"}:
        parser.error(f"--only takes r, s and t, not {sorted(only - {'r', 's', 't'})}")
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
    if only:
        run_selected(card, only)
        print(f"phases {', '.join(sorted(only))}: every gate held")
        return 0

    cam = CameraConfig()
    cfg = SystemConfig().replace(camera=cam)
    full = FusedFrameStep(cfg, device="cuda")
    seq = Sequence(full, cam, n_frames=WARMUP_FRAMES + TIMED_FRAMES + 1)
    kernel = check_patch_gather(seq)
    forwards = forward_detectors()
    detection_launches = count_detection_launches(forwards)
    train_profile = profile_training_steps()

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

    systems = run_systems(card)
    runs = {k: systems[k] for k in ("a", "b", "c")}
    objects = run_objects(card)
    runs.update(d=objects["d"], e=objects["e"])
    t0 = time.perf_counter()
    flow = run_flow_objects(card)
    runs["i"] = flow["i"]
    print(f"phase (i) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["k"] = run_checkpoint_resume(flow["scene"], flow["frames"], flow["i"])
    print(f"phase (k) took {time.perf_counter() - t0:.1f} s")
    loop = run_loop_closing(card)
    runs.update({k: loop[k] for k in ("f", "g", "h", "j")})
    t0 = time.perf_counter()
    runs["l"] = run_distortion()
    print(f"phase (l) took {time.perf_counter() - t0:.1f} s")
    slot = run_slot_modes(card, forwards=forwards, launches=detection_launches)
    runs.update({k: slot[k] for k in ("m1", "m2", "n", "o")})
    t0 = time.perf_counter()
    train = run_training(card, slot["frames_o"], train_profile)
    runs["p2"] = dict(launches=train["launches"], frames=train["frames"])
    print(f"phase (p) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runner = run_runner(card, objects["scene"], objects["frames"])
    runs.update(q1=runner["q1"], q2=runner["q2"]["dp"], q2_no_dp=runner["q2"]["single"])
    print(f"phase (q) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh = run_mesh(card, objects["frames"], loop)
    runs.update(mesh)
    print(f"phase (r) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stages = run_pipeline_stages(card, systems["scene"], systems["frames"], systems["a"])
    runs.update(stages)
    print(f"phase (s) took {time.perf_counter() - t0:.1f} s")
    flat = run_flat(card, seq, objects["frames"])
    runs["t2"] = flat["t2"]

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
        "bound_ms": left["bound_ms"], "bound_by": "bytes", "library_ms": left["library_ms"],
        "canvas_builds": builds, "sites": kernel["sites"] + flat["t1"],
        "g1_bodies": kernel["g1_bodies"],
        "launches_system": {k: r["launches"] for k, r in runs.items()},
        "frames_system": {k: r["frames"] for k, r in runs.items()},
        "earlier_canvas": {"ms": kernel["canvas_ms"], "cold_ms": kernel["canvas_cold_ms"],
                           "launches": kernel["canvas_launches"]},
        "outside_kernels": {
            "stages": slot["stages"], "forwards": slot["forwards"],
            "training_steps": train["timing"],
            "training": {k: train[k] for k in (
                "render_s", "recipe_s", "recipe_first", "recipe_last", "recall", "bundled_recall",
                "recall_low", "bundled_recall_low", "reid_s", "reid_margin",
                "bundled_reid_margin")},
            "two_view": train["two_view"],
            "runner": {"q1": {k: v for k, v in runner["q1"].items() if k != "launches"},
                       "q2": {k: runner["q2"][k] for k in ("gap", "batch_ms_per_pair",
                                                           "single_ms")},
                       "q3": runner["q3"], "q4": runner["q4"]},
            "mesh": {"r1": {k: mesh["r1"][k] for k in ("ms", "first_s", "obj_gap", "pose_gap",
                                                        "point_gap", "repeats")},
                     "r2": {k: mesh["r2"][k] for k in ("sharded_ms_per_pair",
                                                        "batch_ms_per_pair")},
                     "r3": {"track_ms": mesh["r3"]["track_ms"], "steps": mesh["r3"]["steps"],
                            "counters": mesh["r3"]["counters"], "ate": mesh["r3"]["ate"],
                            "f_track_ms": loop["f"]["track_ms"], "f_steps": loop["f"]["steps"]}},
            "pipeline": {k: {f: v[f] for f in ("track_ms", "ate", "packets", "bytes_sent",
                                                "bytes_received", "high_points", "drain_s")}
                         for k, v in stages.items()},
            "flat": {"t2": {k: flat["t2"][k] for k in ("flat_ms_per_pair", "batch_ms_per_pair")},
                     "t3": {k: flat["t3"][k] for k in ("multi_ms_per_frame",
                                                        "chained_ms_per_frame")},
                     "t5": flat["t5"]}},
    }]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
