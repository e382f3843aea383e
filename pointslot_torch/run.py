"""CLI runner of the port: run the SLOT system over a KITTI-tracking or
Virtual KITTI 2 sequence, or the built-in synthetic scene, on the card.

The port of ``pointslot_tpu/run.py`` (the reference's
Examples/Stereo/stereo_kitti.cc: argument parsing :49-70, LoadImages
:175-245, the per-frame loop :108-145, trajectory saves :163-166, timing
stats :151-160). It takes the same flags, reads the same layouts, writes
the same files (``CameraTrajectory.txt``, ``CameraAndObjectTrajectory*.txt``,
``ObjectPosesCF.txt``, ``ObjectDetections/NNNNNN.txt``, ``stats.json`` with
its ``evaluation``) and prints the same JSON stats line.

Where it differs from the JAX runner:

- ``--platform`` picks the torch device: ``auto`` (the default), ``gpu``
  and ``cuda`` mean the CUDA card, and the run stops with the device error
  on a machine without one; ``cpu`` runs the plain PyTorch path. Any other
  value is refused.
- ``--no-compile-cache`` is accepted and has nothing to turn off: the port
  has no XLA cache, and its kernels' build cache (``build/``) is not
  optional.
- ``--dp B`` extracts frames in batches of B through
  ``StereoFrontend.batch`` on the System's card, ahead of the tracking of
  each batch. ``batch`` runs the single-pair frontend pair after pair, so
  on one card the flag gives the same frames at the same speed as no
  ``--dp``; it is kept for the JAX runner's flag. The JAX runner's form
  sharded over several devices waits for ROADMAP item 15; with more than
  one card visible the port uses the System's card and says so on stderr.
- ``--viz`` and ``--live`` draw through PIL; without it the run stops
  before the first frame with the ImportError's message. PNG input needs
  no PIL (``datasets/png16.py``); Virtual KITTI 2's ``.jpg`` frames do.

Usage:
  python -m pointslot_torch.run --data /path/to/kitti --sequence 0000 \\
      --config Examples/0000-0013.yaml --mode 4 --out out/
  python -m pointslot_torch.run --synthetic 30 --mode 4 --out out/
  python -m pointslot_torch.run --platform cpu --synthetic 4 --config small.yaml --out out/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PLATFORMS = {"auto": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def main(argv=None):
    ap = argparse.ArgumentParser(description="pointslot_torch SLOT runner")
    ap.add_argument("--data", help="dataset root (KITTI tracking / VKITTI)")
    ap.add_argument("--dataset", choices=["kitti", "vkitti"], default="kitti",
                    help="on-disk layout: KITTI tracking or Virtual KITTI 2")
    ap.add_argument("--sequence", default="0000")
    ap.add_argument("--config", help="reference-schema YAML config")
    ap.add_argument("--mode", type=int, default=None, choices=range(5),
                    help="SLOT mode 0-4")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--synthetic-objects", type=int, default=2)
    ap.add_argument("--out", default="out")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--vocab", metavar="PATH",
                    help="ORB vocabulary for loop closure/relocalization "
                         "(ORBvoc.bin/.bin.gz binary or DBoW2 text export "
                         "— the file the reference loads at System.cc:79); "
                         "default trains a small synthetic vocabulary")
    ap.add_argument("--use-flow", action="store_true",
                    help="offline optical-flow object tracking (Virtual "
                         "KITTI forwardFlow/ maps)")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="accepted for the JAX runner's command lines; nothing "
                         "to turn off (no XLA cache; the kernel build cache "
                         "under build/ is always on)")
    ap.add_argument("--platform", default="auto",
                    help="torch device: auto, gpu or cuda (the CUDA card, "
                         "the default; fails without one) or cpu")
    ap.add_argument("--save-checkpoint", metavar="NPZ",
                    help="write full system state (map, trajectory, object "
                         "tracks) at shutdown — the reference's SaveMap "
                         "TODO (include/System.h:109-111), implemented")
    ap.add_argument("--resume", metavar="NPZ",
                    help="restore system state from a checkpoint before "
                         "the first frame")
    ap.add_argument("--device-tracking", action="store_true",
                    help="device-resident camera tracking: the fused step "
                         "per frame with keyframe-rate map-table refresh "
                         "(healthy frames)")
    ap.add_argument("--profile", action="store_true",
                    help="per-stage timing registry + counters in stats.json")
    ap.add_argument("--dp", type=int, default=0, metavar="B",
                    help="extract frames in batches of B through the "
                         "batched frontend on the System's card, ahead of "
                         "sequential tracking (mode 0 only; on one card the "
                         "same frames at the single-pair speed)")
    ap.add_argument("--sync-mapping", action="store_true",
                    help="run mapping inline on the tracking thread instead "
                         "of the async worker (the reference always runs its "
                         "mapping threads; async is the CLI default)")
    ap.add_argument("--eval-gt", metavar="POSES",
                    help="ground-truth camera poses (KITTI 12-float rows); "
                         "ATE/RPE go into stats.json (synthetic runs "
                         "evaluate against the scene GT automatically)")
    ap.add_argument("--eval-object-gt", metavar="LABELS",
                    help="KITTI tracking label file; object center/heading "
                         "errors go into stats.json (defaults to the "
                         "sequence's own labels in mode 4 dataset runs)")
    ap.add_argument("--viz", type=int, default=0, metavar="N",
                    help="save a keypoint/box/cuboid overlay PNG every N "
                         "frames plus a final top-down map (headless "
                         "counterpart of the reference's Pangolin viewer; "
                         "needs PIL)")
    ap.add_argument("--live", type=int, default=0, metavar="PORT",
                    help="serve a LIVE view at http://host:PORT/ while "
                         "running (MJPEG overlay stream + top-down map; "
                         "the reference's Viewer thread, src/Viewer.cc:62, "
                         "as a browser page; needs PIL)")
    args = ap.parse_args(argv)

    if args.platform not in PLATFORMS:
        ap.error(f"--platform {args.platform!r}: use one of {', '.join(PLATFORMS)}")
    from pointslot_torch.device import resolve_device

    try:
        device = resolve_device(PLATFORMS[args.platform])
    except RuntimeError as e:
        ap.error(f"--platform {args.platform}: {e}")
    if args.viz or args.live:
        try:
            import PIL  # noqa: F401
        except ImportError as e:
            ap.error(f"--viz and --live draw through PIL: {e}")

    from pointslot_torch.config import SLOTMode, SystemConfig, load_yaml

    cfg = SystemConfig()
    if args.config:
        cfg = load_yaml(args.config, base=cfg)
    if args.mode is not None:
        cfg = cfg.replace(slot_mode=args.mode)
    if args.dp and args.dp > 1 and cfg.slot_mode != SLOTMode.SLAM:
        ap.error("--dp requires mode 0 (detection gates are per-frame)")
    if args.no_loop:
        cfg = cfg.replace(loop=cfg.loop.__class__(
            **{**cfg.loop.__dict__, "enabled": False}))
    if args.vocab:
        cfg = cfg.replace(loop=cfg.loop.__class__(
            **{**cfg.loop.__dict__, "vocab_path": args.vocab}))
    if args.use_flow:
        cfg = cfg.replace(objects=cfg.objects.__class__(
            **{**cfg.objects.__dict__, "use_offline_flow": True}))
    if not args.sync_mapping:
        # reference thread topology (System.cc:99-141 spawns the mapping/
        # loop threads unconditionally); --sync-mapping opts out
        cfg = cfg.replace(runtime=cfg.runtime.__class__(
            **{**cfg.runtime.__dict__, "async_mapping": True}))
    if args.device_tracking:
        cfg = cfg.replace(runtime=cfg.runtime.__class__(
            **{**cfg.runtime.__dict__, "device_resident_tracking": True}))
    if args.profile:
        cfg = cfg.replace(runtime=cfg.runtime.__class__(
            **{**cfg.runtime.__dict__, "profile": True}))

    os.makedirs(args.out, exist_ok=True)

    if args.synthetic:
        frames, eval_ctx = _synthetic_frames(args, cfg)
    else:
        if not args.data:
            ap.error("--data or --synthetic required")
        frames, eval_ctx = _kitti_frames(args, cfg)

    from pointslot_torch.slam.system import System

    system = System(cfg, device=device)
    if args.resume:
        from pointslot_torch.slam.checkpoint import load_checkpoint

        load_checkpoint(args.resume, system)
    if args.dp and args.dp > 1:
        frames = _dp_batched_frames(frames, args.dp, system)

    live = None
    if args.live:
        from pointslot_torch.viz.live import LiveViewer

        live = LiveViewer(port=args.live)
        print(f"live view: http://localhost:{live.port}/", file=sys.stderr)

    n = 0
    t0 = time.perf_counter()
    try:
        for frame_id, ts, left, right, dets, inst, flow, *pre in frames:
            frame = system.track_stereo(left, right, ts, frame_id,
                                        detections=dets, instance_mask=inst,
                                        flow=flow,
                                        precomputed=pre[0] if pre else None)
            if args.viz and frame_id % args.viz == 0:
                _save_overlay(args.out, frame_id, left, frame, dets, system, cfg)
            if live is not None:
                live.push_frame(_render_overlay(frame_id, left, frame, dets,
                                                system, cfg))
                if frame_id % 20 == 0:
                    from pointslot_torch.viz.render import draw_map_topdown

                    live.push_map(draw_map_topdown(system))
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
        wall = time.perf_counter() - t0
        if live is not None:
            from pointslot_torch.viz.render import draw_map_topdown

            live.push_map(draw_map_topdown(system))
    finally:
        if live is not None:
            live.close()
        if hasattr(frames, "close"):
            frames.close()    # stops the prefetch threads after --max-frames
    if args.viz:
        from pointslot_torch.viz.render import draw_map_topdown, save_png

        save_png(os.path.join(args.out, "map_topdown.png"),
                 draw_map_topdown(system))

    system.save_trajectory_kitti(os.path.join(args.out, "CameraTrajectory.txt"))
    if system._object_system is not None:
        system.save_object_detections_kitti(os.path.join(args.out, "ObjectDetections"))
        system.save_object_poses_camera_frame(
            os.path.join(args.out, "ObjectPosesCF.txt"))
        system.save_trajectory_camera_and_objects(
            os.path.join(args.out, "CameraAndObjectTrajectory.txt")
        )
    if args.save_checkpoint:
        from pointslot_torch.slam.checkpoint import save_checkpoint

        system.wait_for_mapping()
        save_checkpoint(args.save_checkpoint, system)
    stats = system.shutdown()
    stats.update({"frames": n, "wall_s": wall, "fps": n / max(wall, 1e-9)})
    try:
        evaluation = _evaluate(args, system, eval_ctx)
        if evaluation:
            stats["evaluation"] = evaluation
    except Exception as e:   # malformed GT must not discard the run stats
        stats["evaluation_error"] = f"{type(e).__name__}: {e}"
    print(json.dumps(stats))
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    return 0


def _evaluate(args, system, eval_ctx):
    """Built-in ATE/RPE + object-pose metrics (pointslot_torch/evaluate.py);
    the on-disk outputs stay byte-compatible with evo / the KITTI devkit
    for external cross-checks."""
    import numpy as np

    from pointslot_torch import evaluate as ev

    out = {}
    gt_poses = eval_ctx.get("gt_poses")
    if args.eval_gt:
        from pointslot_torch.io.writers import read_trajectory_kitti

        gt_poses = read_trajectory_kitti(args.eval_gt)
    if gt_poses is not None:
        out["camera"] = ev.evaluate_trajectory_entries(
            system.camera_trajectory(), np.asarray(gt_poses))
    rows = eval_ctx.get("object_gt_rows")
    if args.eval_object_gt:
        from pointslot_torch.datasets.kitti import read_kitti_object_rows

        rows = read_kitti_object_rows(args.eval_object_gt)
    if rows is not None and len(rows) and system._object_system is not None:
        est = {
            (f, tr.track_id): tr.poses_cf[f]
            for tr in system._object_system.all_tracks
            for f in tr.poses_cf
        }
        out["objects"] = ev.object_pose_errors(est, rows)
        # 2D MOT association quality (meaningful in mode 3, where track
        # ids come from the online DeepSORT, not the GT)
        boxes = {}
        for tr in system._object_system.all_tracks:
            for f, det in tr.detections.items():
                boxes.setdefault(int(f), {})[tr.track_id] = det.bbox
        out["mot"] = ev.mot_metrics(boxes, rows)
    return out


def _render_overlay(frame_id, left, frame, dets, system, cfg):
    """Keypoint + detection-box + object-cuboid overlay for one frame."""
    import numpy as np

    from pointslot_torch.viz.render import draw_frame, draw_frame_cuboids

    boxes = [(np.asarray(d.bbox), d.track_id) for d in (dets or [])]
    # the fast path's light frame records carry no keypoints; skip the
    # keypoint layer for those frames
    kp = frame.xy if frame is not None and frame.xy is not None else None
    img = draw_frame(
        np.asarray(left), keypoints=kp,
        kp_valid=frame.valid if kp is not None else None,
        kp_bound=(frame.point_idx >= 0) if kp is not None else None,
        boxes=boxes,
        status_text=f"frame {frame_id}",
    )
    objsys = system._object_system
    if objsys is not None:
        cam = cfg.camera
        cuboids = []
        for track in objsys.tracks.values():
            T_co = track.poses_cf.get(frame_id)
            if T_co is None:
                continue
            # track dims are (length, height, width) = object (x, y, z)
            cuboids.append((np.asarray(T_co), np.asarray(track.dims),
                            track.track_id))
        if cuboids:
            img = draw_frame_cuboids(img, cuboids, cam.fx, cam.fy,
                                     cam.cx, cam.cy)
    return img


def _save_overlay(out_dir, frame_id, left, frame, dets, system, cfg):
    from pointslot_torch.viz.render import save_png

    viz_dir = os.path.join(out_dir, "viz")
    os.makedirs(viz_dir, exist_ok=True)
    img = _render_overlay(frame_id, left, frame, dets, system, cfg)
    save_png(os.path.join(viz_dir, f"frame_{frame_id:06d}.png"), img)


def _dp_batched_frames(frames, batch: int, system):
    """Extract frames in batches of `batch` through the batched frontend
    (``StereoFrontend.batch``) on the System's device, ahead of the
    sequential tracking of the batch. Yields the per-frame tuple extended
    with the frame's precomputed StereoFrame (device tensors)."""
    import itertools

    import numpy as np
    import torch

    from pointslot_torch.ops.frontend import StereoFrame

    if system.device.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"--dp: {torch.cuda.device_count()} cards visible; the batched "
              f"frontend runs on the System's card ({system.device}); the "
              f"sharded form is ROADMAP item 15", file=sys.stderr)
    it = iter(frames)
    try:
        while True:
            chunk = list(itertools.islice(it, batch))
            if not chunk:
                return
            lefts = np.stack([c[2] for c in chunk])
            rights = np.stack([c[3] for c in chunk])
            sf = system.frontend.batch(lefts, rights)
            for i, (frame_id, ts, left, right, dets, inst, flow) in enumerate(chunk):
                one = StereoFrame(*[x[i] for x in sf])
                yield frame_id, ts, left, right, dets, inst, flow, one
    finally:
        if hasattr(it, "close"):
            it.close()


def _synthetic_frames(args, cfg):
    import numpy as np

    from pointslot_torch.datasets.synthetic import (
        SyntheticRenderer, make_scene, offline_detection_rows,
    )
    from pointslot_torch.slam.objects import Detection

    scene = make_scene(n_frames=args.synthetic, camera=cfg.camera,
                       n_objects=args.synthetic_objects)
    renderer = SyntheticRenderer(scene)
    rows = offline_detection_rows(scene)

    def gen():
        for i in range(scene.n_frames):
            left, right, inst = renderer.render(i)
            dets = None
            if cfg.slot_mode == 4:
                frame_rows = rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]
                dets = [Detection.from_row24(r, mask_value=int(r[1]) + 1)
                        for r in frame_rows]
            yield i, i / cfg.camera.fps, left, right, dets, inst, None

    ctx = {"gt_poses": np.stack(scene.poses_world),
           "object_gt_rows": rows[rows[:, 1] >= 0] if len(rows) else None}
    return gen(), ctx


def _kitti_frames(args, cfg):
    from pointslot_torch.datasets.kitti import (
        KittiTrackingSequence, VirtualKittiSequence,
    )
    from pointslot_torch.datasets.prefetch import prefetch

    if args.dataset == "vkitti":
        seq = VirtualKittiSequence(args.data)
    else:
        seq = KittiTrackingSequence(args.data, args.sequence)
    ts = seq.timestamps(cfg.camera.fps)
    use_flow = cfg.objects.use_offline_flow

    def load(i):
        left, right, dets, inst = seq.load(i)
        flow = seq.load_flow(i) if use_flow else None
        return (i, float(ts[i]), left, right,
                (dets if cfg.slot_mode == 4 else None), inst, flow)

    ctx = {"gt_poses": getattr(seq, "gt_poses", None),
           "object_gt_rows": seq.rows if getattr(seq, "rows", None) is not None
           and len(seq.rows) else None}
    # decode ahead on background threads; the tracking loop never waits
    # on disk (the reference imreads synchronously per frame,
    # Examples/Stereo/stereo_kitti.cc:108-124)
    return prefetch(load, len(seq), depth=4, workers=2), ctx


if __name__ == "__main__":
    sys.exit(main())
