#!/usr/bin/env python3
"""Do pointslot_torch's mode-0 and mode-4 Systems give the same result
twice on the card, and if not, which device stage first answers the same
inputs with different outputs?

    python3 scripts/torch_repeatability.py [--frames 40] [--object-frames 20]

Run from the repository root on a CUDA machine. It runs itself twice in
subprocesses: once with torch's default algorithms, once with
torch.use_deterministic_algorithms(True, warn_only=True) and
CUBLAS_WORKSPACE_CONFIG=:4096:8. Each drives chip_smoke.py's System runs
(a) host tracker + sync mapping and (b) device-resident fast path, its
mode-4 run (d) host tracker + sync mapping, and its loop-closing run (f)
with the global BA inline (``background_gba=False``) on the whole loop
scene, twice each on the same frames (chip_smoke's scenes at full KITTI
width), records a digest of the inputs and outputs of every call to the
device stages (frontend, fused step, project_and_match, brute_match,
pose_optimize, triangulate, fine_tune_with_bbox, bundle_adjust,
bundle_adjust_batched, rigid_ransac, rigid_refine, pnp_ransac,
optimize_pose_graph), and prints, for each pair of runs, the keyframe ids,
the loop pairs closed (current, candidate keyframe), the largest camera
(and object) translation gap, and the first call whose inputs agree and
whose outputs do not. In the deterministic run it also lists the ops that torch reports
as having no deterministic implementation.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(x, h) -> None:
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        h.update(str(x.dtype).encode())
        h.update(x.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())
    elif isinstance(x, np.ndarray):
        h.update(str(x.dtype).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, (tuple, list)):
        for v in x:
            _digest(v, h)
    elif isinstance(x, dict):
        for k in sorted(x):
            h.update(k.encode())
            _digest(x[k], h)
    elif isinstance(x, (int, float, bool, str, type(None))):
        h.update(repr(x).encode())


def digest(*xs) -> str:
    h = hashlib.blake2b(digest_size=8)
    for x in xs:
        _digest(x, h)
    return h.hexdigest()


class Recorder:
    """Wraps each device stage; appends (stage, input digest, output digest)."""

    def __init__(self):
        from pointslot_torch.geometry import pnp, triangulation
        from pointslot_torch.ops.frontend import StereoFrontend
        from pointslot_torch.ops.fused_track import FusedTrackStep
        from pointslot_torch.slam import matchers, object_system
        from pointslot_torch.solvers import local_ba, pose_opt, posegraph

        self.calls = []
        targets = [(StereoFrontend, "__call__", True), (FusedTrackStep, "__call__", True),
                   (matchers, "project_and_match", False), (matchers, "brute_match", False),
                   (pose_opt, "pose_optimize", False), (triangulation, "triangulate", False),
                   (object_system, "fine_tune_with_bbox", False),
                   (local_ba, "bundle_adjust", False), (local_ba, "bundle_adjust_batched", False),
                   (pnp, "rigid_ransac", False), (pnp, "rigid_refine", False),
                   (pnp, "pnp_ransac", False), (posegraph, "optimize_pose_graph", False)]
        for owner, attr, method in targets:
            setattr(owner, attr, self._wrap(getattr(owner, attr), f"{owner.__name__}.{attr}",
                                            method))

    def _wrap(self, fn, name, method):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            ins = digest(list(args[1:] if method else args), kw)
            self.calls.append((name, ins, digest(out)))
            return out
        return wrapped


def run_once(args) -> None:
    import numpy as np
    import torch

    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from pointslot_torch.slam.system import System

    rec = Recorder()
    camera = chip_smoke.render_system_frames(args.frames)
    objects = chip_smoke.render_object_frames(args.object_frames)
    cases = [("a", camera, chip_smoke.system_config()),
             ("b", camera, chip_smoke.system_config(device_resident_tracking=True)),
             ("d", objects, chip_smoke.object_config())]
    inline = chip_smoke.loop_config()
    inline = inline.replace(loop=dataclasses.replace(inline.loop, background_gba=False))
    cases.append(("f", chip_smoke.render_loop_frames(), inline))
    flagged = set()
    runs = {}
    for label, (scene, frames), config in cases:
        for rep in (1, 2):
            rec.calls = []
            pairs = []
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                system = System(config, device="cuda")
                if system.loop_closer is not None:
                    correct = system.loop_closer._correct_loop

                    def recorded(kf, cand, T_lc, _correct=correct, _pairs=pairs):
                        _pairs.append((int(kf), int(cand)))
                        return _correct(kf, cand, T_lc)

                    system.loop_closer._correct_loop = recorded
                for i, frame in enumerate(frames):
                    chip_smoke._track(system, frame, i)
                system.wait_for_mapping()
            flagged |= {str(w.message).split(" does not have a deterministic")[0]
                        for w in caught if "deterministic" in str(w.message)}
            traj = {f: np.linalg.inv(T)[:3, 3] for f, T, _ in system.camera_trajectory()}
            obj = {(t.track_id, f): T[:3, 3] for t in getattr(
                system._object_system, "all_tracks", ()) for f, T in t.poses_cf.items()}
            # the trajectory's world anchored at its first frame (the loop
            # scene initialises a few frames in)
            errs = chip_smoke._anchored_errors(scene, system.camera_trajectory())
            runs[label, rep] = dict(calls=rec.calls, traj=traj, obj=obj, pairs=pairs,
                                    kf_ids=chip_smoke._keyframe_ids(system.map),
                                    ate=float(np.sqrt(np.mean(np.square(errs)))))
            system.shutdown()
    for label, _, _ in cases:
        r1, r2 = runs[label, 1], runs[label, 2]
        gap = max(float(np.abs(r1["traj"][f] - r2["traj"][f]).max())
                  for f in r1["traj"] if f in r2["traj"])
        obj_gap = max((float(np.abs(r1["obj"][k] - r2["obj"][k]).max())
                       for k in r1["obj"] if k in r2["obj"]), default=None)
        first = None
        for k, (c1, c2) in enumerate(zip(r1["calls"], r2["calls"])):
            if c1 != c2:
                same_inputs = c1[:2] == c2[:2]
                first = dict(call=k, stage=c1[0], other_stage=c2[0], same_inputs=same_inputs)
                break
        print(json.dumps(dict(
            mode="deterministic" if args.deterministic else "default", run=label,
            calls=[len(r1["calls"]), len(r2["calls"])], kf_ids=[r1["kf_ids"], r2["kf_ids"]],
            loop_pairs=[r1["pairs"], r2["pairs"]],
            ate=[r1["ate"], r2["ate"]], max_translation_gap_m=gap,
            max_object_translation_gap_m=obj_gap,
            same_object_poses=sorted(r1["obj"]) == sorted(r2["obj"]),
            first_divergence=first,
            stages_nondeterministic=sorted({c1[0] for c1, c2 in zip(r1["calls"], r2["calls"])
                                            if c1[:2] == c2[:2] and c1[2] != c2[2]}),
        )), flush=True)
    if args.deterministic:
        print(json.dumps(dict(flagged_ops=sorted(flagged))), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=40)
    parser.add_argument("--object-frames", type=int, default=20)
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--child", action="store_true")
    args = parser.parse_args()
    if args.child:
        run_once(args)
        return 0
    rc = 0
    for deterministic in (False, True):
        env = dict(os.environ)
        cmd = [sys.executable, __file__, "--child", "--frames", str(args.frames),
               "--object-frames", str(args.object_frames)]
        if deterministic:
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            cmd.append("--deterministic")
        rc |= subprocess.run(cmd, env=env, cwd=ROOT, timeout=1500).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
