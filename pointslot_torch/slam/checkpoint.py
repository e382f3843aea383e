"""Map and object-state checkpointing.

Port of ``pointslot_tpu/slam/checkpoint.py`` (the reference has no
persistence: System::SaveMap/LoadMap is a TODO, include/System.h:109-111).
The MapState tables, the tracker's continuation state, the camera
trajectory and every object track go to one compressed npz whose keys are
the reference's, key for key (``_MAP_FIELDS``, ``_TRACK_SCALARS``,
``_TRACK_ARRAYS``, ``_OKF_ARRAYS``), so a file written by either package
loads in the other.

Loading leaves nothing stale of the System it loads into: the mapping
queue is drained first; an in-flight global BA is superseded by its epoch
(its merge is dropped); the loop closer's database is rebuilt from the
restored keyframes and its consistent groups dropped; the fast path's
device tables are rebuilt from the restored map (the tracker resumes
without a velocity model, so the first frame goes through reference-
keyframe tracking on the host, as in the reference, seeded from the saved
pose of the last frame); the tracker's cached
device features, the mapper's recent points, the object system's pending
object-keyframe counts and the previous frame's flow are reset.
"""

from __future__ import annotations

import contextlib

import numpy as np

_MAP_FIELDS = [
    "kf_pose", "kf_valid", "kf_uid", "kf_frame_id", "kf_xy", "kf_level",
    "kf_desc", "kf_angle", "kf_depth", "kf_uright", "kf_feat_valid",
    "kf_point_idx", "kf_parent", "pt_pos", "pt_desc", "pt_valid", "pt_normal",
    "pt_min_dist", "pt_max_dist", "pt_first_kf", "pt_visible", "pt_found",
    "pt_dynamic", "obs",
]

_TRACK_SCALARS = ["track_id", "last_seen_frame", "last_seen_time", "dynamic",
                  "dyn_votes", "track_ok", "n_inliers"]
_TRACK_ARRAYS = ["dims", "pt_pos", "pt_desc", "pt_valid", "pt_found",
                 "pt_visible", "pt_first_okf", "pt_last_xy", "pt_last_angle",
                 "pt_last_frame",
                 "obs"]
_OKF_ARRAYS = ["xy", "level", "desc", "angle", "depth", "u_right", "point_idx",
               "T_co", "T_cw", "bbox"]


def _object_lock(system):
    objsys = system._object_system
    return objsys._obj_lock if objsys is not None else contextlib.nullcontext()


def save_checkpoint(path: str, system) -> None:
    """Write `system`'s map, tracker, trajectory and object tracks to `path`
    (an npz), under the map lock and the object lock."""
    with system.map_lock, _object_lock(system):
        _save(path, system)


def _save(path: str, system) -> None:
    data = {}
    m = system.map
    for f in _MAP_FIELDS:
        data[f"map/{f}"] = getattr(m, f)
    data["map/next_uid"] = np.int64(m._next_uid)

    # tracker continuation state: enough to resume tracking against the
    # restored map (the first resumed frame goes through reference-KF
    # tracking, which needs only ref_kf and the KF tables)
    tr = system.tracker
    data["tracker/state"] = np.int64(tr.state)
    data["tracker/ref_kf"] = np.int64(tr.ref_kf)
    data["tracker/last_kf_frame_id"] = np.int64(tr.last_kf_frame_id)
    data["tracker/last_T_cw"] = (
        tr.last_frame.T_cw if tr.last_frame is not None
        and tr.last_frame.T_cw is not None else np.eye(4, dtype=np.float32)
    )

    traj = tr.trajectory
    data["traj/frame_id"] = np.asarray([e.frame_id for e in traj], np.int64)
    data["traj/ref_kf"] = np.asarray([e.ref_kf for e in traj], np.int64)
    data["traj/ref_uid"] = np.asarray([e.ref_uid for e in traj], np.int64)
    data["traj/T_rel"] = np.stack([e.T_rel for e in traj]) if traj else np.zeros((0, 4, 4))
    data["traj/lost"] = np.asarray([e.lost for e in traj], bool)

    if system._object_system is not None:
        tracks = system._object_system.all_tracks
        data["obj/n_tracks"] = np.int64(len(tracks))
        for i, t in enumerate(tracks):
            for s in _TRACK_SCALARS:
                data[f"obj/{i}/{s}"] = np.asarray(getattr(t, s))
            for a in _TRACK_ARRAYS:
                data[f"obj/{i}/{a}"] = np.asarray(getattr(t, a))
            frames = sorted(t.poses_cf)
            data[f"obj/{i}/frames"] = np.asarray(frames, np.int64)
            data[f"obj/{i}/poses_cf"] = (
                np.stack([t.poses_cf[f] for f in frames]) if frames else np.zeros((0, 4, 4)))
            data[f"obj/{i}/poses_world"] = (
                np.stack([t.poses_world[f] for f in frames]) if frames else np.zeros((0, 4, 4)))
            data[f"obj/{i}/n_okf"] = np.int64(len(t.keyframes))
            for j, okf in enumerate(t.keyframes):
                data[f"obj/{i}/okf/{j}/frame_id"] = np.int64(okf.frame_id)
                for a in _OKF_ARRAYS:
                    v = getattr(okf, a)
                    data[f"obj/{i}/okf/{j}/{a}"] = v if v is not None else np.zeros(0)
    np.savez_compressed(path, **data)


def load_checkpoint(path: str, system) -> None:
    """Restore `system` from the npz at `path` (written by either package)."""
    if system._mapping_thread is not None:
        system._mapping_queue.join()   # no queued work lands on the restored map
    with system.map_lock, _object_lock(system):
        _load(path, system)


def _pose_only_frame(T_cw):
    """A FrameRecord with the pose `T_cw` and no features."""
    from pointslot_torch.slam.tracking import FrameRecord

    return FrameRecord(frame_id=-1, xy=np.zeros((0, 2), np.float32),
                       level=np.zeros(0, np.int32), desc=np.zeros((0, 8), np.uint32),
                       angle=np.zeros(0, np.float32), depth=np.zeros(0, np.float32),
                       u_right=np.zeros(0, np.float32), valid=np.zeros(0, bool),
                       point_idx=np.zeros(0, np.int64), T_cw=np.asarray(T_cw, np.float32))


def _load(path: str, system) -> None:
    from pointslot_torch.slam.objects import ObjectKeyFrameRec, ObjectTrack
    from pointslot_torch.slam.tracking import TrajectoryEntry

    z = np.load(path, allow_pickle=False)
    m = system.map
    for f in _MAP_FIELDS:
        if f"map/{f}" in z:          # tolerate checkpoints from older schemas
            getattr(m, f)[...] = z[f"map/{f}"]
    m._next_uid = int(z["map/next_uid"])

    tr = system.tracker
    if "tracker/state" in z:
        tr.state = int(z["tracker/state"])
        tr.ref_kf = int(z["tracker/ref_kf"])
        tr.last_kf_frame_id = int(z["tracker/last_kf_frame_id"])
        # no per-frame features are persisted: resume without a velocity
        # model, so the next frame re-acquires via reference-KF tracking.
        # The last frame comes back as its pose alone (no features), which
        # seeds that tracking and the next velocity; the reference saves
        # this pose but seeds from the reference keyframe's
        tr.velocity = None
        tr.last_frame = _pose_only_frame(z["tracker/last_T_cw"]) if tr.ref_kf >= 0 else None
    tr._feats = (None, None)
    tr.n_lost_frames = 0
    system.local_mapper.recent_points.clear()
    system._prev_flow = None

    lc = system.loop_closer
    if lc is not None:
        lc.abort_gba()   # an in-flight global BA's merge is now stale
        lc._consistent_groups = []
        # rebuild the loop-closing BoW database from the restored keyframes
        lc.db.clear()
        for kf in m.keyframe_ids():
            lc.db.add(int(kf), m.kf_desc[kf], m.kf_feat_valid[kf])

    if system._fast is not None:
        if tr.ref_kf >= 0:
            system._fast.refresh(m, tr.ref_kf)
        else:
            system._fast.invalidate()

    tr.trajectory = [
        TrajectoryEntry(frame_id=int(f), ref_kf=int(r), ref_uid=int(u), T_rel=T, lost=bool(lost))
        for f, r, u, T, lost in zip(z["traj/frame_id"], z["traj/ref_kf"], z["traj/ref_uid"],
                                    z["traj/T_rel"], z["traj/lost"])
    ]

    objsys = system._object_system
    if objsys is not None and "obj/n_tracks" in z:
        objsys.all_tracks = []
        objsys.tracks = {}
        objsys._pending_okfs = {}
        for i in range(int(z["obj/n_tracks"])):
            t = ObjectTrack(
                track_id=int(z[f"obj/{i}/track_id"]),
                dims=z[f"obj/{i}/dims"],
                max_points=len(z[f"obj/{i}/pt_valid"]),
            )
            for s in _TRACK_SCALARS:
                setattr(t, s, z[f"obj/{i}/{s}"].item())
            for a in _TRACK_ARRAYS:
                if f"obj/{i}/{a}" in z:   # fields added later stay at defaults
                    setattr(t, a, z[f"obj/{i}/{a}"].copy())
            frames = z[f"obj/{i}/frames"]
            for k, f in enumerate(frames):
                t.poses_cf[int(f)] = z[f"obj/{i}/poses_cf"][k]
                t.poses_world[int(f)] = z[f"obj/{i}/poses_world"][k]
            for j in range(int(z[f"obj/{i}/n_okf"])):
                kw = {a: z[f"obj/{i}/okf/{j}/{a}"].copy() for a in _OKF_ARRAYS}
                t.keyframes.append(ObjectKeyFrameRec(
                    obj_kf_id=j, frame_id=int(z[f"obj/{i}/okf/{j}/frame_id"]), **kw))
            objsys.all_tracks.append(t)
            objsys.tracks[t.track_id] = t
