"""A run with the timed path broken underneath comes out not correct, and
the bfloat16 control in the program's place does too, while the unbroken
run at the same small size comes out correct. Each drives the whole run on
the CPU (the look for a card is the entry point's, which this skips)."""

import dataclasses

import pytest

from pointslot_torch.ops import orb, stereo
from pointslot_torch.slam.object_system import ObjectSystem
from pointslot_torch.slam.tracking import CameraTracker
from slotbench.tests.helpers import small_run

CELL = "mode0.drive"


def test_unbroken_run_is_correct():
    res = small_run(CELL)
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert res["correct"], res["checks"]


def test_control_is_not_correct():
    res = small_run(CELL, control=True)
    assert not res["correct"]
    failing = [k for k, c in res["checks"].items() if not c["value"] <= c["limit"]]
    assert {"angle_p99_rad", "desc_bits_share", "disparity_p99_px"} <= set(failing)


def _state_unchanged(monkeypatch):
    """Tracking returns the last frame's state: the pose does not move."""
    track = CameraTracker.track

    def frozen(self, frame):
        if self.state != 1 or len(self.trajectory) < 6:
            return track(self, frame)
        frame.T_cw = self.last_frame.T_cw.copy()
        self.trajectory.append(dataclasses.replace(self.trajectory[-1],
                                                   frame_id=frame.frame_id))
        self.last_frame = frame

    monkeypatch.setattr(CameraTracker, "track", frozen)


def _half_keypoints(monkeypatch):
    """Half of the frame's keypoints are left out: every other one is
    marked invalid where the frontend selects them."""
    detect = orb.ORBExtractor.detect

    def half(self, scores):
        xyl, xy, resp, lvl, valid = detect(self, scores)
        valid = valid.clone()
        valid[..., 1::2] = False
        return xyl, xy, resp, lvl, valid

    monkeypatch.setattr(orb.ORBExtractor, "detect", half)


def _half_batch(monkeypatch):
    """The descriptors of half of the frame's keypoints are left out."""
    describe = orb.ORBExtractor._descriptors_from_patches

    def half(self, blurred, angles):
        d = describe(self, blurred, angles)
        d[d.shape[0] // 2:] = 0
        return d

    monkeypatch.setattr(orb.ORBExtractor, "_descriptors_from_patches", half)


def _answer_altered(monkeypatch):
    """The stereo match's right position is moved where it is produced."""
    refine = stereo.sad_refine_from_patches

    def moved(*args, **kwargs):
        u_right, depth, valid = refine(*args, **kwargs)
        return u_right + valid * 1.0, depth, valid

    monkeypatch.setattr(stereo, "sad_refine_from_patches", moved)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_keypoints, _half_batch,
                                   _answer_altered],
                         ids=["state_unchanged", "half_keypoints", "half_batch",
                              "answer_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = small_run(CELL)
    assert not res["correct"], res["checks"]


def test_half_of_the_cars_left_out_is_not_correct(monkeypatch):
    """The object system drops every other car's detection before it
    tracks: those cars never hold a track."""
    process = ObjectSystem.process_frame

    def half(self, frame, left, right, detections, *args, **kwargs):
        kept = [d for d in detections or () if d.track_id % 2 == 0]
        return process(self, frame, left, right, kept, *args, **kwargs)

    monkeypatch.setattr(ObjectSystem, "process_frame", half)
    # car 3 (parked) is shown within 30 m from frame 14 to 39 of the drive
    res = small_run("mode4.drive_cars4", frames=36)
    assert res["checks"]["cars_untracked"]["value"] >= 1, res["checks"]
    assert not res["correct"]
