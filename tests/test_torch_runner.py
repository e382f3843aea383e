"""The port's runner (``python -m pointslot_torch.run``) against the JAX
package's, on the CPU.

A 512x256 KITTI-tracking fixture on disk (tests/test_kitti_fixture.py's
scene: seed 5, two objects, 0.4 m/frame; 4 frames), with PNG images and
16-bit instance PNGs, label_02 labels (Y at the box's bottom centre),
pose_gt.txt and a reference-schema calib.yaml that sets the camera. Every
run goes through that YAML (never the default 1242x375 camera) and runs
the port on one torch thread.

- The slice as a whole: the JAX ``run.main`` and the port's
  ``run.main --platform cpu``, mode 0, ``--sync-mapping --no-loop``: the
  camera trajectories within tests/test_torch_system.py's bound (5e-3 m
  per frame: float32 solves summed in another order; the two frontends may
  differ at FAST-cell ties), stats.json with the same keys.
- Mode 4 on the fixture: tests/test_kitti_fixture.py's artifact gates,
  plus ``evaluation.camera`` and ``evaluation.objects``.
- ``--dp 2``: ``StereoFrontend.batch``'s frames bit-equal to the
  single-pair frontend's, and the trajectory bit-equal to the run without
  ``--dp`` (the same frames reach the same tracker).
- ``--save-checkpoint`` then ``--resume``; ``--viz``; the refusals.

Two test functions: a file of two tests is handed out after the suite's
larger files under ``--dist loadfile``, beside the long
tests/test_fast_path_drift.py, rather than before it.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from pointslot_tpu import run as jrun
from pointslot_tpu.config import CameraConfig
from pointslot_tpu.datasets.synthetic import SyntheticRenderer, make_scene
from pointslot_torch import run
from pointslot_torch.datasets import png16
from pointslot_torch.datasets.kitti import KittiTrackingSequence
from pointslot_torch.datasets.synthetic import kitti_label_text
from pointslot_torch.ops.frontend import StereoFrontend

N_FRAMES = 4
CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
MAX_TRANS_GAP_M = 5e-3          # tests/test_torch_system.py


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_runner")
    cam = CameraConfig(**CAM)
    scene = make_scene(n_frames=N_FRAMES, camera=cam, n_points=2500, n_objects=2, seed=5,
                       forward_speed=0.4)
    renderer = SyntheticRenderer(scene)
    dirs = [root / "image_02" / "0000", root / "image_03" / "0000",
            root / "instances" / "0000", root / "label_02"]
    for d in dirs:
        d.mkdir(parents=True)
    for i in range(N_FRAMES):
        left, right, inst = renderer.render(i)
        name = f"{i:06d}.png"
        Image.fromarray(np.asarray(left, np.uint8)).save(dirs[0] / name)
        Image.fromarray(np.asarray(right, np.uint8)).save(dirs[1] / name)
        raw = np.where(inst > 0, 2000 + inst.astype(np.int32), 0).astype(np.uint16)
        png16.write_png16(dirs[2] / name, raw)
    (dirs[3] / "0000.txt").write_text(kitti_label_text(scene, N_FRAMES))
    np.savetxt(root / "pose_gt.txt", np.stack([T[:3, :4].reshape(-1)
                                               for T in scene.poses_world]))
    (root / "calib.yaml").write_text(
        "%YAML:1.0\n"
        + "".join(f"Camera.{k}: {v}\n" for k, v in CAM.items())
        + "Camera.fps: 10.0\nORBextractor.nFeatures: 1000\n"
          "Tracking.MinInitStereoFeatures: 300\n")
    return root


def _args(root, out, *extra):
    return ["--data", str(root), "--sequence", "0000", "--config", str(root / "calib.yaml"),
            "--out", str(out), *extra]


def _port(root, out, *extra):
    return run.main(_args(root, out, "--platform", "cpu", *extra))


def _trajectory(out):
    return np.loadtxt(out / "CameraTrajectory.txt", ndmin=2)


def test_mode0_against_jax_runner_and_dp(kitti_root, tmp_path):
    """The slice as a whole: both runners on the same files in mode 0; then
    StereoFrontend.batch against the single-pair frontend on the fixture's
    frames, and the port's runner with --dp 2 against without."""
    out, jout = tmp_path / "port", tmp_path / "jax"
    assert _port(kitti_root, out, "--mode", "0", "--sync-mapping", "--no-loop") == 0
    assert jrun.main(_args(kitti_root, jout, "--mode", "0", "--sync-mapping", "--no-loop",
                           "--no-compile-cache")) == 0
    got, want = _trajectory(out), _trajectory(jout)
    assert got.shape == want.shape == (N_FRAMES, 12)
    gap = float(np.abs(got.reshape(-1, 3, 4)[:, :, 3] - want.reshape(-1, 3, 4)[:, :, 3]).max())
    assert gap <= MAX_TRANS_GAP_M, f"translation gap {gap:.3e} m"
    stats = json.loads((out / "stats.json").read_text())
    jstats = json.loads((jout / "stats.json").read_text())
    assert sorted(stats) == sorted(jstats)
    assert sorted(stats["evaluation"]["camera"]) == sorted(jstats["evaluation"]["camera"])
    ate, jate = (x["evaluation"]["camera"]["ate"]["rmse"] for x in (stats, jstats))
    assert stats["frames"] == N_FRAMES and abs(ate - jate) <= MAX_TRANS_GAP_M, (ate, jate)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))

    seq = KittiTrackingSequence(str(kitti_root), "0000")
    pairs = [seq.load(i)[:2] for i in range(3)]
    fe = StereoFrontend(CAM["height"], CAM["width"], CAM["fx"], CAM["bf"], device="cpu")
    batch = fe.batch(np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))
    for i, (left, right) in enumerate(pairs):
        one = fe(left, right)
        for name, b, s in zip(one._fields, batch, one):
            assert b.shape[0] == len(pairs) and torch.equal(b[i], s), name
    dp = tmp_path / "dp"
    assert _port(kitti_root, dp, "--mode", "0", "--sync-mapping", "--no-loop", "--dp", "2") == 0
    assert (dp / "CameraTrajectory.txt").read_text() == (out / "CameraTrajectory.txt").read_text()


def test_mode4_checkpoint_viz_and_refusals(kitti_root, tmp_path, capsys):
    """Mode 4: tests/test_kitti_fixture.py:99-123's artifact gates on the
    port's runner, plus the evaluation. Then --max-frames 2
    --save-checkpoint with --viz (overlays and the top-down map), and
    --resume from that checkpoint (the resumed run starts from the saved
    map). Then the refusals: --platform tpu and --dp outside mode 0;
    --dataset vkitti parses and reaches the Virtual KITTI reader; without
    a card the default platform stops with the device error."""
    out = tmp_path / "out"
    assert _port(kitti_root, out, "--mode", "4", "--no-loop") == 0
    traj = (out / "CameraTrajectory.txt").read_text().strip().splitlines()
    assert len(traj) == N_FRAMES and all(len(line.split()) == 12 for line in traj)
    stats = json.loads((out / "stats.json").read_text())
    assert stats["frames"] == N_FRAMES and stats["n_keyframes"] >= 1
    det_dir = out / "ObjectDetections"
    assert sorted(os.listdir(det_dir)) == [f"{i:06d}.txt" for i in range(N_FRAMES)]
    assert sum(len((det_dir / f).read_text().strip().splitlines())
               for f in os.listdir(det_dir)) >= 1
    assert (out / "ObjectPosesCF.txt").exists() and (out / "CameraAndObjectTrajectory.txt").exists()
    ev = stats["evaluation"]
    assert ev["camera"]["frames_evaluated"] == N_FRAMES and ev["camera"]["ate"]["rmse"] < 0.2
    assert ev["objects"]["n_gt"] >= 1 and ev["objects"]["n_matched"] >= 1

    ckpt = tmp_path / "state.npz"
    out1 = tmp_path / "o1"
    assert _port(kitti_root, out1, "--mode", "0", "--no-loop", "--max-frames", "2",
                 "--save-checkpoint", str(ckpt), "--viz", "1") == 0
    assert ckpt.exists()
    assert json.loads((out1 / "stats.json").read_text())["frames"] == 2
    assert sorted(os.listdir(out1 / "viz")) == ["frame_000000.png", "frame_000001.png"]
    overlay = np.asarray(Image.open(out1 / "viz" / "frame_000001.png"))
    assert overlay.shape == (CAM["height"], CAM["width"], 3)
    assert np.asarray(Image.open(out1 / "map_topdown.png")).shape == (800, 800, 3)
    out2 = tmp_path / "o2"
    assert _port(kitti_root, out2, "--mode", "0", "--no-loop", "--resume", str(ckpt),
                 "--sync-mapping", "--max-frames", "2") == 0
    stats = json.loads((out2 / "stats.json").read_text())
    assert stats["frames"] == 2 and stats["n_keyframes"] >= 1
    # the resumed trajectory holds the two saved frames and the two new ones
    assert len((out2 / "CameraTrajectory.txt").read_text().strip().splitlines()) == 4

    for extra, msg in ((["--platform", "tpu"], "--platform 'tpu'"),
                       (["--platform", "cpu", "--mode", "4", "--dp", "2"], "--dp requires mode 0")):
        with pytest.raises(SystemExit) as e:
            run.main(_args(kitti_root, tmp_path / "x", *extra))
        assert e.value.code == 2 and msg in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="no Virtual KITTI camera dirs"):
        run.main(["--platform", "cpu", "--dataset", "vkitti", "--data", str(kitti_root),
                  "--config", str(kitti_root / "calib.yaml"), "--out", str(tmp_path / "v")])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            run.main(_args(kitti_root, tmp_path / "y", "--mode", "0"))
        assert e.value.code == 2 and "torch.cuda.is_available() is False" in capsys.readouterr().err
