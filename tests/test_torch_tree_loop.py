"""Loop closing through a tree vocabulary loaded from a DBoW2 binary file,
the port's System against the JAX package's, on the CPU.

The reduced loop configuration and scene of tests/test_torch_loop_system.py
(512x256, camera BA caps 8 / 1024, the GBA inline, 33 frames of
make_loop_scene(n_frames=32, seed=41, radius=5.0)). A tree vocabulary
(k = 8, depth = 3) is trained on the port's ORB descriptors of three of
the scene's frames, as tests/test_tree_vocab.py:175-199 trains one, and
written with ``save_binary``; both Systems load it through
``loop.vocab_path`` with ``vocab_as_tree=True``, so the loop closer
queries the sparse inverted-index database. Gates: each System closes the
loop, and the port's ATE is at most 1.1x the JAX run's (the bound of
tests/test_torch_loop_system.py's own System test).

About 100 s alone, on one torch thread; the JAX System is half of it.
"""

import numpy as np
import pytest
import torch

from pointslot_tpu import config as jconfig
from pointslot_tpu.parallel import runtime as jruntime
from pointslot_tpu.slam import system as jsystem
from pointslot_tpu.vocab import tree as jtree
from pointslot_torch import config
from pointslot_torch.convert import desc_to_numpy
from pointslot_torch.datasets import synthetic
from pointslot_torch.ops.orb import ORBExtractor
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState
from pointslot_torch.vocab import tree

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
N_FRAMES = 33


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg, vocab_path):
    return pkg.SystemConfig(
        camera=pkg.CameraConfig(**CAM),
        ba=pkg.BAConfig(max_ba_keyframes=8, max_ba_points=1024),
        tracking=pkg.TrackingConfig(min_init_stereo_features=300),
        loop=pkg.LoopConfig(background_gba=False, min_frame_distance=10,
                            min_kfs_before_detect=6, vocab_path=vocab_path,
                            vocab_as_tree=True),
    )


def _ate(sc, traj) -> float:
    A = sc.poses_world[traj[0][0]]
    errs = [np.linalg.norm((A @ np.linalg.inv(T))[:3, 3] - sc.poses_world[f][:3, 3])
            for f, T, _ in traj]
    return float(np.sqrt(np.mean(np.square(errs))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sc = synthetic.make_loop_scene(n_frames=32, seed=41, radius=5.0,
                                   camera=config.CameraConfig(**CAM))
    renderer = synthetic.SyntheticRenderer(sc)
    frames = [renderer.render(i)[:2] for i in range(N_FRAMES)]
    ext = ORBExtractor(CAM["height"], CAM["width"], config.ORBConfig(), device="cpu")
    desc = []
    for i in (0, 11, 22):
        f = ext(frames[i][0])
        desc.append(desc_to_numpy(f.desc)[f.valid.numpy()])
    vocab = tree.TreeVocabulary.train(np.concatenate(desc), k=8, depth=3, seed=0,
                                      device="cpu")
    path = str(tmp_path_factory.mktemp("vocab") / "voc.bin")
    vocab.save_binary(path)

    ref = jsystem.System(_configs(jconfig, path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "default_mesh", lambda min_devices=2: None)
        for i, (left, right) in enumerate(frames):
            ref.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    port = System(_configs(config, path), device="cpu")
    for i, (left, right) in enumerate(frames):
        port.track_stereo(left, right, timestamp=i * 0.1, frame_id=i)
    port.shutdown()
    return sc, vocab, ref, port


def test_port_system_closes_the_loop_through_a_tree_file(runs):
    sc, vocab, ref, port = runs
    assert isinstance(port.loop_closer.db, tree.SparseKeyFrameDatabase)
    assert isinstance(ref.loop_closer.db, jtree.SparseKeyFrameDatabase)
    assert port.loop_closer.vocab.n_words == ref.loop_closer.vocab.n_words == vocab.n_words
    assert port.loop_closer.vocab.depth == vocab.depth + 1
    assert port.tracking_state == ref.tracking_state == TrackingState.OK
    assert not any(e.lost for e in port.tracker.trajectory)
    assert ref.loop_closer.loops_closed >= 1
    assert port.loop_closer.loops_closed >= 1
    want = _ate(sc, ref.camera_trajectory())
    got = _ate(sc, port.camera_trajectory())
    assert got <= 1.1 * want, (got, want)
