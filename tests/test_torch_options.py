"""The options of modes 0 and 4 that the port's System runs since the
object-matching, vocabulary and distortion slice, on the CPU, and their
refusal without a card.

Each option builds a System with ``device="cpu"`` that tracks two frames
of a 512x256 scene to state OK: ``objects.use_gms``,
``objects.use_offline_flow`` (given flow maps), ``loop.vocab_path`` with a
binary, a gzip-compressed binary and a text vocabulary file,
``loop.vocab_as_tree`` with a file, and a distorted camera. The same
configurations with the default device, the card, raise on a machine
without one (the port never falls back to the CPU). What still raises
``NotImplementedError``: ``runtime.pipeline_stages`` (ROADMAP item 15);
a precomputed frame is used since the runner slice
(tests/test_torch_system.py).

About 25 s alone, on one torch thread.
"""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

from pointslot_torch import config
from pointslot_torch.datasets import synthetic
from pointslot_torch.slam.loop_closing import KeyFrameDatabase
from pointslot_torch.slam.objects import Detection
from pointslot_torch.slam.system import System
from pointslot_torch.slam.tracking import TrackingState
from pointslot_torch.vocab import tree
from test_torch_tree_vocab import write_text_vocabulary

CAM = dict(width=512, height=256, fx=300.0, fy=300.0, cx=256.0, cy=128.0, bf=60.0)
OBJECTS = dict(init_min_features=10, init_min_map_points=8, min_tracked_points=8,
               track_min_features=10, set_init_position_by_points=False)
OPTIONS = ["use_gms", "use_offline_flow", "vocab bin", "vocab bin.gz", "vocab txt",
           "vocab_as_tree", "distorted"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    sc = synthetic.make_scene(n_frames=2, n_points=2500, n_objects=2, seed=31,
                              forward_speed=0.8, camera=config.CameraConfig(**CAM))
    renderer = synthetic.SyntheticRenderer(sc)
    rows = synthetic.offline_detection_rows(sc)
    return [renderer.render(i) for i in range(2)], rows


def _write_vocab(directory, fmt):
    """A small tree (k = 4, depth = 3: 64 words) as a DBoW2 file."""
    vocab = tree.TreeVocabulary.synthesize(k=4, depth=3, seed=1, device="cpu")
    path = directory / f"voc.{fmt}"
    if fmt == "txt":
        write_text_vocabulary(str(path), vocab)
    else:
        plain = directory / "voc.bin"
        vocab.save_binary(str(plain))
        if fmt == "bin.gz":
            with gzip.open(path, "wb") as g:
                g.write(plain.read_bytes())
    return str(path)


def _config(option, directory):
    cfg = config.SystemConfig(camera=config.CameraConfig(**CAM),
                              tracking=config.TrackingConfig(min_init_stereo_features=350),
                              loop=config.LoopConfig(enabled=False))
    if option in ("use_gms", "use_offline_flow"):
        return cfg.replace(slot_mode=config.SLOTMode.OFFLINE,
                           objects=config.ObjectConfig(**OBJECTS, **{option: True}))
    if option.startswith("vocab"):
        fmt = option.split()[1] if " " in option else "bin"
        return cfg.replace(loop=config.LoopConfig(
            vocab_path=_write_vocab(directory, fmt),
            vocab_as_tree=True if option == "vocab_as_tree" else None))
    return cfg.replace(camera=config.CameraConfig(**CAM, k1=-0.05))


@pytest.mark.parametrize("option", OPTIONS)
def test_system_tracks_with_option(scene, tmp_path, option):
    frames, rows = scene
    cfg = _config(option, tmp_path)
    system = System(cfg, device="cpu")
    if option.startswith("vocab"):
        db = system.loop_closer.db
        sparse = isinstance(db, tree.SparseKeyFrameDatabase)
        assert sparse == (option == "vocab_as_tree")
        assert sparse or isinstance(db, KeyFrameDatabase)
        assert system.loop_closer.vocab.n_words == 64
    for i, (left, right, inst) in enumerate(frames):
        kw = {}
        if cfg.slot_mode == config.SLOTMode.OFFLINE:
            fr = rows[(rows[:, 0] == i) & (rows[:, 1] >= 0)]
            kw = dict(detections=[Detection.from_row24(r, mask_value=int(r[1]) + 1)
                                  for r in fr], instance_mask=inst)
            if cfg.objects.use_offline_flow:
                kw["flow"] = np.zeros(inst.shape + (2,), np.float32)
        system.track_stereo(left, right, timestamp=i * 0.1, frame_id=i, **kw)
        assert system.tracking_state == TrackingState.OK
    if cfg.objects.use_offline_flow:
        assert system._prev_flow is not None
    if cfg.slot_mode == config.SLOTMode.OFFLINE:
        assert len(system._object_system.all_tracks) == 2
    system.shutdown()


@pytest.mark.parametrize("option", OPTIONS)
def test_option_on_cuda_without_card_raises(tmp_path, option):
    """The entry point defaults to the card and does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg = _config(option, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        System(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        System(dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=True)))
