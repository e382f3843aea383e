"""The detector's training in the port against the JAX package's, on the CPU.

pointslot_torch.detect.train (device="cpu") beside pointslot_tpu.detect.
train, on the same numpy inputs, at a small size: YOLO width 4, input 64,
batch 2. The JAX ``YoloTrainer`` is built once for the file.

- ``build_targets``: bit-equal, on batches with two boxes in one cell and
  anchor (the later one wins), a box of 2 px (skipped) and centres past
  the image edge (clipped, then truncated), at inputs 64 and 320.
- ``detection_loss`` fed the same heads: the loss and its three terms
  within 1e-5 relative, the gradient with respect to each head within
  1e-5 x that head's largest gradient.
- flax's BatchNorm in its training form (``BatchNorm.train()``), on an
  input whose mean is 6x its spread: outputs within 2e-5 x max|y| (the
  fast variance E[x^2] - E[x]^2 cancels 37x here, so the summation order
  moves it by about 1e-5 relative) and running statistics within 1e-6
  after one step, at eps 1e-5 and 1e-3 (torch_pad); then ``eval()`` on
  the new statistics within 2e-5 x max|y|; the whole YOLOv5 in training form: heads
  within 1e-4 x max|head| and every running statistic within 1e-5.
- Three trainer steps, each from the JAX trainer's state before it
  (variables and Adam moments), against the JAX trainer's own step run in
  float64 (``jax.enable_x64``) from its initial variables. The float64
  run is the reference because float32 on this CPU cannot be one: through
  batch statistics of 8-sample maps, XLA's float32 gradients sit up to
  1.3e-3 of a tensor's largest gradient from the float64 ones and the
  port's 3.7e-4, and Adam turns any gradient inside that noise into a
  move of +-lr of either sign, so a free run parts after one step. Held
  to:
  - the loss and its terms within 1e-5 relative;
  - the gradients within GRAD_REL = 1e-3 x each tensor's largest;
  - the running statistics within 1e-5;
  - the parameters within 1e-6 of the reference optimizer's (optax
    ``adamw``, in float64) update of the same state by the port's own
    gradient;
  - and so under the Adam rule: Adam's step is lr m / sqrt(v), so a
    gradient gap d moves an element's step by at most about lr d / |g|,
    and a gradient inside the noise may flip the step's sign. Each element
    is held within 1e-6 + 2 lr min(1, 2 max(d, 1e-6) / |g|) of the
    reference: 2 lr where the gradient is noise-sized (or under 1e-6),
    and as tight as the gradient gap allows elsewhere.
- The recipe's CLI (``python -m pointslot_torch.detect.train_synthetic``)
  for 2 steps, ``--device cpu``, on the first 3 frames of the first of its
  scenes (the rest patched out, to keep the rendering short): the npz it writes
  loads in the JAX package's ``Detector.load_npz`` and gives the port's
  heads (1e-4 x max|head|).
"""

import functools

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
import optax

from pointslot_tpu.detect import train as jtrain
from pointslot_tpu.detect import yolo as jyolo
from pointslot_torch import convert
from pointslot_torch.detect import layers, train, train_synthetic, yolo

S, B, WIDTH, LR, STEPS = 64, 2, 4, 2e-3, 3
LOSS_REL = 1e-5
HEAD_GRAD_REL = 1e-5
GRAD_REL = 1e-3
PARAM_ATOL = 1e-6
STATS_ATOL = 1e-5
HEAD_REL = 1e-4
BN_REL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, size=S, batch=B):
    """tests/test_yolo_train.py's make_batch at a small input: bright boxes
    on a dark image, 2-3 per image, every level's anchors matched."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0.1, 0.3, size=(batch, size, size, 3)).astype(np.float32)
    boxes = np.zeros((batch, 4, 4), np.float32)
    classes = np.full((batch, 4), 2, np.int64)
    n_boxes = np.array([2, 3][:batch] + [2] * max(batch - 2, 0), np.int64)
    for b in range(batch):
        for m in range(n_boxes[b]):
            w, h = rng.uniform(size * 0.15, size * 0.7), rng.uniform(size * 0.12, size * 0.6)
            cx = rng.uniform(w / 2 + 1, size - w / 2 - 1)
            cy = rng.uniform(h / 2 + 1, size - h / 2 - 1)
            boxes[b, m] = [cx, cy, w, h]
            classes[b, m] = (2, 7, 0)[m]
            imgs[b, int(cy - h / 2):int(cy + h / 2), int(cx - w / 2):int(cx + w / 2)] = \
                rng.uniform(0.6, 0.9)
    return imgs, boxes, classes, n_boxes


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(tree):
    """Floating leaves as float64 (under jax.enable_x64)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(jnp.result_type(a), jnp.floating)
        else jnp.asarray(a), tree)


@pytest.fixture(scope="module")
def reference():
    """The JAX trainer's own step, run in float64 three times from its
    initial variables on one batch: for each step the state before it
    (variables and Adam moments), its loss and terms, its gradient (from the
    first moments: mu' = 0.9 mu + 0.1 g) and the variables after it."""
    # the trainer's flax init runs op by op (about 35 s on a CPU); jitted,
    # it gives the same variables bit for bit in about a third of that
    mp = pytest.MonkeyPatch()
    init = jyolo.YOLOv5.init
    mp.setattr(jyolo.YOLOv5, "init", lambda self, *a, **k: jax.jit(
        functools.partial(init, self), static_argnames="train")(*a, **k))
    try:
        jt = jtrain.YoloTrainer(input_size=S, width=WIDTH, lr=LR)
    finally:
        mp.undo()
    batch = _batch()
    steps = []
    with jax.enable_x64(True):
        step = jax.jit(jt._step_impl)
        variables, opt_state = _f64(jt.variables), _f64(jt.opt_state)
        images = _f64(batch[0])
        targets = _f64(list(jtrain.build_targets(*batch[1:], S)))
        for _ in range(STEPS):
            adam = opt_state[0]
            before = dict(variables=_np_tree(variables), opt_state=_np_tree(opt_state),
                          count=int(adam.count), mu=_np_tree(adam.mu), nu=_np_tree(adam.nu))
            variables, opt_state, loss, aux = step(variables, opt_state, images, targets)
            mu = convert.flat_flax(_np_tree(opt_state[0].mu))
            mu0 = convert.flat_flax(before["mu"])
            steps.append(dict(before=before, loss=float(loss),
                              aux={k: float(v) for k, v in aux.items()},
                              grads={k: (mu[k] - 0.9 * mu0[k]) / 0.1 for k in mu},
                              after=convert.flat_flax(_np_tree(variables))))
    return batch, steps, jt.tx


def _port_trainer(state):
    """A port trainer holding the reference's variables and Adam moments."""
    tr = convert.yolo_trainer_from_flax(state["variables"], input_size=S, lr=LR, device="cpu")
    if state["count"]:
        stats = state["variables"]["batch_stats"]
        mu = convert.detector_from_flax({"params": state["mu"], "batch_stats": stats})
        nu = convert.detector_from_flax({"params": state["nu"], "batch_stats": stats})
        for p, m, v in zip(tr.model.parameters(), mu.parameters(), nu.parameters()):
            tr.opt.state[p] = {"step": torch.tensor(float(state["count"])),
                               "exp_avg": m.detach().clone(), "exp_avg_sq": v.detach().clone()}
    return tr


def _flax_grads(model):
    """The port's parameter gradients under flax's flat names."""
    out = {}
    for key, p in model.named_parameters():
        *path, leaf = key.split(".")
        g = p.grad.numpy()
        if leaf == "weight":
            out["/".join(path) + "/kernel"] = g.T if g.ndim == 2 else np.transpose(g, (2, 3, 1, 0))
        else:
            out["/".join(path) + "/" + leaf] = g
    return out


def _target_cases():
    imgs, boxes, classes, n_boxes = _batch(seed=3, size=320, batch=3)
    # two boxes in one stride-8 cell and anchor: the later one is kept
    boxes[0, 1] = boxes[0, 0] + np.array([1.5, -1.0, 2.0, 1.0], np.float32)
    boxes[1, 0, 2] = 2.0                                      # too thin: skipped
    boxes[2, 0, :2] = [330.0, -7.0]                           # centre past the edge
    n_boxes[0] = 3
    return [(boxes, classes, n_boxes, 320), (*_batch(seed=4)[1:], S)]


@pytest.mark.parametrize("case", [0, 1])
def test_build_targets_bit_equal(case):
    boxes, classes, n_boxes, size = _target_cases()[case]
    want = jtrain.build_targets(boxes, classes, n_boxes, size)
    got = train.build_targets(boxes, classes, n_boxes, size)
    assert sum(int((t[..., 4] > 0.5).sum()) for t in want) >= 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_detection_loss_and_head_gradient_match_reference():
    imgs, boxes, classes, n_boxes = _batch(seed=5)
    targets = jtrain.build_targets(boxes, classes, n_boxes, S)
    rng = np.random.default_rng(6)
    heads = [rng.normal(0, 1.5, (B, S // s, S // s, 255)).astype(np.float32)
             for s in train.STRIDES]

    def loss_fn(hs):
        return jtrain.detection_loss(hs, [jnp.asarray(t) for t in targets])

    (want, want_aux), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        [jnp.asarray(h) for h in heads])
    th = [torch.from_numpy(h).requires_grad_() for h in heads]
    got, aux = train.detection_loss(th, [torch.from_numpy(t) for t in targets])
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_REL * abs(float(want))
    for k in ("box", "obj", "cls"):
        assert abs(aux[k].item() - float(want_aux[k])) <= LOSS_REL * abs(float(want_aux[k])), k
    for t, w in zip(th, want_grads):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= HEAD_GRAD_REL * np.abs(w).max()


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_batchnorm_training_form_matches_flax(eps):
    import flax.linen as nn

    rng = np.random.default_rng(7)
    x = (3.0 + 0.5 * rng.standard_normal((4, 6, 5, 7))).astype(np.float32)   # NHWC
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32),
                   "bias": rng.uniform(-0.5, 0.5, 7).astype(np.float32)},
        "batch_stats": {"mean": rng.uniform(-1, 1, 7).astype(np.float32),
                        "var": rng.uniform(0.5, 2, 7).astype(np.float32)}}
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=eps)
    want, new = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = layers.BatchNorm(7, eps)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**variables["params"], **variables["batch_stats"]}.items()})
    got = bn.train()(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    want = np.asarray(want)
    assert np.abs(got.detach().numpy().transpose(0, 2, 3, 1) - want).max() <= BN_REL * np.abs(
        want).max()
    for k in ("mean", "var"):
        assert np.abs(getattr(bn, k).numpy() - np.asarray(new["batch_stats"][k])).max() <= 1e-6
    # eval() is the inference form again, on the updated statistics
    want_eval = nn.BatchNorm(use_running_average=True, epsilon=eps).apply(
        {"params": variables["params"], "batch_stats": new["batch_stats"]}, jnp.asarray(x))
    got_eval = bn.eval()(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    want_eval = np.asarray(want_eval)
    assert np.abs(got_eval.detach().numpy().transpose(0, 2, 3, 1) - want_eval).max() <= \
        BN_REL * np.abs(want_eval).max()


def test_yolo_training_form_matches_reference(reference):
    batch, steps, _ = reference
    variables = steps[0]["before"]["variables"]
    fmodel = jyolo.YOLOv5(width=WIDTH)
    heads, new = jax.jit(lambda v, x: fmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(batch[0]))
    model = convert.detector_from_flax(variables).train()
    got = model(torch.from_numpy(np.ascontiguousarray(batch[0].transpose(0, 3, 1, 2))))
    for g, w in zip(got, heads):
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() <= HEAD_REL * np.abs(w).max()
    flat = convert.flax_from_module(model)
    for k, w in convert.flat_flax({"batch_stats": _np_tree(new["batch_stats"])}).items():
        assert np.abs(flat[k] - w).max() <= STATS_ATOL, k


def _optax_params(tx, before, grads):
    """The reference optimizer's parameters after one update of `before`
    by `grads` (flat flax names), in float64."""
    params = before["variables"]["params"]
    tree = flax.traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in grads.items()})
    with jax.enable_x64(True):
        upd, _ = jax.jit(tx.update)(_f64(tree), _f64(before["opt_state"]), _f64(params))
        return convert.flat_flax({"params": _np_tree(optax.apply_updates(_f64(params), upd))})


@pytest.mark.parametrize("k", range(STEPS))
def test_trainer_step_matches_reference(reference, k):
    batch, steps, tx = reference
    ref = steps[k]
    tr = _port_trainer(ref["before"])
    loss, aux = tr.step(*batch)
    assert abs(loss - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
    for name in ("box", "obj", "cls"):
        assert abs(aux[name] - ref["aux"][name]) <= LOSS_REL * abs(ref["aux"][name]), name
    grads = _flax_grads(tr.model)
    got = convert.flax_from_module(tr.model)
    optimizer = _optax_params(tx, ref["before"], grads)
    for key, want in ref["after"].items():
        if key.startswith("batch_stats/"):
            assert np.abs(got[key] - want).max() <= STATS_ATOL, key
            continue
        name = key[len("params/"):]
        g_ref, g_gap = ref["grads"][name], np.abs(grads[name] - ref["grads"][name])
        assert g_gap.max() <= GRAD_REL * np.abs(g_ref).max(), key
        # the update is optax's for the port's own gradient ...
        assert np.abs(got[key] - optimizer[key]).max() <= PARAM_ATOL, key
        # ... and so within the Adam rule of the reference's parameters
        bound = PARAM_ATOL + 2 * LR * np.minimum(
            1.0, 2 * np.maximum(g_gap, 1e-6) / np.maximum(np.abs(g_ref), 1e-30))
        gap = np.abs(got[key] - want)
        assert (gap <= bound).all(), (key, float((gap / bound).max()))


def test_recipe_cli_writes_weights_both_packages_load(tmp_path, monkeypatch):
    out = str(tmp_path / "w8.npz")
    monkeypatch.setattr(train_synthetic, "SEEDS", train_synthetic.SEEDS[:1])
    monkeypatch.setattr(train_synthetic, "SCENE", dict(train_synthetic.SCENE, n_frames=3))
    train_synthetic.main(["--steps", "2", "--size", str(S), "--device", "cpu", "--out", out])
    jd = jyolo.Detector(input_size=S, width=8, params={})
    jd.load_npz(out)
    pd = yolo.Detector(input_size=S, width=8, device="cpu")
    pd.load_npz(out)
    x = np.random.default_rng(8).uniform(0, 1, (1, S, S, 3)).astype(np.float32)
    want = jax.jit(jd.model.apply)(jd.variables, jnp.asarray(x))
    got = pd.heads(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= HEAD_REL * np.abs(w).max()
