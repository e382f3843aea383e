"""The ReID embedder's training in the port against the JAX package's, on
the CPU, at a small size: 8 identities, batch 8.

- ``make_identity_bank`` within 1e-6 of jax.image.resize's bicubic (the
  port builds Keys' a = -0.5 weights in numpy and contracts them in
  another order), at 8 and 64 identities.
- ``sample_crops`` bit-equal on the same bank, drawing the same numbers
  from the generator (its next draw is equal too).
- ``ReIDNet`` in its training form: embeddings within 1e-5 and running
  statistics within 1e-6.
- Three training steps, each from the state before it (network, head,
  Adam moments), against the JAX training's own step run in float64
  (``jax.enable_x64``). The JAX ``train`` is run once for the file with
  its ``jax.jit`` wrapped, so that the step it compiles is kept; replayed
  in float32 from the same start on the same crops it reaches ``train``'s
  result bit for bit, and replayed in float64 it gives the reference, for
  the reason tests/test_torch_train.py gives: XLA's float32 gradients on
  a CPU sit up to 2.6e-2 of a tensor's largest gradient from the float64
  ones (the port's: 3.5e-5). The start is the JAX training's own
  initial network and softmax head (``convert.reid_training_from_flax``).
  Held to:
  - the loss within 1e-5 relative, the accuracy equal;
  - the gradients within GRAD_REL = 3e-2 x each tensor's largest. ReLU
    is not smooth: where an activation sits within float32 rounding of
    zero, float32 and float64 switch its path differently, and the
    gradients of the layers below it move by up to 9.4e-3 of a tensor's
    largest (measured on 5 seeds x 3 steps, in 3 of the 15; 3.5e-5 in
    the others, this file's seed among them);
  - the running statistics within 1e-5;
  - the parameters (the head too) within 1e-6 of optax ``adam``'s update
    (in float64) of the same state by the port's own gradient, and so
    within the Adam rule of tests/test_torch_train.py against the
    reference: 1e-6 + 2 lr min(1, 2 max(d, 1e-6) / |g|) for a gradient
    gap d.
- The CLI (``python -m pointslot_torch.detect.train_reid``) for 2 steps
  with ``--device cpu``: the npz it writes loads in the JAX package's
  ``ReIDEmbedder.load_npz`` and gives the port's features within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
import optax

from pointslot_tpu.detect import reid as jreid
from pointslot_tpu.detect import train_reid as jtr
from pointslot_torch import convert
from pointslot_torch.detect import reid, train_reid

N_IDS, BATCH, STEPS, SEED, LR = 8, 8, 3, 0, 1e-3
BANK_ATOL = 1e-6
LOSS_REL = 1e-5
GRAD_REL = 3e-2
PARAM_ATOL = 1e-6
STATS_ATOL = 1e-5
FEATURE_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine; the
    port's CPU runs here take one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _KeepJit:
    """``jax`` as the JAX train_reid module sees it, with ``jit`` keeping
    the function it compiles (its training step)."""

    def __init__(self):
        self.jitted = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        self.jitted.append(jax.jit(fn, **kw))
        return self.jitted[-1]


def _f64(tree):
    """Floating leaves as float64 (under jax.enable_x64)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(jnp.result_type(a), jnp.floating)
        else jnp.asarray(a), tree)


def _start():
    """JAX train's initial network, head and batch statistics."""
    key = jax.random.PRNGKey(SEED)
    variables = jreid.ReIDNet(features=128).init(key, jnp.zeros((1, 128, 64, 1)), train=True)
    params = {"net": variables["params"], "head": jax.random.normal(key, (128, N_IDS)) * 0.05}
    return params, variables["batch_stats"]


def _replay(step, start, bank, x64: bool):
    """JAX train's step from train's own start (network, head, Adam state)
    on train's crops: per step the state before it, the crops, and the
    loss, accuracy, gradient (from Adam's first moments) and state after."""
    cast = _f64 if x64 else (lambda t: t)
    params, stats = cast(start[0]), cast(start[1])
    opt_state = optax.adam(LR).init(params)
    rng = np.random.default_rng(SEED)
    steps = []
    for _ in range(STEPS):
        x, y = jtr.sample_crops(bank, rng, BATCH)
        before = dict(params=_np_tree(params), stats=_np_tree(stats),
                      opt_state=_np_tree(opt_state), count=int(opt_state[0].count),
                      mu=_np_tree(opt_state[0].mu), nu=_np_tree(opt_state[0].nu))
        params, stats, opt_state, loss, acc = step(params, stats, opt_state,
                                                   cast(jnp.asarray(x)), jnp.asarray(y))
        mu = _np_tree(opt_state[0].mu)
        grads = jax.tree_util.tree_map(lambda a, b: (a - 0.9 * b) / 0.1, mu, before["mu"])
        steps.append(dict(before=before, x=x, y=y, loss=float(loss), acc=float(acc),
                          grads=grads, params=_np_tree(params), stats=_np_tree(stats)))
    return steps


@pytest.fixture(scope="module")
def reference():
    """JAX ``train``'s result, its step replayed in float32 and the
    float64 replay."""
    keep = _KeepJit()
    mp = pytest.MonkeyPatch()
    mp.setattr(jtr, "jax", keep)
    # the network's flax init runs op by op; jitted, the same variables bit
    # for bit, sooner
    init = jreid.ReIDNet.init
    mp.setattr(jreid.ReIDNet, "init", lambda self, *a, **k: jax.jit(
        functools.partial(init, self), static_argnames="train")(*a, **k))
    try:
        result, _ = jtr.train(n_ids=N_IDS, steps=STEPS, batch=BATCH, seed=SEED, lr=LR)
        start = _start()
    finally:
        mp.undo()
    (step,) = keep.jitted
    bank = jtr.make_identity_bank(N_IDS, SEED)
    replay32 = _replay(step, start, bank, x64=False)
    with jax.enable_x64(True):
        replay64 = _replay(step, start, bank, x64=True)
    return _np_tree(result), replay32, replay64


def _port_trainer(state):
    """A port ReIDTrainer holding the replay's network, head and moments."""
    net, head = convert.reid_training_from_flax(
        {"params": state["params"]["net"], "batch_stats": state["stats"]},
        state["params"]["head"])
    tr = train_reid.ReIDTrainer(net, head, LR, device="cpu")
    if state["count"]:
        def moments(tree):
            m, h = convert.reid_training_from_flax(
                {"params": tree["net"], "batch_stats": state["stats"]}, tree["head"])
            return [*m.parameters(), h]

        for p, m, v in zip([*tr.net.parameters(), tr.head], moments(state["mu"]),
                           moments(state["nu"])):
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


def _optax_params(before, grads):
    """optax ``adam(lr)``'s (what JAX train builds) parameters after one
    update of `before` by `grads` ({"net": tree, "head": array}), in
    float64."""
    tx, params = optax.adam(LR), before["params"]
    with jax.enable_x64(True):
        upd, _ = jax.jit(tx.update)(_f64(grads), _f64(before["opt_state"]), _f64(params))
        return _np_tree(optax.apply_updates(_f64(params), upd))


def _assert_step(key, got, want, optimizer, g_got, g_ref):
    """The gradient (within GRAD_REL of the tensor's largest), optax's
    update of the port's own gradient, and the Adam rule against the
    reference's parameters."""
    scale, g_gap = np.abs(g_ref).max(), np.abs(g_got - g_ref)
    assert g_gap.max() <= GRAD_REL * scale, (key, g_gap.max() / scale)
    assert np.abs(got - optimizer).max() <= PARAM_ATOL, key
    bound = PARAM_ATOL + 2 * LR * np.minimum(
        1.0, 2 * np.maximum(g_gap, 1e-6) / np.maximum(np.abs(g_ref), 1e-30))
    gap = np.abs(got - want)
    assert (gap <= bound).all(), (key, float((gap / bound).max()))


@pytest.mark.parametrize("n_ids,seed", [(8, 0), (64, 101)])
def test_identity_bank_matches_reference(n_ids, seed):
    want = jtr.make_identity_bank(n_ids, seed)
    got = train_reid.make_identity_bank(n_ids, seed)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= BANK_ATOL


def test_sample_crops_bit_equal():
    bank = jtr.make_identity_bank(N_IDS, 3)
    r_ref, r_got = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        want, want_ids = jtr.sample_crops(bank, r_ref, 16)
        got, got_ids = train_reid.sample_crops(bank, r_got, 16)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(got_ids, want_ids)
    assert r_got.uniform() == r_ref.uniform()


def test_reid_training_form_matches_reference(reference):
    _, steps, _ = reference
    state = steps[0]["before"]
    variables = {"params": state["params"]["net"], "batch_stats": state["stats"]}
    want, new = jreid.ReIDNet(features=128).apply(
        variables, jnp.asarray(steps[0]["x"]), train=True, mutable=["batch_stats"])
    net = convert.reid_from_flax(variables).train()
    got = net(torch.from_numpy(steps[0]["x"]).permute(0, 3, 1, 2))
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= FEATURE_ATOL
    flat = convert.flax_from_module(net)
    for k, w in convert.flat_flax({"batch_stats": _np_tree(new["batch_stats"])}).items():
        assert np.abs(flat[k] - w).max() <= 1e-6, k


def test_replayed_reference_reaches_train_result(reference):
    result, steps, _ = reference
    want = convert.flat_flax(result)
    got = convert.flat_flax({"params": steps[-1]["params"]["net"],
                             "batch_stats": steps[-1]["stats"]})
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("k", range(STEPS))
def test_reid_step_matches_reference(reference, k):
    _, _, steps = reference
    ref = steps[k]
    tr = _port_trainer(ref["before"])
    loss, acc = tr.step(ref["x"], ref["y"])
    assert abs(loss.item() - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
    assert acc.item() == ref["acc"]
    got = convert.flax_from_module(tr.net)
    grads = _flax_grads(tr.net)
    want = convert.flat_flax({"params": ref["params"]["net"], "batch_stats": ref["stats"]})
    g_ref = convert.flat_flax(ref["grads"]["net"])
    tree = flax.traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in grads.items()})
    optimizer = _optax_params(ref["before"], {"net": tree, "head": tr.head.grad.numpy()})
    net_opt = convert.flat_flax({"params": optimizer["net"]})
    for key, w in want.items():
        if key.startswith("batch_stats/"):
            assert np.abs(got[key] - w).max() <= STATS_ATOL, key
        else:
            name = key[len("params/"):]
            _assert_step(key, got[key], w, net_opt[key], grads[name], g_ref[name])
    _assert_step("head", tr.head.detach().numpy(), ref["params"]["head"], optimizer["head"],
                 tr.head.grad.numpy(), ref["grads"]["head"])


def test_cli_writes_weights_both_packages_load(tmp_path):
    out = str(tmp_path / "reid.npz")
    train_reid.main([out, "--device", "cpu", "--steps", "2"])
    je = jreid.ReIDEmbedder(params={})
    je.load_npz(out)
    pe = reid.ReIDEmbedder(device="cpu")
    pe.load_npz(out)
    crops, _ = train_reid.sample_crops(train_reid.make_identity_bank(4, 5),
                                       np.random.default_rng(2), 6)
    want = np.asarray(je._forward(jnp.asarray(crops)))
    with torch.no_grad():
        got = pe.net(torch.from_numpy(crops).permute(0, 3, 1, 2)).numpy()
    assert np.abs(got - want).max() <= FEATURE_ATOL
