"""
The port's training paths beyond the plain DUSt3R step (uniception_tpu_torch/parallel/training.py,
uniception_tpu_torch/nn/lora.py, uniception_tpu_torch/data/pipeline.py) on the CPU against the JAX package:
the flow and multi-view losses and their gradients (masks, NaN/inf sentinels, ``avg_dis``), the warmup-cosine
schedule, and two optimizer steps of each training configuration of examples/train_dust3r.py and
scripts/bench_train.py: warmup-cosine (plain, with gradient accumulation, after a skipped non-finite batch), the
DPT head (head remat on and off), mixed-aspect ManyAR batches with portrait rows, UFMFlow on NaN-sentinel
targets, the multi-view model (alternating and global), and LoRA with the JAX package's adapters. Then LoRA's
wrapping counts, its merge, its state across packages and its route under the "fused" attention.

The JAX side is the JAX ``make_train_step``'s optimizer chain (``ctx.tx``: clip, ``multi_transform`` of the
frozen leaves, ``apply_if_finite``, ``MultiSteps``, AdamW at the schedule) and state, stepped on one CPU device
with ``jax.value_and_grad`` of the same loss (its 8-device mesh step is held against the port in
tests/test_torch_training.py; one device compiles in a third of the time). The port's seeded weights go into a
JAX module built from its abstract shapes (no initializer compiled), and JAX-side adapters come back with
``state_dict_from_module`` -> ``load_state_dict_numpy``; inputs come from numpy. Bars are those of
tests/test_torch_training.py: fp32 5e-5, AdamW's parameters within ADAM_TOL * lr outside rounding-noise gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.factory.flow import UFMFlow as JaxUFMFlow
from uniception_tpu.models.factory.multiview import MultiViewPointmapModel as JaxMultiView
from uniception_tpu.nn import lora as jax_lora
from uniception_tpu.parallel import training as jax_training
from uniception_tpu.utils import coldstart as jcs
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch.data import pipeline
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.factory.flow import UFMFlow
from uniception_tpu_torch.models.factory.multiview import MultiViewPointmapModel
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn import blocks
from uniception_tpu_torch.nn.lora import LoRALinear, apply_lora, lora_trainable, merge_lora
from uniception_tpu_torch.parallel import training
from uniception_tpu_torch.utils import coldstart
from uniception_tpu_torch.utils.weights import load_state_dict_numpy
from tests.test_torch_multiview import _jax_tables
from tests.test_torch_quant import jax_module
from tests.test_torch_training import ADAM_TOL, GRAD_FLOOR, _close

SMALL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=64, info_sharing_depth=2,
             info_sharing_num_heads=4)
N = 4  # batch
LR = 1e-4  # the (peak) learning rate of the two-step cases: the DPT heads' exp output blows up at 1e-3



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for these small CPU models: with one thread per core in each of the test run's
    workers, torch's spinning OpenMP threads oversubscribe the cores and every worker slows severalfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

# --- losses ---------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "masked_sentinels"])
def test_flow_loss_and_its_gradient_match_jax(masked):
    rng = np.random.RandomState(0)
    flow, target = (rng.randn(2, 8, 8, 2).astype(np.float32) for _ in range(2))
    conf = 1.0 + rng.rand(2, 8, 8, 1).astype(np.float32)
    valid = None
    if masked:
        valid = rng.rand(2, 8, 8) > 0.3
        target[~valid] = np.nan
        target[~valid & (rng.rand(2, 8, 8) > 0.5)] = np.inf

    def jax_loss(f, c):
        return jax_training.flow_confidence_loss({"flow": f, "flow_conf": c}, jnp.asarray(target),
                                                 valid=None if valid is None else jnp.asarray(valid))

    ref, ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(flow), jnp.asarray(conf))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (flow, conf)]
    loss = training.flow_confidence_loss({"flow": leaves[0], "flow_conf": leaves[1]}, torch.from_numpy(target),
                                         valid=None if valid is None else torch.from_numpy(valid))
    _close(loss, ref)
    for g, r in zip(torch.autograd.grad(loss, leaves), ref_grads):
        _close(g, r)  # finite: the sentinels reach neither gradient


@pytest.mark.parametrize("norm_mode", [None, "avg_dis"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "masked_sentinels"])
def test_multiview_loss_and_its_gradient_match_jax(masked, norm_mode):
    rng = np.random.RandomState(1)
    V = 3
    pts, targets = ([rng.randn(2, 8, 8, 3).astype(np.float32) for _ in range(V)] for _ in range(2))
    confs = [1.0 + rng.rand(2, 8, 8, 1).astype(np.float32) for _ in range(V)]
    valids = None
    if masked:
        valids = [rng.rand(2, 8, 8) > 0.3 for _ in range(V)]
        for t, v, s in zip(targets, valids, (np.nan, np.inf, -np.inf)):
            t[~v] = s

    def jax_loss(p, c):
        return jax_training.multiview_confidence_loss(
            [{"pts3d": a, "conf": b} for a, b in zip(p, c)], [jnp.asarray(t) for t in targets],
            valids=None if valids is None else [jnp.asarray(v) for v in valids], norm_mode=norm_mode)

    ref, ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1))([jnp.asarray(a) for a in pts],
                                                                  [jnp.asarray(a) for a in confs])
    tp = [torch.from_numpy(a).requires_grad_() for a in pts]
    tc = [torch.from_numpy(a).requires_grad_() for a in confs]
    loss = training.multiview_confidence_loss(
        [{"pts3d": a, "conf": b} for a, b in zip(tp, tc)], [torch.from_numpy(t) for t in targets],
        valids=None if valids is None else [torch.from_numpy(v) for v in valids], norm_mode=norm_mode)
    _close(loss, ref)
    for g, r in zip(torch.autograd.grad(loss, tp + tc), ref_grads[0] + ref_grads[1]):
        _close(g, r)
    with pytest.raises(ValueError):
        training.multiview_confidence_loss([{"pts3d": tp[0], "conf": tc[0]}], [torch.from_numpy(targets[0])],
                                           norm_mode="median")


@pytest.mark.parametrize("init,peak,warmup,decay", [(0.0, 1e-3, 3, 10), (2.5e-4, 1e-3, 1, 5), (0.0, 3e-4, 0, 7),
                                                    (1e-4, 1e-3, 4, 5)])
def test_warmup_cosine_schedule_matches_optax(init, peak, warmup, decay):
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay)
    ours = training.warmup_cosine_decay_schedule(init, peak, warmup, decay)
    for count in range(decay + 3):
        np.testing.assert_allclose(ours(count), float(ref(jnp.asarray(count, jnp.int32))), rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        training.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 5)


# --- two steps of each training configuration against the JAX make_train_step's chain ------------------------


def _jax_steps(jmod, loss_fn, batches, **kw):
    "(per-batch losses, the trained model's torch-layout state) of the JAX make_train_step's chain on one device."
    ctx, params, opt_state = jax_training.make_train_step(jmod, loss_fn=loss_fn, learning_rate=kw.pop("lr", LR), **kw)
    params, opt_state = jax.device_put((params, opt_state), jax.devices()[0])

    @jax.jit
    def step(params, opt_state, *batch):
        def loss(p):
            return loss_fn(nnx.merge(ctx.graphdef, p, ctx.rest_state), *batch)

        value, grads = jax.value_and_grad(loss)(params)
        updates, opt_state = ctx.tx.update(grads, opt_state, params)
        return value, optax.apply_updates(params, updates), opt_state

    losses = []
    for b in batches:
        value, params, opt_state = step(params, opt_state, *jax.tree.map(jnp.asarray, b))
        losses.append(float(value))
    return losses, state_dict_from_module(nnx.merge(ctx.graphdef, params, ctx.rest_state))


def _torch_tree(b):
    "numpy arrays -> CPU tensors, through tuples and dicts."
    if isinstance(b, dict):
        return {k: _torch_tree(v) for k, v in b.items()}
    if isinstance(b, tuple):
        return tuple(_torch_tree(v) for v in b)
    return torch.from_numpy(np.asarray(b))


def _trainable_grads(tmod, loss_fn, batch, trainable=None):
    "{name: gradient} of one loss on ``batch`` for the parameters ``trainable`` keeps (not applied)."
    named = [(n, p) for n, p in tmod.named_parameters() if trainable is None or trainable(n)]
    loss = loss_fn(tmod, *_torch_tree(batch))
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, grads)}


def _assert_adam_close(tmod, want, g1, g2, lr):
    """Every trained element within ADAM_TOL * lr of the JAX step's, every frozen parameter bit for bit
    (tests/test_torch_training.py's rule), but for the elements whose updates rounding decides, which may stray
    and may be at most 0.1% of the elements: those whose first gradient ``g1`` is below GRAD_FLOOR (Adam's first
    update follows its sign, so they may move up to 2 lr apart), and those whose second update's first moment,
    0.9 * 0.1 * g1 + 0.1 * g2, is below the moment of a gradient at GRAD_FLOOR (the two gradients cancel, and the
    update is the ratio of rounding errors). The 0.1% counts the elements that do stray: whole blocks, such as the
    flow model's second decoder branch after its last cross-attention, have an exactly zero gradient and agree."""
    got = {k: v.detach().float().numpy() for k, v in tmod.state_dict().items()}
    assert sorted(got) == sorted(k for k in want if k in got)
    strays = total = 0
    for k in got:
        if k not in g1:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        a, b = g1[k].numpy(), g2[k].numpy()
        live = (np.abs(a) > GRAD_FLOOR) & (np.abs(0.09 * a + 0.1 * b) > 0.19 * GRAD_FLOOR)
        far = np.abs(got[k] - want[k]) > ADAM_TOL * lr
        assert not (far & live).any(), (k, np.abs(got[k] - want[k])[live].max() / lr)
        strays += int(far.sum())
        total += far.size
    assert strays <= 1e-3 * total, (strays, total)


def _carry(jax_ctor, tmod):
    "(the JAX module ``jax_ctor`` builds, holding the port module's weights; the port module)."
    jmod = _jax_tables(jax_module(jax_ctor))
    load_torch_state_dict(jmod, {k: v.numpy() for k, v in tmod.state_dict().items()}, verbose=False)
    return jmod, tmod


def _seeded(cls, **kw):
    return cls(name="t", generator=torch.Generator().manual_seed(0), **kw)


def _pair_batches(rng, h=32, w=32, n=1, views_ts=None):
    "``n`` batches (img1, img2, target1, target2) of N pairs; with ``views_ts`` the images are {img, ts} dicts."
    out = []
    for _ in range(n):
        img1, img2 = (rng.randn(N, 3, h, w).astype(np.float32) for _ in range(2))
        t1, t2 = (rng.randn(N, h, w, 3).astype(np.float32) for _ in range(2))
        if views_ts is not None:
            img1, img2 = {"img": img1, "ts": views_ts}, {"img": img2, "ts": views_ts}
        out.append((img1, img2, t1, t2))
    return out


def _dust3r_losses():
    "The trainer's DUSt3R losses (its --mixed-ar one when the image slots hold {img, ts} dicts)."
    def jax_loss(m, img1, img2, t1, t2):
        if isinstance(img1, dict):
            r1, r2 = m.forward_pair(img1["img"], img2["img"], true_shape1=img1["ts"], true_shape2=img2["ts"])
        else:
            r1, r2 = m.forward_pair(img1, img2)
        return jax_training.dust3r_confidence_loss(r1, r2, t1, t2)

    def torch_loss(m, img1, img2, t1, t2):
        if isinstance(img1, dict):
            r1, r2 = m.forward_pair(img1["img"], img2["img"], true_shape1=img1["ts"], true_shape2=img2["ts"])
        else:
            r1, r2 = m.forward_pair(img1, img2)
        return training.dust3r_confidence_loss(r1, r2, t1, t2)

    return jax_loss, torch_loss


def _flow_losses():
    def jax_loss(m, img1, img2, flow, valid):
        return jax_training.flow_confidence_loss(m.forward_pair(img1, img2), flow, valid=valid > 0)

    def torch_loss(m, img1, img2, flow, valid):
        return training.flow_confidence_loss(m.forward_pair(img1, img2), flow, valid=valid > 0)

    return jax_loss, torch_loss


def _multiview_losses():
    "bench_train's multi-view step: the views stacked in the first image slot, their targets in the first target slot."
    def jax_loss(m, views, _, targets, __):
        return jax_training.multiview_confidence_loss(m([views[v] for v in range(views.shape[0])]), list(targets))

    def torch_loss(m, views, _, targets, __):
        return training.multiview_confidence_loss(m(list(views.unbind(0))), list(targets.unbind(0)))

    return jax_loss, torch_loss


def _flow_batches(rng, n=1):
    "Flow batches with ~10% invalid pixels whose targets are NaN (train.synthetic_flow_dataset's stand-in)."
    out = []
    for _ in range(n):
        valid = (rng.rand(N, 32, 32) > 0.1).astype(np.float32)
        flow = np.where(valid[..., None] > 0, rng.randn(N, 32, 32, 2).astype(np.float32), np.nan)
        out.append((rng.randn(N, 3, 32, 32).astype(np.float32), rng.randn(N, 3, 32, 32).astype(np.float32),
                    flow.astype(np.float32), valid))
    return out


def _multiview_batches(rng, views, n=1):
    dummy = np.zeros(1, np.float32)
    return [(rng.randn(views, 2, 3, 32, 32).astype(np.float32), dummy, rng.randn(views, 2, 32, 32, 3).astype(np.float32),
             dummy) for _ in range(n)]


def _schedule(jax_side):
    "Distinct rates at counts 0, 1, 2, 3: an off-by-one in the count the schedule reads moves every parameter."
    args = (0.25 * LR, LR, 1, 5)
    return optax.warmup_cosine_decay_schedule(*args) if jax_side else training.warmup_cosine_decay_schedule(*args)


def _with_nan_target(batch):
    "The batch with one NaN in its first target: its gradient is non-finite."
    bad = batch[2].copy()
    bad.reshape(-1)[0] = np.nan
    return batch[:2] + (bad,) + batch[3:]


def _case(name):
    """(JAX model ctor, port model, (JAX loss, port loss), batches, make_train_step options on both sides, whether
    the rate is the warmup-cosine schedule) of a training configuration. The updates repeat their batches, as in
    tests/test_torch_training.py: the second update's moments then stay well conditioned (a second batch may make
    0.9 b1 g1 + 0.1 g2 cancel in an element, which turns rounding into a different update)."""
    rng = np.random.RandomState(7)
    dust3r = dict(img_size=(32, 32), **SMALL)
    if name == "dpt_warmup_cosine":  # the port's head recomputed in the backward (--head-remat on), JAX's not
        kw = dict(dust3r, pred_head_type="dpt")
        (b,) = _pair_batches(rng)
        return (lambda: JaxDUSt3R(name="t", rngs=nnx.Rngs(0), **kw),
                _seeded(DUSt3R, head_gradient_checkpointing=True, **kw), _dust3r_losses(), [b, b],
                {"clip_grad_norm": 1.0}, True)
    if name == "mixed_ar":  # rows 1 and 3 portrait: both head passes run and are selected per row
        kw = dict(SMALL, img_size=(32, 48), patch_embed_cls="ManyAR_PatchEmbed", landscape_only=True)
        (b,) = _pair_batches(rng, 32, 48, views_ts=np.array([[32, 48], [48, 32], [32, 48], [48, 32]], np.int32))
        return (lambda: JaxDUSt3R(name="t", rngs=nnx.Rngs(0), **kw), _seeded(DUSt3R, **kw), _dust3r_losses(),
                [b, b], {}, False)
    if name == "flow":
        # at lr 1e-5: the flow head's gradients are small (|g| <= 0.17), and one update of every parameter by 1e-4
        # moves them by their own size (an element's gradient changes sign between two updates on one batch), so
        # the second update would compare how each side amplifies its first update's rounding-noise elements
        kw = dict(img_size=(32, 32), pred_head_type="dpt", **SMALL)
        (b,) = _flow_batches(rng)
        return (lambda: JaxUFMFlow(name="t", rngs=nnx.Rngs(0), **kw), _seeded(UFMFlow, **kw), _flow_losses(),
                [b, b], {"lr": 1e-5}, False)
    if name.startswith("multiview"):
        attention_type, views = ("alternating", 3) if "alternating" in name else ("global", 2)
        kw = dict(num_views=views, img_size=(32, 32), attention_type=attention_type, gradient_checkpointing=True,
                  **SMALL)
        if name.endswith("accum"):  # two windows of two batches: the schedule's count advances per window
            b0, b1 = _multiview_batches(rng, views, n=2)
            batches, opts = [b0, b1, b0, b1], {"grad_accum": 2}
        else:  # a NaN target first: that batch is skipped and the schedule's count stays at 0
            (b,) = _multiview_batches(rng, views)
            batches, opts = [_with_nan_target(b), b, b], {"skip_nonfinite": True}
        return (lambda: JaxMultiView(name="t", rngs=nnx.Rngs(0), **kw), _seeded(MultiViewPointmapModel, **kw),
                _multiview_losses(), batches, opts, True)
    assert name == "lora"
    (b,) = _pair_batches(rng)
    return (lambda: JaxDUSt3R(name="t", rngs=nnx.Rngs(0), **dust3r), _seeded(DUSt3R, **dust3r), _dust3r_losses(),
            [b, b], {}, False)


CASES = ["dpt_warmup_cosine", "mixed_ar", "flow", "multiview_alternating_accum", "multiview_global_skip", "lora"]


@pytest.mark.parametrize("name", CASES)
def test_two_steps_match_jax(name):
    """Two optimizer updates from the same weights and batches: every batch's loss, then every parameter. The
    warmup-cosine cases read the schedule at the counts of the applied updates, 0 and 1: plainly, after an
    accumulation window, after a skipped non-finite batch. With LoRA the JAX package's adapters (lora_b drawn
    non-zero) are carried across and only they train; the base stays bit for bit."""
    jax_ctor, tmod, (jax_loss, torch_loss), batches, kw, schedule = _case(name)
    jmod, tmod = _carry(jax_ctor, tmod)
    lr = kw.pop("lr", LR)
    jax_lr, torch_lr = (_schedule(True), _schedule(False)) if schedule else (lr, lr)
    trainable = None
    if name == "lora":
        for part, seed in (("encoder", 1), ("info_sharing", 2)):
            n = jax_lora.apply_lora(getattr(jmod, part), rank=4, rngs=nnx.Rngs(seed), min_params=1)
            assert n == apply_lora(getattr(tmod, part), 4, min_params=1)
        rng = np.random.RandomState(9)
        for _, m in nnx.iter_modules(jmod):  # a non-zero B, so the first step moves A too
            if isinstance(m, jax_lora.LoRALinear):
                m.lora_b[...] = jnp.asarray(0.1 * rng.randn(*m.lora_b[...].shape).astype(np.float32))
        load_state_dict_numpy(tmod, state_dict_from_module(jmod))
        trainable = lora_trainable
    ref_losses, want = _jax_steps(jmod, jax_loss, batches, lr=jax_lr,
                                  **dict(kw, trainable=jax_lora.lora_trainable) if trainable else kw)

    def update_gradient(window):
        "The gradient the next update applies: the mean of its window's (one batch without accumulation)."
        gs = [_trainable_grads(tmod, torch_loss, b, trainable) for b in window]
        return {k: sum(g[k] for g in gs) / len(gs) for k in gs[0]}

    init = {k: v.clone() for k, v in tmod.state_dict().items()}
    ctx = training.make_train_step(tmod, loss_fn=torch_loss, learning_rate=torch_lr, trainable=trainable, **kw)
    first = 1 if name.endswith("skip") else 0  # the first applied update's window: batches[first:second]
    second = first + ctx.grad_accum
    g1, losses = update_gradient(batches[first:second]), []
    for i, b in enumerate(batches):
        if i == second:
            g2 = update_gradient(batches[second:second + ctx.grad_accum])
        losses.append(float(ctx.step(*_torch_tree(b))))
    finite = np.isfinite(ref_losses)  # the NaN batch's loss is NaN on both sides
    assert (np.isfinite(losses) == finite).all()
    np.testing.assert_allclose(np.array(losses)[finite], np.array(ref_losses)[finite], rtol=1e-5)
    assert ctx.optimizer.count == 2  # not the accumulation mini-steps, not the skipped batch
    if name == "lora":
        assert ctx.names and all(lora_trainable(n) for n in ctx.names)
        assert all(torch.equal(v, init[k]) for k, v in tmod.state_dict().items() if not lora_trainable(k))
    _assert_adam_close(tmod, want, g1, g2, lr)


def test_a_skipped_accumulation_window_does_not_poison_the_next():
    """grad_accum with skip_nonfinite: a window whose mean gradient is non-finite is skipped, and the next window
    starts from a zero accumulator and is applied. The JAX package's chain (optax.MultiSteps over apply_if_finite)
    keeps ``(1 - emit) * acc``, NaN, after such a window, so there every later window is skipped too until the
    skip budget runs out and a NaN update lands (shown below on the chain itself); the port does not copy that."""
    tx = optax.MultiSteps(optax.apply_if_finite(optax.adamw(1e-2), 100), every_k_schedule=2)
    params = {"w": jnp.ones(3)}
    state = tx.init(params)
    moved = []
    for g in (np.nan, 1.0, 1.0, 1.0):
        updates, state = tx.update({"w": jnp.full(3, g)}, state, params)
        moved.append(bool(jnp.any(updates["w"] != 0)))
    assert moved == [False, False, False, False]  # the second, finite window is skipped as well

    model = torch.nn.Linear(3, 1, bias=False)
    x = torch.ones(1, 3)

    def loss_fn(m, x, _, target, __):
        return ((m(x) - target) ** 2).mean()

    ctx = training.make_train_step(model, loss_fn=loss_fn, learning_rate=1e-2, grad_accum=2, skip_nonfinite=True)
    before = model.weight.detach().clone()
    for target in (float("nan"), 1.0):
        ctx.step(x, None, torch.tensor([[target]]), None)
    assert torch.equal(model.weight, before) and ctx.notfinite_count == 1 and ctx.optimizer.count == 0
    assert all(not a.any() for a in ctx.acc)
    for target in (1.0, 1.0):
        ctx.step(x, None, torch.tensor([[target]]), None)
    assert not torch.equal(model.weight, before) and ctx.notfinite_count == 0 and ctx.optimizer.count == 1


def test_dpt_head_remat_changes_memory_not_math():
    "--head-remat on and off: the same loss and gradients (the head's stages recomputed in the backward)."
    rng = np.random.RandomState(3)
    batch = _pair_batches(rng, n=1)[0]
    kw = dict(img_size=(32, 32), pred_head_type="dpt", **SMALL)
    on, off = (_seeded(DUSt3R, head_gradient_checkpointing=r, **kw) for r in (True, False))
    _, loss = _dust3r_losses()
    g_on, g_off = (_trainable_grads(m, loss, batch) for m in (on, off))
    for k in g_on:
        torch.testing.assert_close(g_on[k], g_off[k], rtol=1e-6, atol=1e-7)


# --- LoRA ------------------------------------------------------------------------


@pytest.mark.parametrize("min_params", [1, 8192, 1 << 16])
def test_apply_lora_counts_match_jax(min_params):
    jmod = jax_module(lambda: JaxDUSt3R(name="t", img_size=(32, 32), rngs=nnx.Rngs(0), **SMALL))
    tmod = DUSt3R(name="t", img_size=(32, 32), **SMALL)
    for part in ("encoder", "info_sharing"):
        n = apply_lora(getattr(tmod, part), 2, min_params=min_params)
        assert n == jax_lora.apply_lora(getattr(jmod, part), rank=2, rngs=nnx.Rngs(1), min_params=min_params)
    assert sorted(tmod.state_dict()) == sorted(state_dict_from_module(jmod))
    wrapped = [m for m in tmod.modules() if isinstance(m, LoRALinear)]
    assert all(not isinstance(m, torch.nn.Linear) for m in wrapped)
    assert all(m.lora_a.shape == (m.base.in_features, 2) and not m.lora_b.any() for m in wrapped)
    with pytest.raises(ValueError):
        LoRALinear(torch.nn.Linear(4, 4), rank=0)


def _lora_pair(alpha=None):
    "A JAX and a port DUSt3R with LoRA on every trunk linear, non-zero adapters from the JAX side."
    jmod, tmod = _carry(lambda: JaxDUSt3R(name="t", img_size=(32, 32), rngs=nnx.Rngs(0), **SMALL),
                        _seeded(DUSt3R, img_size=(32, 32), **SMALL))
    for part in ("encoder", "info_sharing"):
        jax_lora.apply_lora(getattr(jmod, part), rank=3, alpha=alpha, rngs=nnx.Rngs(1), min_params=1)
        apply_lora(getattr(tmod, part), 3, alpha, min_params=1)
    rng = np.random.RandomState(4)
    for _, m in nnx.iter_modules(jmod):
        if isinstance(m, jax_lora.LoRALinear):
            m.lora_b[...] = jnp.asarray(0.1 * rng.randn(*m.lora_b[...].shape).astype(np.float32))
    load_state_dict_numpy(tmod, state_dict_from_module(jmod))
    return jmod, tmod


_jax_forward_pair = nnx.jit(lambda m, a, b: m.forward_pair(a, b))


def test_merge_lora_matches_jax_merged_kernel_and_the_wrapped_forward():
    jmod, tmod = _lora_pair(alpha=6.0)
    img = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        wrapped = tmod.forward_pair(img, img.flip(0))
    ref_out = _jax_forward_pair(jmod, jnp.asarray(img.numpy()), jnp.asarray(img.flip(0).numpy()))
    for a, b in zip(wrapped, ref_out):
        for key in a:
            _close(a[key], b[key])
    merged_ref = {}
    for path, m in nnx.iter_modules(jmod):
        if isinstance(m, jax_lora.LoRALinear):
            merged_ref[".".join(map(str, path))] = np.asarray(m.merged_kernel()).T
    n = merge_lora(tmod)
    assert n == len(merged_ref) == jax_lora.merge_lora(jmod)
    assert not any(isinstance(m, LoRALinear) for m in tmod.modules())
    own = tmod.state_dict()
    for path, w in merged_ref.items():
        np.testing.assert_allclose(own[f"{path}.weight"].numpy(), w, rtol=0, atol=1e-6)
    with torch.no_grad():
        merged = tmod.forward_pair(img, img.flip(0))
    for a, b in zip(merged, wrapped):
        for key in a:
            _close(a[key], b[key])


def test_jax_lora_state_loads_through_the_native_container(tmp_path):
    "A JAX LoRA-wrapped model's native state (base and adapters, in the JAX layouts) materializes in the port."
    jmod, tmod = _lora_pair()
    path = str(tmp_path / "lora.nsv")
    jcs.save_native_state(path, jmod)
    arrays, _ = coldstart.load_native_state(path)
    assert "encoder.enc_blocks.0.attn.qkv.lora_a.value" in arrays

    def ctor():
        m = DUSt3R(name="t", img_size=(32, 32), **SMALL)
        for part in ("encoder", "info_sharing"):
            apply_lora(getattr(m, part), 3, min_params=1)
        return m

    built = coldstart.materialize(coldstart.abstract_construct(ctor), arrays=arrays, device="cpu")
    own = built.state_dict()
    for k, v in tmod.state_dict().items():
        assert torch.equal(own[k], v), k


def test_lora_wrapped_projection_leaves_the_fused_contract(monkeypatch):
    """Under "fused", a LoRA-wrapped qkv takes the unfused route (its adapter would be dropped by the fused
    kernel, which reads the base weight), as in the JAX package; an unwrapped one keeps the fused route."""
    calls = []
    real = blocks.fused_qkv_rope_attention
    monkeypatch.setattr(blocks, "fused_qkv_rope_attention", lambda *a: calls.append(1) or real(*a))
    tmod = DUSt3R(name="t", img_size=(32, 32), **SMALL)
    img = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 32, 32).astype(np.float32))
    config.set_attention_impl("fused")
    try:
        with torch.no_grad():
            tmod.forward_pair(img, img)
            fused_calls = len(calls)
            apply_lora(tmod.encoder, 2, min_params=1, predicate=lambda p, _: p.endswith("attn.qkv"))
            calls.clear()
            out = tmod.forward_pair(img, img)
    finally:
        config.set_attention_impl("kernel")
    assert fused_calls == SMALL["enc_depth"] + 2 * SMALL["info_sharing_depth"]  # encoder self + both decoders' self
    assert len(calls) == 2 * SMALL["info_sharing_depth"]  # the wrapped encoder layers left the fused route
    with torch.no_grad():
        ref = tmod.forward_pair(img, img)
    for a, b in zip(out, ref):
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=1e-4, atol=1e-5)


# --- the data pipeline -------------------------------------------------------------


def test_normalize_batch_and_epoch_batches_match_jax():
    from uniception_tpu.data import pipeline as jax_pipeline

    rng = np.random.RandomState(8)
    u8 = rng.randint(0, 256, (3, 5, 7, 3), np.uint8)
    _close(pipeline.normalize_batch(u8, "dust3r"), jax_pipeline.normalize_batch(u8, "dust3r"))
    arrays = {"a": np.arange(10), "b": np.arange(10) * 2}
    ours = list(pipeline.epoch_batches(arrays, 3, rng=np.random.RandomState(2)))
    ref = list(jax_pipeline.epoch_batches(arrays, 3, rng=np.random.RandomState(2)))
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        for k in arrays:
            np.testing.assert_array_equal(o[k], r[k])
    assert len(list(pipeline.epoch_batches(arrays, 3, drop_last=False))) == 4
    sampler, jax_sampler = (p.DeterministicSampler(arrays, 4, seed=5, start_step=1) for p in (pipeline, jax_pipeline))
    for o, r, _ in zip(sampler, jax_sampler, range(5)):  # across two epochs of two batches
        np.testing.assert_array_equal(o["a"], r["a"])
