"""
The port's training path (uniception_tpu_torch/parallel/training.py,
uniception_tpu_torch/train.py) on the CPU against the JAX package: the
DUSt3R losses (valid masks, NaN/inf target sentinels, ``avg_dis``), one
step's gradients and two AdamW steps of ``make_train_step`` (plain, clipped
with metrics, a frozen encoder, a skipped non-finite batch) against the JAX
``make_train_step`` on the 8-device CPU mesh, AdamW with a bf16 first moment
against ``optax.adamw``, gradient accumulation, the EMA, gradient
checkpointing, the bf16 compute dtype over fp32 parameters, and the trainer's
entry point. Weights go across with ``state_dict_from_module`` ->
``load_state_dict_numpy``; inputs come from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.parallel import training as jax_training
from uniception_tpu.parallel.mesh import shard_batch
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch import train
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.parallel import training
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

TOL = 5e-5  # fp32, per component, relative to max(1, max |reference|): the repo's parity bar
SMALL = dict(
    img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
    info_sharing_dim=64, info_sharing_depth=2, info_sharing_num_heads=4,
)
LR = 1e-3
# Parameters after AdamW steps. Adam's first update is about lr * g / (|g| + eps): it follows the sign of the
# gradient however small, so an element whose gradient is rounding noise (|g| < GRAD_FLOOR; max |g| is about 2
# here) may move up to 2 lr apart between two correct implementations. Every other element agrees within
# ADAM_TOL * lr, and at most 0.1% of the elements are exempt.
GRAD_FLOOR, ADAM_TOL = 1e-5, 0.05


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= tol * max(1.0, float(np.abs(ref).max()))


def _batch(seed, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 32, 32).astype(np.float32), rng.randn(n, 3, 32, 32).astype(np.float32),
            rng.randn(n, 32, 32, 3).astype(np.float32), rng.randn(n, 32, 32, 3).astype(np.float32))


def _models():
    "The JAX model and the port's with its weights."
    jmod = JaxDUSt3R(name="train_test", rngs=nnx.Rngs(0), **SMALL)
    tmod = DUSt3R(name="train_test", **SMALL)
    load_state_dict_numpy(tmod, state_dict_from_module(jmod))
    return jmod, tmod


def _seeded(**kw):
    return DUSt3R(name="seeded", generator=torch.Generator().manual_seed(0), **SMALL, **kw)


def _torch_grads(tmod, batch):
    "{name: gradient} of one loss on the batch (not applied)."
    named = [(n, p) for n, p in tmod.named_parameters() if p.requires_grad]
    img1, img2, t1, t2 = (torch.from_numpy(a) for a in batch)
    res1, res2 = tmod.forward_pair(img1, img2)
    loss = training.dust3r_confidence_loss(res1, res2, t1, t2)
    return loss, dict(zip([n for n, _ in named], torch.autograd.grad(loss, [p for _, p in named])))


def _assert_adam_close(tmod, want, grads, lr=LR):
    got = {k: v.detach().numpy() for k, v in tmod.state_dict().items()}
    exempt = total = 0
    for k, ref in want.items():
        diff = np.abs(got[k] - ref)
        if k not in grads:  # frozen: bit-identical
            np.testing.assert_array_equal(got[k], ref, err_msg=k)
            continue
        live = np.abs(grads[k].numpy()) > GRAD_FLOOR
        assert not live.any() or diff[live].max() <= ADAM_TOL * lr, (k, diff[live].max() / lr)
        exempt += int((~live).sum())
        total += live.size
    assert exempt <= 1e-3 * total, (exempt, total)


# --- losses -------------------------------------------------------------------


def _loss_inputs(masked):
    rng = np.random.RandomState(3)
    B, H, W = 2, 8, 8
    pts1, pts2, t1, t2 = (rng.randn(B, H, W, 3).astype(np.float32) for _ in range(4))
    conf1, conf2 = (1.0 + rng.rand(B, H, W, 1).astype(np.float32) for _ in range(2))
    valid1 = valid2 = None
    if masked:  # invalid target pixels carry NaN / inf sentinels, as datasets store them
        valid1, valid2 = rng.rand(B, H, W) > 0.3, rng.rand(B, H, W) > 0.3
        t1[~valid1], t2[~valid2] = np.nan, np.inf
    return pts1, pts2, conf1, conf2, t1, t2, valid1, valid2


@pytest.mark.parametrize("norm_mode", [None, "avg_dis"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "masked_sentinels"])
def test_loss_and_its_gradient_match_jax(masked, norm_mode):
    pts1, pts2, conf1, conf2, t1, t2, valid1, valid2 = _loss_inputs(masked)

    def jax_loss(p1, p2, c1, c2):
        v = {} if not masked else {"valid1": jnp.asarray(valid1), "valid2": jnp.asarray(valid2)}
        return jax_training.dust3r_confidence_loss(
            {"pts3d": p1, "conf": c1}, {"pts3d_in_other_view": p2, "conf": c2}, jnp.asarray(t1), jnp.asarray(t2),
            norm_mode=norm_mode, **v)

    ref, ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (pts1, pts2, conf1, conf2)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (pts1, pts2, conf1, conf2)]
    v = {} if not masked else {"valid1": torch.from_numpy(valid1), "valid2": torch.from_numpy(valid2)}
    loss = training.dust3r_confidence_loss(
        {"pts3d": leaves[0], "conf": leaves[2]}, {"pts3d_in_other_view": leaves[1], "conf": leaves[3]},
        torch.from_numpy(t1), torch.from_numpy(t2), norm_mode=norm_mode, **v)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, ref)
    for g, r in zip(grads, ref_grads):
        _close(g, r)  # finite, NaN/inf sentinels included


def test_normalize_pointmaps_matches_jax():
    pts1, pts2, _, _, _, _, valid1, valid2 = _loss_inputs(True)
    ref = jax_training.normalize_pointmaps(*map(jnp.asarray, (pts1, pts2, valid1, valid2)))
    out = training.normalize_pointmaps(*map(torch.from_numpy, (pts1, pts2, valid1, valid2)))
    for o, r in zip(out, ref):
        _close(o, r)
    with pytest.raises(ValueError):
        training.dust3r_confidence_loss({"pts3d": torch.zeros(1, 2, 2, 3), "conf": torch.ones(1, 2, 2, 1)},
                                        {"pts3d_in_other_view": torch.zeros(1, 2, 2, 3), "conf": torch.ones(1, 2, 2, 1)},
                                        torch.zeros(1, 2, 2, 3), torch.zeros(1, 2, 2, 3), norm_mode="median")


# --- the train step against the JAX make_train_step ----------------------------


def test_gradients_match_jax():
    "One loss's gradient for every parameter, fp32, against jax.grad of the same loss."
    jmod, tmod = _models()
    batch = _batch(0)
    graphdef, params, rest = nnx.split(jmod, nnx.Param, ...)

    @jax.jit
    def loss_and_grad(p):
        def f(p):
            r1, r2 = nnx.merge(graphdef, p, rest).forward_pair(jnp.asarray(batch[0]), jnp.asarray(batch[1]))
            return jax_training.dust3r_confidence_loss(r1, r2, jnp.asarray(batch[2]), jnp.asarray(batch[3]))
        return jax.value_and_grad(f)(p)

    ref_loss, ref_grads = loss_and_grad(params)
    ref_grads = state_dict_from_module(nnx.merge(graphdef, ref_grads, rest))  # torch names and layouts
    loss, grads = _torch_grads(tmod, batch)
    _close(loss, ref_loss)
    assert sorted(grads) == sorted(ref_grads)
    for k, g in grads.items():
        _close(g, ref_grads[k])


VARIANTS = {
    "plain": dict(),
    "clip_metrics": dict(clip_grad_norm=1.0, metrics=True),
    "freeze_encoder": dict(trainable=lambda p: not p.startswith("encoder.")),
    "skip_nonfinite": dict(skip_nonfinite=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_steps_match_jax_make_train_step(variant):
    """Two steps at batch 8 from the same weights and batches (the JAX step
    data-parallel over the CPU mesh of tests/conftest.py): the loss of each
    step (and grad_norm), then every parameter (see _assert_adam_close). With
    skip_nonfinite the first batch has a NaN target: both skip it."""
    kw = VARIANTS[variant]
    jmod, tmod = _models()
    batch = _batch(1)
    first = batch
    if variant == "skip_nonfinite":
        bad = batch[2].copy()
        bad[0, 0, 0, 0] = np.nan
        first = (batch[0], batch[1], bad, batch[3])
    ctx, params, opt_state = jax_training.make_train_step(jmod, learning_rate=LR, **kw)
    ref_losses, ref_norms = [], []
    with ctx.mesh:
        for b in (first, batch):
            out = ctx.step(params, opt_state, *shard_batch(tuple(map(jnp.asarray, b)), ctx.mesh))
            loss, params, opt_state = (out[0], out[2], out[3]) if kw.get("metrics") else out
            ref_losses.append(float(loss))
            if kw.get("metrics"):
                ref_norms.append(float(out[1]["grad_norm"]))
    want = state_dict_from_module(nnx.merge(ctx.graphdef, params, ctx.rest_state))

    init = {k: v.clone() for k, v in tmod.state_dict().items()}
    tctx = training.make_train_step(tmod, learning_rate=LR, **kw)
    _, grads = _torch_grads(tmod, batch)  # the first finite step's gradients, for the exemption rule
    losses, norms = [], []
    for b in (first, batch):
        out = tctx.step(*(torch.from_numpy(a) for a in b))
        loss = out[0] if kw.get("metrics") else out
        losses.append(float(loss))
        if kw.get("metrics"):
            norms.append(float(out[1]["grad_norm"]))
        if variant == "skip_nonfinite" and len(losses) == 1:  # the NaN step changed nothing
            assert all(torch.equal(v, init[k]) for k, v in tmod.state_dict().items())
            assert tctx.optimizer.count == 0 and tctx.notfinite_count == 1
            assert all(not m.any() for m in tctx.optimizer.mu)
    if variant == "skip_nonfinite":
        assert np.isnan(losses[0]) and np.isnan(ref_losses[0])
        losses, ref_losses = losses[1:], ref_losses[1:]
        assert tctx.optimizer.count == 1 and tctx.notfinite_count == 0
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-5)
    if variant == "freeze_encoder":
        assert not any(n.startswith("encoder.") for n in grads)
        n_frozen = sum(v.numel() for k, v in init.items() if k.startswith("encoder."))
        assert sum(m.numel() for m in tctx.optimizer.mu) == sum(v.numel() for v in init.values()) - n_frozen
    _assert_adam_close(tmod, want, grads)


def test_adamw_matches_optax_with_bf16_first_moment():
    "AdamW against optax.adamw on random tensors for three steps, fp32 and bf16 first moments."
    rng = np.random.RandomState(5)
    shapes = [(7, 5), (13,), (3, 4, 2)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(3)]
    for mu_dtype, tmu in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        tx = optax.adamw(LR, weight_decay=0.05, mu_dtype=mu_dtype)
        jp = [jnp.asarray(a) for a in p0]
        state = tx.init(jp)
        tp = [torch.from_numpy(a.copy()) for a in p0]
        opt = training.AdamW(tp, LR, weight_decay=0.05, mu_dtype=tmu)
        for g in gs:
            updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
            jp = optax.apply_updates(jp, updates)
            opt.step([torch.from_numpy(a) for a in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6 * LR)
        assert all(m.dtype == (tmu or torch.float32) for m in opt.mu)
        for a, b in zip(opt.mu, state[0].mu):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), rtol=1e-6, atol=0)


def test_grad_accum_matches_one_step_on_the_concatenated_batch():
    tmod, twin = _seeded(), _seeded()
    batch = _batch(2)
    _, grads = _torch_grads(tmod, batch)
    ref = training.make_train_step(tmod, learning_rate=LR)
    ref.step(*(torch.from_numpy(a) for a in batch))
    acc = training.make_train_step(twin, learning_rate=LR, grad_accum=2)
    init = {k: v.clone() for k, v in twin.state_dict().items()}
    acc.step(*(torch.from_numpy(a[:4]) for a in batch))
    assert all(torch.equal(v, init[k]) for k, v in twin.state_dict().items())  # no update mid-window
    acc.step(*(torch.from_numpy(a[4:]) for a in batch))
    assert acc.optimizer.count == 1 and all(not a.any() for a in acc.acc)
    _assert_adam_close(twin, {k: v.numpy() for k, v in tmod.state_dict().items()}, grads)


def test_ema_matches_jax():
    tree = {"a": np.asarray([1.0, 2.0], np.float32), "b": np.asarray([[3.0]], np.float32)}
    new = {"a": np.asarray([2.0, 0.0], np.float32), "b": np.asarray([[5.0]], np.float32)}
    ref = jax_training.ema_update(jax_training.ema_init({k: jnp.asarray(v) for k, v in tree.items()}),
                                  {k: jnp.asarray(v) for k, v in new.items()}, 0.9)
    ema = training.ema_init({k: torch.from_numpy(v) for k, v in tree.items()})
    out = training.ema_update(ema, {k: torch.from_numpy(v) for k, v in new.items()}, 0.9)
    assert out is ema
    for k in tree:
        np.testing.assert_array_equal(ema[k].numpy(), np.asarray(ref[k]))
    assert tree["a"][0] == 1.0  # ema_init copied


# --- model-side training options ------------------------------------------------


def test_gradient_checkpointing_matches_no_remat():
    "Remat changes memory, not math: the loss and every gradient are the same."
    batch = _batch(3, n=2)
    base, remat = _seeded(), _seeded(gradient_checkpointing=True)
    l0, g0 = _torch_grads(base, batch)
    l1, g1 = _torch_grads(remat, batch)
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)


def test_bf16_compute_over_fp32_parameters_equals_the_bf16_serving_model():
    """With the same weights, fp32 parameters cast to bf16 at use compute what
    the serving model with bf16 parameters computes; the parameters stay fp32."""
    img = torch.from_numpy(_batch(4, n=2)[0])
    train_model = _seeded(dtype=torch.bfloat16)
    serve_model = _seeded(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    assert {p.dtype for p in train_model.parameters()} == {torch.float32}
    with torch.no_grad():
        out_t = train_model.forward_pair(img, img.flip(0))
        out_s = serve_model.forward_pair(img, img.flip(0))
    for a, b in zip(out_t, out_s):
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    # the residual stream is bf16 (as in the JAX package), the heads fp32
    feats = train_model.encoder.patch_embed(img, torch.tensor([[32, 32]] * 2))[0]
    assert feats.dtype == torch.bfloat16 and out_t[0]["pts3d"].dtype == torch.float32


def test_train_main_on_cpu(capsys):
    losses = train.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--dataset-size", "4", "--bf16",
                         "--metrics", "--ema", "0.9", "--clip-grad", "10", "--skip-nonfinite", "--norm-loss"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "on cpu" in out and "grad_norm" in out


def test_train_main_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        train.main(["--steps", "1"])


def test_sampler_is_step_indexed():
    data = train.synthetic_dataset(10, 8, seed=1)
    a = train.DeterministicSampler(data, 3, seed=7)
    b = train.DeterministicSampler(data, 3, seed=7, start_step=4)
    batches = [x for _, x in zip(range(6), a)]
    assert all(np.array_equal(batches[4][k], next(iter(b))[k]) for k in data)
    assert batches[0]["img1"].shape == (3, 8, 8, 3) and batches[0]["pts1"].dtype == np.float32
