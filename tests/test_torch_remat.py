"""
Gradient checkpointing under the ``UNICEPTION_TPU_REMAT_POLICY`` policies (uniception_tpu_torch/nn/common.py
``resolve_remat_policy``, ``remat_call``, ``checkpoint_name``) against the JAX package's (uniception_tpu/nn/common.py),
on the CPU.

Under each value (unset: full rematerialization, "dots", "attn_out", and an unknown value, which warns and is full
rematerialization) the port's loss and gradients equal its call without checkpointing bit for bit, and JAX's
``jax.grad`` of the same loss under the same value (jitted afresh for each, since JAX reads the variable when it
traces) within 5e-5 of the largest gradient magnitude above 1: for a CroCo self block and a decoder cross block (64
wide, 4 heads, RoPE), and for a 2 + 2-deep DUSt3R at 32² with the linear and the DPT head (the DPT processor's
checkpoint takes the policy too). What each policy keeps in a block is what ``jax.ad_checkpoint.print_saved_residuals``
shows JAX keeping, by count and shape (leading dims flattened), besides the arguments and parameters; the one extra is
K1's logsumexp, kept with its output under "attn_out"; every attention route's output is kept under it ("naive" and
Dv != Dq through the ``checkpoint_name`` marker, "fused" as K5's op). Dropout and DropPath drawing from an explicit generator give the
plain call's gradients under every policy, and each call draws a fresh mask.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_blocks import DIM, HEADS, _pair, _tokens
from tests.test_torch_training import _close
from tests.test_torch_training_paths import SMALL, _carry, _dust3r_losses, _seeded
from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.nn import blocks as jblocks
from uniception_tpu.nn.common import remat_call as jax_remat_call
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.nn import blocks, common
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention

POLICIES = [None, "dots", "attn_out", "unknown"]
WARNING = "is not one of ('dots', 'attn_out'); falling back to full rematerialization"
GRID = (3, 4)  # 12 tokens a view


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    "Two intra-op threads, as the training files run torch (their fixture says why)."
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _set(monkeypatch, policy):
    if policy is None:
        monkeypatch.delenv("UNICEPTION_TPU_REMAT_POLICY", raising=False)
    else:
        monkeypatch.setenv("UNICEPTION_TPU_REMAT_POLICY", policy)


def _warns(policy):
    return pytest.warns(UserWarning, match=re.escape(WARNING)) if policy == "unknown" else contextlib.nullcontext()


def test_resolve_remat_policy_reads_the_variable_at_each_call(monkeypatch):
    for value, want in ((None, None), ("dots", common.DOTS), ("attn_out", common.ATTN_OUT)):
        _set(monkeypatch, value)
        assert common.resolve_remat_policy() is want
    _set(monkeypatch, "unknown")
    with pytest.warns(UserWarning, match=re.escape(f"UNICEPTION_TPU_REMAT_POLICY='unknown' {WARNING}.")):
        assert common.resolve_remat_policy() is None


# --- blocks -------------------------------------------------------------------------------------------------------


def _block(kind):
    """(JAX block, port block, its numpy inputs, a function of the port block and torch inputs): a CroCo encoder
    block (self-attention with RoPE) or a decoder block (self- and cross-attention with RoPE)."""
    pos = make_patch_positions(2, *GRID)
    if kind == "self":
        jmod, tmod = _pair(jblocks.SelfAttentionBlock, blocks.SelfAttentionBlock)
        return jmod, tmod, (_tokens(0, 2, 12), pos.numpy()), (pos,)
    jmod, tmod = _pair(jblocks.CrossAttentionBlock, blocks.CrossAttentionBlock)
    return jmod, tmod, (_tokens(1, 2, 12), _tokens(2, 2, 12), pos.numpy(), pos.numpy()), (pos, pos)


def _jax_block_loss(jmod, kind):
    "A function of (params, float inputs) -> loss of the JAX block under its remat_call, and its params."
    graphdef, params, rest = nnx.split(jmod, nnx.Param, ...)

    def loss(p, *xs):
        m = nnx.merge(graphdef, p, rest)
        pos = jnp.asarray(make_patch_positions(2, *GRID).numpy())
        out = jax_remat_call(m, *xs, *((pos,) if kind == "self" else (pos, pos)))
        return (out ** 2).sum()

    return loss, params, graphdef, rest


def _port_block_grads(fn, xs, pos, remat):
    """The loss and the gradients (inputs, then a module's parameters) of the port block or function, with
    remat_call or without."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = common.remat_call(fn, *leaves, *pos) if remat else fn(*leaves, *pos)
    loss = (out ** 2).sum()
    return loss, torch.autograd.grad(loss, leaves + (list(fn.parameters()) if isinstance(fn, torch.nn.Module) else []))


@pytest.mark.parametrize("policy", POLICIES, ids=["unset", "dots", "attn_out", "unknown"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_block_gradients_equal_the_plain_call_and_jax(kind, policy, monkeypatch):
    jmod, tmod, inputs, pos = _block(kind)
    xs = inputs[: 1 if kind == "self" else 2]
    plain_loss, plain = _port_block_grads(tmod, xs, pos, False)
    _set(monkeypatch, policy)
    with _warns(policy):
        loss, grads = _port_block_grads(tmod, xs, pos, True)
    assert torch.equal(loss, plain_loss) and all(torch.equal(a, b) for a, b in zip(grads, plain))
    jloss, params, graphdef, rest = _jax_block_loss(jmod, kind)
    with _warns(policy):
        ref, (gp, *gx) = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(len(xs) + 1))))(
            params, *map(jnp.asarray, xs))
    _close(loss, ref)
    for g, r in zip(grads, gx):
        _close(g, r)
    want = state_dict_from_module(nnx.merge(graphdef, gp, rest))
    for (name, _), g in zip(tmod.named_parameters(), grads[len(xs):]):
        _close(g, want[name])


def _jax_saved(jmod, kind, xs):
    "JAX's residuals inside the block (not arguments, constants or the loss's), as (dtype, rows, last dim)."
    jloss, params, _, _ = _jax_block_loss(jmod, kind)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(jloss, params, *map(jnp.asarray, xs))
    out = []
    for line in buf.getvalue().splitlines():
        if "from the argument" in line or "from a constant" in line or __file__ in line:
            continue
        dtype, dims = re.match(r"(\w+)\[([\d,]*)\]", line).groups()
        shape = [int(d) for d in dims.split(",")]
        out.append((dtype, int(np.prod(shape[:-1])), shape[-1]))
    return sorted(out)


def _kept(tmod, xs, pos, monkeypatch):
    "What the port's policy keeps after the forward, as (dtype, rows, last dim)."
    seen = []

    class Watched(common._Remat):
        def contexts(self):
            seen.append(self)
            return super().contexts()

    monkeypatch.setattr(common, "_Remat", Watched)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = common.remat_call(tmod, *leaves, *pos)
    kept = sorted(({torch.float32: "f32"}[t.dtype], int(np.prod(t.shape[:-1])), t.shape[-1])
                  for r in seen for t in r.kept_tensors())
    torch.autograd.grad((out ** 2).sum(), leaves)  # the kept tensors are read back
    return kept


@pytest.mark.parametrize("policy", POLICIES, ids=["unset", "dots", "attn_out", "unknown"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_each_policy_keeps_what_jax_saves(kind, policy, monkeypatch):
    """Full rematerialization keeps nothing but the arguments; "dots" the linears' outputs the backward reads (a
    block's last linear joins the residual only, and neither side keeps it); "attn_out" each attention's output, and
    in the port K1's (B, H, N) fp32 logsumexp beside it."""
    jmod, tmod, inputs, pos = _block(kind)
    xs = inputs[: 1 if kind == "self" else 2]
    _set(monkeypatch, policy)
    with _warns(policy):
        want = _jax_saved(jmod, kind, xs)
    with _warns(policy):
        got = _kept(tmod, xs, pos, monkeypatch)
    attentions = 1 if kind == "self" else 2
    lse = [("f32", 2 * HEADS, 12)] * attentions if policy == "attn_out" else []
    assert got == sorted(want + lse)
    assert len(want) == {None: 0, "unknown": 0, "dots": 3 if kind == "self" else 7, "attn_out": attentions}[policy]


@pytest.mark.parametrize("route", ["naive", "dv_ne_dq", "fused"])
def test_every_attention_route_keeps_its_output_under_attn_out(route, monkeypatch, request):
    """The "naive" route and the Dv != Dq einsum route have no kernel op: they name their output
    (``checkpoint_name``), which "attn_out" keeps as it keeps a kernel's output. Under "fused" K5's op is kept (its
    (B, N, C) output, projected heads merged; JAX leaves the fused route unnamed). The gradients stay the plain
    call's."""
    rng = np.random.RandomState(3)
    if route == "dv_ne_dq":
        d = 8
        xs = tuple(rng.randn(2, 12, 2, n).astype(np.float32) for n in (d, d, 2 * d))
        fn, pos = lambda q, k, v: scaled_dot_product_attention(q, k, v).sin(), ()  # sin's backward reads it
        want = [("f32", 2 * 12 * 2, 2 * d)]
    else:
        before = config.get_attention_impl()
        config.set_attention_impl(route)
        request.addfinalizer(lambda: config.set_attention_impl(before))
        _, fn, inputs, pos = _block("self")
        xs = inputs[:1]
        want = [("f32", 2 * 12 * HEADS, DIM // HEADS)] if route == "naive" else [("f32", 2 * 12, DIM)]
    plain_loss, plain = _port_block_grads(fn, xs, pos, False)
    _set(monkeypatch, "attn_out")
    assert _kept(fn, xs, pos, monkeypatch) == want
    loss, grads = _port_block_grads(fn, xs, pos, True)
    assert torch.equal(loss, plain_loss) and all(torch.equal(a, b) for a, b in zip(grads, plain))


# --- dropout masks ------------------------------------------------------------------------------------------------


def _masked(kind, seed):
    "Linear -> tanh -> Dropout(0.5) or DropPath(0.5), its masks from a generator seeded ``seed``."
    gen = torch.Generator().manual_seed(seed)
    drop = blocks.Dropout(0.5, generator=gen) if kind == "dropout" else blocks.DropPath(0.5, generator=gen)
    lin = torch.nn.Linear(8, 8)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.random.RandomState(4).randn(8, 8).astype(np.float32)))
        lin.bias.zero_()
    return torch.nn.Sequential(lin, torch.nn.Tanh(), drop).train()


@pytest.mark.parametrize("policy", [None, "dots", "attn_out"], ids=["unset", "dots", "attn_out"])
@pytest.mark.parametrize("kind", ["dropout", "droppath"])
def test_remat_redraws_the_forwards_mask_and_each_call_a_fresh_one(kind, policy, monkeypatch):
    """The recompute draws the forward's mask again (the generator set back to its state at the forward), so the
    gradient is the plain call's bit for bit; the generator advances once per call, so the next call's mask is
    another (JAX's remat_call reuses one mask: ROADMAP queue 3)."""
    _set(monkeypatch, policy)
    x = torch.from_numpy(np.random.RandomState(5).randn(16, 8).astype(np.float32))
    grads, outs = {}, {}
    for remat in (False, True):
        m = _masked(kind, 7)
        out = [common.remat_call(m, x) if remat else m(x) for _ in range(2)]
        grads[remat] = torch.autograd.grad(out[0].square().sum(), list(m.parameters()))
        outs[remat] = out
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    assert torch.equal(outs[True][0], outs[False][0]) and torch.equal(outs[True][1], outs[False][1])
    assert not torch.equal(outs[True][0], outs[True][1])


# --- DUSt3R -------------------------------------------------------------------------------------------------------


def _dust3r(head):
    kw = dict(img_size=(32, 32), gradient_checkpointing=True, pred_head_type=head, **SMALL)
    return _carry(lambda: JaxDUSt3R(name="t", rngs=nnx.Rngs(0), **kw), _seeded(DUSt3R, **kw))


def _batch():
    rng = np.random.RandomState(0)
    return [rng.randn(2, 3, 32, 32).astype(np.float32) for _ in range(2)] + [
        rng.randn(2, 32, 32, 3).astype(np.float32) for _ in range(2)]


def _port_grads(tmod, batch):
    _, loss_fn = _dust3r_losses()
    loss = loss_fn(tmod, *map(torch.from_numpy, batch))
    return loss, torch.autograd.grad(loss, list(tmod.parameters()))


@pytest.mark.parametrize("head", ["linear", "dpt"])
def test_dust3r_gradients_under_every_policy_equal_no_remat(head, monkeypatch):
    "The encoder's, the decoder's and (DPT) the head's and its processor's checkpoints, under every value."
    kw = dict(img_size=(32, 32), pred_head_type=head, **SMALL)
    tmod, plain = _seeded(DUSt3R, gradient_checkpointing=True, **kw), _seeded(DUSt3R, **kw)
    batch = _batch()
    ref_loss, ref = _port_grads(plain, batch)
    assert head == "linear" or any(getattr(m, "checkpoint_gradient", False) for m in tmod.modules())
    for policy in POLICIES:
        _set(monkeypatch, policy)
        with _warns(policy):
            loss, grads = _port_grads(tmod, batch)
        assert torch.equal(loss, ref_loss) and all(torch.equal(a, b) for a, b in zip(grads, ref)), policy


# JAX compiles a DUSt3R gradient in 7-14 s, so each model is held against JAX under one selective policy (every value
# is held bit for bit against the port's no-remat gradients above, and against JAX on the blocks).
@pytest.mark.parametrize("head,policy", [("dpt", "attn_out"), ("linear", "dots")])
def test_dust3r_gradients_match_jax(head, policy, monkeypatch):
    jmod, tmod = _dust3r(head)
    batch = _batch()
    _set(monkeypatch, policy)
    with _warns(policy):
        loss, grads = _port_grads(tmod, batch)
    jax_loss, _ = _dust3r_losses()
    graphdef, params, rest = nnx.split(jmod, nnx.Param, ...)
    with _warns(policy):
        ref, gp = jax.jit(jax.value_and_grad(lambda p, *b: jax_loss(nnx.merge(graphdef, p, rest), *b)))(
            params, *map(jnp.asarray, batch))
    _close(loss, ref)
    want = state_dict_from_module(nnx.merge(graphdef, gp, rest))
    for (name, _), g in zip(tmod.named_parameters(), grads):
        _close(g, want[name])
