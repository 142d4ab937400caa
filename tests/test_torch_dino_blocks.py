"""
The port's block library for DINOv2 against the JAX package on the CPU: SwiGLUFFN(Fused), LayerScale, RMSNorm,
qk-norm attention (self and cross), SelfAttentionBlock and CrossAttentionBlock with LayerScale, qk-norm and the
SwiGLU MLP, dropout and stochastic depth (identities at rate 0 and in eval mode; in training, their keep rate and
scaling from a generator), the fused rule's qk-norm guard, the truncated-normal init, the PE interpolation and the
2D sine-cosine table. Weights go from seeded JAX modules into the port's through the torch-layout state dict, every
entry redrawn from numpy so that no bias or LayerScale is trivial; inputs come from numpy.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.encoders import pe_utils as jpe
from uniception_tpu.models.utils import config as jax_config
from uniception_tpu.nn import blocks as jblocks
from uniception_tpu.ops.rope import Rope2D as JaxRope2D
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch.models.encoders import pe_utils
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn import blocks
from uniception_tpu_torch.nn.common import trunc_normal
from uniception_tpu_torch.ops.rope import Rope2D
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

TOL = 5e-5  # fp32 max abs per component, the repo's parity bar


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    "Two intra-op threads: small CPU modules in several test workers (see tests/test_torch_training_paths.py)."
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _restore_modes():
    "No autograd (forward comparisons only); both packages' attention implementation restored afterwards."
    with torch.no_grad():
        yield
    jax_config.set_attention_impl("pallas")
    config.set_attention_impl("kernel")


def _pair(jmod, tmod, seed=0):
    """(JAX module, port module in eval mode) holding the same weights: the JAX module's torch-layout state with
    every entry redrawn from ``seed`` (norm weights around 1, the rest around 0)."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in state_dict_from_module(jmod).items():
        base = 1.0 if k.endswith(("norm.weight", "norm1.weight", "norm2.weight", "norm3.weight", "gamma")) else 0.0
        state[k] = (base + rng.randn(*v.shape) * (0.2 if base else 1.0 / math.sqrt(max(v.shape[-1], 1)))).astype(
            np.float32)
    load_torch_state_dict(jmod, state, verbose=False)
    load_state_dict_numpy(tmod, state)
    jmod.eval()
    return jmod, tmod.eval()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol, err


def _positions(B, H, W):
    y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return np.broadcast_to(np.stack([y.ravel(), x.ravel()], -1), (B, H * W, 2)).astype(np.int32).copy()


@pytest.mark.parametrize("name", ["SwiGLUFFN", "SwiGLUFFNFused"])
def test_swiglu_ffn_matches_jax(name):
    jmod = getattr(jblocks, name)(64, hidden_features=256, out_features=48, rngs=nnx.Rngs(0))
    tmod = getattr(blocks, name)(64, hidden_features=256, out_features=48)
    assert tmod.w12.weight.shape == (2 * (176 if name == "SwiGLUFFNFused" else 256), 64)  # (int(256*2/3)+7)//8*8
    jmod, tmod = _pair(jmod, tmod)
    x = np.random.RandomState(1).randn(2, 9, 64).astype(np.float32)
    _close(tmod(torch.from_numpy(x)), jmod(jnp.asarray(x)))


def test_swiglu_fused_hidden_width_of_every_dinov2_size():
    for dim, want in ((384, 1024), (768, 2048), (1024, 2736), (1536, 4096)):
        got = blocks.SwiGLUFFNFused(dim, hidden_features=4 * dim, device="meta").w3.weight.shape[1]
        jax_w3 = nnx.eval_shape(lambda d=dim: jblocks.SwiGLUFFNFused(d, hidden_features=4 * d, rngs=nnx.Rngs(0))).w3
        assert got == want == jax_w3.kernel.shape[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_scale_matches_jax(dtype):
    jmod, tmod = _pair(jblocks.LayerScale(32, init_values=1e-5, rngs=nnx.Rngs(0)), blocks.LayerScale(32, 1e-5))
    x = np.random.RandomState(2).randn(3, 5, 32).astype(np.float32)
    got = tmod(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = np.asarray(jmod(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)  # gamma cast to x's dtype first, one product


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(affine, dtype):
    jmod = jblocks.RMSNorm(48, elementwise_affine=affine, rngs=nnx.Rngs(0))
    tmod = blocks.RMSNorm(48, elementwise_affine=affine)
    if affine:
        jmod, tmod = _pair(jmod, tmod)
    x = (np.random.RandomState(3).randn(2, 7, 48) * 3).astype(np.float32)
    got = tmod(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = np.asarray(jmod(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want)
    else:  # fp32 statistics, then the same two bf16 roundings: at most one bf16 ulp apart
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=0)


@pytest.mark.parametrize("rope", [False, True], ids=["no_pe", "rope"])
def test_qk_norm_self_attention_matches_jax(rope):
    jpe_, tpe = (JaxRope2D(freq=100.0), Rope2D(freq=100.0)) if rope else (None, None)
    kw = dict(num_heads=4, qkv_bias=True, qk_norm=True, proj_drop=0.3)
    jmod = jblocks.Attention(64, custom_positional_encoding=jpe_, rngs=nnx.Rngs(0), **kw)
    tmod = blocks.Attention(64, custom_positional_encoding=tpe, **kw)
    assert sorted(k for k in tmod.state_dict() if "norm" in k) == ["k_norm.bias", "k_norm.weight", "q_norm.bias",
                                                                    "q_norm.weight"]
    jmod, tmod = _pair(jmod, tmod)
    x = np.random.RandomState(4).randn(2, 12, 64).astype(np.float32)
    pos = _positions(2, 3, 4)
    got = tmod(torch.from_numpy(x), torch.from_numpy(pos) if rope else None)
    _close(got, jmod(jnp.asarray(x), jnp.asarray(pos) if rope else None))


def test_qk_norm_cross_attention_matches_jax():
    kw = dict(num_heads=4, qkv_bias=True, qk_norm=True)
    jmod, tmod = _pair(jblocks.CrossAttention(64, rngs=nnx.Rngs(0), **kw), blocks.CrossAttention(64, **kw))
    rng = np.random.RandomState(5)
    q, kv = rng.randn(2, 6, 64).astype(np.float32), rng.randn(2, 10, 64).astype(np.float32)
    tkv = torch.from_numpy(kv)
    _close(tmod(torch.from_numpy(q), tkv, tkv), jmod(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv)))


BLOCK_OPTIONS = {
    "dinov2_mlp": dict(qkv_bias=True, init_values=1.0),
    "dinov2_swiglu": dict(qkv_bias=True, init_values=1.0, mlp_layer="SwiGLUFFNFused"),
    "qk_norm_layerscale": dict(qk_norm=True, init_values=1e-5),
    "eval_mode_drops": dict(init_values=0.5, drop_path=0.2, proj_drop=0.1, attn_drop=0.1),
}


def _block_kwargs(opts, lib):
    kw = dict(opts)
    if "mlp_layer" in kw:
        kw["mlp_layer"] = getattr(lib, kw["mlp_layer"])
    return kw


@pytest.mark.parametrize("case", sorted(BLOCK_OPTIONS))
def test_self_attention_block_options_match_jax(case):
    opts = BLOCK_OPTIONS[case]
    jmod = jblocks.SelfAttentionBlock(64, 4, mlp_ratio=4.0, norm_layer=jblocks.layer_norm_factory(1e-6),
                                      rngs=nnx.Rngs(0), **_block_kwargs(opts, jblocks))
    tmod = blocks.SelfAttentionBlock(64, 4, mlp_ratio=4.0, norm_layer=blocks.layer_norm_factory(1e-6),
                                     **_block_kwargs(opts, blocks))
    assert sorted(tmod.state_dict()) == sorted(state_dict_from_module(jmod))
    jmod, tmod = _pair(jmod, tmod)
    x = np.random.RandomState(6).randn(2, 13, 64).astype(np.float32)
    _close(tmod(torch.from_numpy(x)), jmod(jnp.asarray(x)))


@pytest.mark.parametrize("case", ["dinov2_swiglu", "qk_norm_layerscale"])
def test_cross_attention_block_options_match_jax(case):
    opts = BLOCK_OPTIONS[case]
    jmod = jblocks.CrossAttentionBlock(64, 4, rngs=nnx.Rngs(0), **_block_kwargs(opts, jblocks))
    tmod = blocks.CrossAttentionBlock(64, 4, **_block_kwargs(opts, blocks))
    assert sorted(tmod.state_dict()) == sorted(state_dict_from_module(jmod))
    jmod, tmod = _pair(jmod, tmod)
    rng = np.random.RandomState(7)
    x, y = rng.randn(2, 6, 64).astype(np.float32), rng.randn(2, 9, 64).astype(np.float32)
    _close(tmod(torch.from_numpy(x), torch.from_numpy(y)), jmod(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("kind", ["Dropout", "DropPath"])
@pytest.mark.parametrize("rate,training", [(0.0, True), (0.0, False), (0.4, False)],
                         ids=["zero_train", "zero_eval", "eval"])
def test_dropout_and_drop_path_are_identities_where_jax_is(kind, rate, training):
    x = np.random.RandomState(8).randn(4, 5, 16).astype(np.float32)
    jmod = nnx.Dropout(rate, rngs=nnx.Rngs(0)) if kind == "Dropout" else jblocks.DropPath(rate, rngs=nnx.Rngs(0))
    tmod = getattr(blocks, kind)(rate, generator=torch.Generator().manual_seed(0))
    tmod.train(training)
    if not training:
        jmod.eval()
    want = np.asarray(jmod(jnp.asarray(x)))
    np.testing.assert_array_equal(want, x)
    np.testing.assert_array_equal(tmod(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("kind", ["Dropout", "DropPath"])
def test_dropout_and_drop_path_keep_rate_and_scale_in_training(kind):
    "At rate 0.25 in training: about 3/4 kept (per element, or per sample), each kept one scaled by 4/3; the mask is"
    " the generator's, so one seed gives one mask."
    rate, n = 0.25, 4000
    x = torch.from_numpy(np.random.RandomState(9).rand(n, 3, 8).astype(np.float32) + 0.5)

    def run(seed):
        return getattr(blocks, kind)(rate, generator=torch.Generator().manual_seed(seed)).train()(x)

    out = run(1)
    kept = out != 0
    if kind == "DropPath":  # one draw per sample: a sample is kept or dropped whole
        assert torch.equal(kept.all(-1).all(-1), kept.any(-1).any(-1))
        share = kept[:, 0, 0].float().mean().item()
        sigma = math.sqrt(rate * (1 - rate) / n)
    else:
        share = kept.float().mean().item()
        sigma = math.sqrt(rate * (1 - rate) / kept.numel())
    assert abs(share - (1 - rate)) <= 5 * sigma, share
    torch.testing.assert_close(out[kept], x[kept] / (1 - rate), rtol=1e-6, atol=0)
    assert torch.equal(run(1), out) and not torch.equal(run(2), out)


def test_fused_rule_sends_qk_norm_to_the_unfused_path(monkeypatch):
    """Under "fused" a qk-norm attention does not fit the fused kernel, which projects straight into attention:
    the rule refuses it (JAX nn/blocks.py:261-262) and the module equals JAX's; without qk-norm it is taken."""
    monkeypatch.setenv("UNICEPTION_TPU_PALLAS_INTERPRET", "1")  # JAX's fused rule as on a TPU
    calls = []
    monkeypatch.setattr(blocks, "fused_qkv_rope_attention", lambda *a: calls.append(a) or None)
    jmod, tmod = _pair(jblocks.Attention(64, num_heads=4, qkv_bias=True, qk_norm=True, rngs=nnx.Rngs(0)),
                       blocks.Attention(64, num_heads=4, qkv_bias=True, qk_norm=True))
    x = np.random.RandomState(10).randn(2, 12, 64).astype(np.float32)
    jax_config.set_attention_impl("fused")
    config.set_attention_impl("fused")
    assert not blocks._fused_attention_applicable(tmod, 12) and not jblocks._fused_attention_applicable(jmod, 12)
    _close(tmod(torch.from_numpy(x)), jmod(jnp.asarray(x)))
    assert calls == []
    plain = blocks.Attention(64, num_heads=4, qkv_bias=True)
    assert blocks._fused_attention_applicable(plain, 12)


def test_trunc_normal_matches_jax_law():
    "std times a unit normal truncated to (-2, 2), as jax.nn.initializers.truncated_normal draws it."
    t = trunc_normal(torch.empty(200_000), 0.02, generator=torch.Generator().manual_seed(0))
    j = np.asarray(jax.nn.initializers.truncated_normal(stddev=0.02)(jax.random.key(0), (200_000,)))
    for a in (t.numpy(), j):  # the unit normal truncated to (-2, 2) has standard deviation 0.8796
        assert abs(a.std() - 0.02 * 0.87962566) < 3e-4 and abs(a.mean()) < 3e-4
        assert np.abs(a).max() <= 2 * 0.02 + 1e-7
    assert abs(np.abs(t.numpy()).max() - np.abs(j).max()) < 1e-3
    again = trunc_normal(torch.empty(200_000), 0.02, generator=torch.Generator().manual_seed(0))
    assert torch.equal(t, again)


@pytest.mark.parametrize("grid,offset", [((6, 5), 0.1), ((5, 6), 0.1), ((3, 7), 0.0), ((6, 6), 0.1), ((4, 4), 0.1),
                                         ((37, 37), 0.1), ((8, 3), 0.0)])
def test_interpolate_patch_pos_embed_matches_jax(grid, offset):
    "A 4 x 4 table (a 16 x 16 one for the 37 x 37 grid) onto square and non-square grids, with and without offset."
    m = 16 if grid == (37, 37) else 4
    table = np.random.RandomState(11).randn(1, m * m, 24).astype(np.float32)
    got = pe_utils.interpolate_patch_pos_embed(torch.from_numpy(table), *grid, interpolate_offset=offset)
    want = jpe.interpolate_patch_pos_embed(jnp.asarray(table), *grid, interpolate_offset=offset)
    assert tuple(got.shape) == (1, grid[0] * grid[1], 24)
    _close(got, want, 1e-5)


def test_pos_embed_interpolation_is_row_major_over_height_then_width():
    "Rows of the output grid follow the height: a table constant along columns stays so along the output's columns."
    col = np.arange(4, dtype=np.float32)[:, None].repeat(4, 1)  # value = row index
    table = torch.from_numpy(col.reshape(1, 16, 1))
    out = pe_utils.interpolate_patch_pos_embed(table, 6, 5).reshape(6, 5)
    assert torch.allclose(out, out[:, :1].expand(6, 5), atol=1e-6)  # constant along each output row
    assert (out[1:, 0] > out[:-1, 0]).all()  # increasing down the height


@pytest.mark.parametrize("dim,grid,cls", [(16, 4, 0), (64, 7, 1), (32, 5, 2)])
def test_2d_sincos_table_is_jax_bit_for_bit(dim, grid, cls):
    np.testing.assert_array_equal(pe_utils.get_2d_sincos_pos_embed(dim, grid, cls),
                                  jpe.get_2d_sincos_pos_embed(dim, grid, cls))
