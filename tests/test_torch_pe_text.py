"""
The port's Perception Encoder language side against the JAX package on the CPU, in fp32: the vendored Llama
transformer (transformer.py: the rotary table with Llama-3's long-context scaling, the rotation, repeat_kv,
cross_entropy, RMSNorm, grouped-query Attention without a mask, causal and with an additive mask, the SwiGLU
FeedForward's sizing, TransformerBlock and BaseTransformer), the masked PE SelfAttention, the TextTransformer under
each pool and option, and CLIP (image, video, text, logit scale, ``from_config`` with a strict load of a JAX-written
checkpoint). Widths are narrow (64 wide, 2 layers, a context of 8, a vocabulary of 100); each JAX module is built
from seeded numpy weights and carried across by ``state_dict_from_module`` -> ``load_state_dict_numpy`` (strict);
inputs come from numpy.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.libs.perception_encoder import pe as jpe
from uniception_tpu.models.libs.perception_encoder import transformer as jt
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch.models.libs.perception_encoder import pe as tpe
from uniception_tpu_torch.models.libs.perception_encoder import transformer as tt
from tests.test_torch_cosmos import _close, _randn
from tests.test_torch_heads import carry, seeded_jax

_jax_forward = nnx.jit(lambda m, *args: m(*args))

WIDTH, LAYERS, CONTEXT, VOCAB = 64, 2, 8, 100


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    "Two intra-op threads: small CPU modules in several test workers (see tests/test_torch_training_paths.py)."
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _pair(jctor, tmod, seed=0):
    jmod = seeded_jax(jctor, seed)
    return jmod, carry(jmod, tmod)


def _tokens(seed, b=3, n=CONTEXT):
    "Token ids in [1, VOCAB - 2] with each row's EOT (VOCAB - 1, its highest id) at a row-dependent place."
    ids = np.random.RandomState(seed).randint(1, VOCAB - 1, (b, n)).astype(np.int32)
    ids[np.arange(b), (np.arange(b) * 3 + 2) % n] = VOCAB - 1
    return ids


# --- transformer.py ------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("scale_factor", [1, 8])
def test_rotary_table_matches_jax(scale_factor):
    """cos / sin at 1024 positions, without and with Llama-3's long-context scaling (an old context of 64, so the
    high-, low- and smoothed-frequency branches all occur), and through tok_idx."""
    kw = dict(max_seqlen=1024, scale_factor=scale_factor, low_freq_factor=1, high_freq_factor=4, old_context_len=64)
    j, t = jt.RotaryEmbedding(500000.0, 32, **kw), tt.RotaryEmbedding(500000.0, 32, **kw)
    assert not t.state_dict()  # recomputed, not stored
    for got, want in zip(t(seqlen=1024), j(seqlen=1024)):
        _close(got, want)
    idx = np.array([5, 0, 1023, 77])
    for got, want in zip(t(tok_idx=torch.from_numpy(idx)), j(tok_idx=jnp.asarray(idx))):
        _close(got, want)
    if scale_factor != 1:  # the scaling moved the low frequencies
        assert not torch.allclose(t.cos, tt.RotaryEmbedding(500000.0, 32, max_seqlen=1024).cos)


def test_rotation_repeat_kv_and_cross_entropy_match_jax():
    cos, sin = tt.RotaryEmbedding(10000.0, 16, 12)(seqlen=12)
    _, q, jq = _randn(1, 2, 12, 4, 16)
    _, k, jk = _randn(2, 2, 12, 4, 16)
    for got, want in zip(tt.apply_rotary_emb(q, k, cos, sin),
                         jt.apply_rotary_emb(jq, jk, jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))):
        _close(got, want)
    _close(tt.repeat_kv(k, 3), jt.repeat_kv(jk, 3))
    assert tt.repeat_kv(k, 1) is k
    _, logits, jlogits = _randn(3, 2, 5, 11, scale=3.0)
    target = np.random.RandomState(4).randint(0, 11, (2, 5))
    _close(tt.cross_entropy(logits, torch.from_numpy(target)), jt.cross_entropy(jlogits, jnp.asarray(target)))


def test_rms_norm_matches_jax():
    jm, tm = _pair(lambda: jt.LlamaRMSNorm(WIDTH, eps=1e-5), tt.LlamaRMSNorm(WIDTH, eps=1e-5))
    _, x, jx = _randn(5, 2, 7, WIDTH, scale=3.0)
    _close(tm(x), jm(jx))
    assert tm(x.bfloat16()).dtype == torch.bfloat16


def _mask(kind, n):
    if kind == "additive":
        a = np.where(np.random.RandomState(6).rand(n, n) < 0.3, -np.inf, np.random.RandomState(7).randn(n, n))
        np.fill_diagonal(a, 0.0)  # every row keeps a key
        a = a.astype(np.float32)
        return torch.from_numpy(a), jnp.asarray(a)
    return kind, kind


@pytest.mark.parametrize("mask", [None, "causal", "additive"])
@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_attention_matches_jax(mask, n_kv_heads):
    "GQA attention (4 query heads over 4 or 2 key/value heads): K1's plain version without a mask, else the einsum."
    jm, tm = _pair(lambda: jt.Attention(WIDTH, 16, 4, n_kv_heads, 10000.0, rngs=nnx.Rngs(0)),
                   tt.Attention(WIDTH, 16, 4, n_kv_heads, 10000.0))
    assert tm.wk.weight.shape == (16 * n_kv_heads, WIDTH)
    cos, sin = tt.RotaryEmbedding(10000.0, 16, 12)(seqlen=12)
    _, x, jx = _randn(8, 2, 10, WIDTH)
    tmask, jmask = _mask(mask, 10) if mask else (None, None)
    got = tm(x, cos, sin, mask=tmask)
    _close(got, jm(jx, jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), mask=jmask))
    if mask == "causal":  # the first tokens do not see the later ones
        _close(tm(x[:, :4], cos, sin, mask="causal"), got[:, :4].numpy())


@pytest.mark.parametrize("multiplier", [None, 1.3])
def test_feed_forward_sizing_matches_jax(multiplier):
    "2/3 of 4 * dim, times the multiplier, rounded up to multiple_of: 192 or 224 at dim 64, multiple_of 32."
    jm, tm = _pair(lambda: jt.FeedForward(WIDTH, 4 * WIDTH, 32, multiplier, rngs=nnx.Rngs(0)),
                   tt.FeedForward(WIDTH, 4 * WIDTH, 32, multiplier))
    assert tm.hidden_dim == jm.hidden_dim == (192 if multiplier is None else 224)
    _, x, jx = _randn(9, 2, 5, WIDTH)
    _close(tm(x), jm(jx))


def _jax_base_transformer(args):
    "The JAX BaseTransformer from seeded weights, its rotary table (a plain variable, zeros when built abstractly) set."
    jm = seeded_jax(lambda: jt.BaseTransformer(args, rngs=nnx.Rngs(0)))
    jm.rope_embeddings = jt.RotaryEmbedding(args.rope_theta, args.head_dim or args.dim // args.n_heads,
                                            args.max_seqlen, args.rope_scale_factor, args.low_freq_factor,
                                            args.high_freq_factor, args.old_context_len)
    return jm


@pytest.mark.parametrize("mask", [None, "causal", "additive"])
def test_base_transformer_matches_jax(mask):
    "Two GQA blocks (4 heads over 2), the block's keys, the shared rotary table, each mask kind."
    args = jt.BaseTransformerArgs(dim=WIDTH, n_layers=LAYERS, n_heads=4, n_kv_heads=2, max_seqlen=16, multiple_of=32,
                                  rope_theta=500000.0)
    jm = _jax_base_transformer(args)
    tm = carry(jm, tt.BaseTransformer(tt.BaseTransformerArgs(**args.__dict__)))
    assert {"layers.1.attention.wq.weight", "layers.0.feed_forward.w3.weight", "layers.0.ffn_norm.weight"} <= \
        set(tm.state_dict())
    _, x, jx = _randn(10, 2, 16, WIDTH)
    tmask, jmask = _mask(mask, 16) if mask else (None, None)
    _close(tm(x, mask=tmask), jm(jx, mask=jmask))


def test_block_and_args_defaults_match_jax():
    assert tt.BaseTransformerArgs() == tt.BaseTransformerArgs(**jt.BaseTransformerArgs().__dict__)
    assert [m.value for m in tt.InitStdFactor] == [m.value for m in jt.InitStdFactor]
    args = jt.BaseTransformerArgs(dim=WIDTH, n_heads=4, multiple_of=32)
    jm, tm = _pair(lambda: jt.TransformerBlock(args, rngs=nnx.Rngs(0)),
                   tt.TransformerBlock(tt.BaseTransformerArgs(**args.__dict__)))
    assert (tm.head_dim, tm.n_heads, tm.n_kv_heads) == (jm.head_dim, jm.n_heads, jm.n_kv_heads) == (16, 4, 4)
    cos, sin = tt.RotaryEmbedding(10000.0, 16, 8)(seqlen=8)
    _, x, jx = _randn(11, 1, 8, WIDTH)
    _close(tm(x, cos, sin), jm(jx, jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())))


# --- pe.py: the masked attention, the text tower, CLIP -------------------------------------------------------------


@pytest.mark.parametrize("mask", ["causal", "additive"])
def test_masked_self_attention_matches_jax(mask):
    "PE's SelfAttention with attn_mask: the einsum with fp32 logits (the unmasked path is tests/test_torch_pe.py's)."
    jm, tm = _pair(lambda: jpe.SelfAttention(WIDTH, 4, rngs=nnx.Rngs(0)), tpe.SelfAttention(WIDTH, 4))
    _, x, jx = _randn(12, 2, CONTEXT, WIDTH)
    a = tpe.causal_mask(CONTEXT) if mask == "causal" else _mask("additive", CONTEXT)[0]
    _close(tm(x, attn_mask=a), jm(jx, attn_mask=jnp.asarray(a.numpy())))


TEXT_OPTIONS = {
    "argmax": dict(),
    "first": dict(pool_type="first"),
    "last": dict(pool_type="last", proj_bias=True),
    "none": dict(pool_type="none", output_tokens=True),
    "no causal mask": dict(no_causal_mask=True, ls_init_value=0.1),
    "no ln_final": dict(use_ln_post=False, output_tokens=True),
}


@pytest.mark.parametrize("option", list(TEXT_OPTIONS))
def test_text_transformer_matches_jax(option):
    "Each pool (argmax: the EOT, each row's highest id), the projection with a bias, tokens out, no mask, no norm."
    kw = dict(context_length=CONTEXT, vocab_size=VOCAB, width=WIDTH, heads=4, layers=LAYERS, output_dim=32,
              **TEXT_OPTIONS[option])
    jm, tm = _pair(lambda: jpe.TextTransformer(rngs=nnx.Rngs(0), **kw), tpe.TextTransformer(**kw))
    keys = set(tm.state_dict())
    assert {"token_embedding.weight", "positional_embedding", "transformer.resblocks.1.attn.in_proj_weight"} <= keys
    assert ("text_projection.bias" in keys) == bool(kw.get("proj_bias"))
    ids = _tokens(13)
    got, want = tm(torch.from_numpy(ids).long()), _jax_forward(jm, jnp.asarray(ids))
    if kw.get("output_tokens"):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        assert got.shape == (3, 32)
        _close(got, want)


def test_text_transformer_is_causal():
    "With the causal mask a row's first k outputs depend only on its first k tokens (pool 'none', tokens out)."
    kw = dict(context_length=CONTEXT, vocab_size=VOCAB, width=WIDTH, heads=4, layers=LAYERS, output_dim=32,
              pool_type="none", output_tokens=True)
    tm = tpe.TextTransformer(**kw, generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_tokens(14)).long()
    other = ids.clone()
    other[:, 5:] = 3
    a, b = tm(ids)[1], tm(other)[1]
    assert torch.equal(a[:, :5], b[:, :5]) and not torch.equal(a[:, 5:], b[:, 5:])


def _clip_configs(mod):
    "A narrow PE-Core-L14 CLIP: ViT 64 wide at 28 x 28 (patch 14, a cls token, heads of 16), the text tower above."
    vision = mod.PEConfig(image_size=28, patch_size=14, width=WIDTH, layers=LAYERS, heads=4, mlp_ratio=4.0,
                          pool_type="attn", output_dim=32, use_cls_token=True, attn_pooler_heads=2)
    text = mod.PETextConfig(context_length=CONTEXT, width=WIDTH, heads=4, layers=LAYERS, output_dim=32,
                            vocab_size=VOCAB)
    return vision, text


@pytest.fixture
def narrow_clip(monkeypatch):
    "PE-Core-L14-336's vision and text configs replaced by _clip_configs in both packages' tables."
    for mod in (jpe, tpe):
        vision, text = _clip_configs(mod)
        monkeypatch.setitem(mod.PE_VISION_CONFIG, "PE-Core-L14-336", vision)
        monkeypatch.setitem(mod.PE_TEXT_CONFIG, "PE-Core-L14-336", text)


def test_clip_matches_jax():
    "encode_image (K1's plain version), encode_video, encode_text, the normalized forward and exp(logit_scale)."
    jm, tm = _pair(lambda: jpe.CLIP(*_clip_configs(jpe), rngs=nnx.Rngs(0)), tpe.CLIP(*_clip_configs(tpe)))
    assert {"visual.attn_pool.probe", "logit_scale", "text_projection", "visual.proj"} <= set(tm.state_dict())
    img = np.random.RandomState(15).randn(2, 3, 28, 28).astype(np.float32)
    ids = _tokens(16, b=2)
    got = tm(torch.from_numpy(img), torch.from_numpy(ids).long())
    want = _jax_forward(jm, jnp.asarray(img), jnp.asarray(ids))
    for g, w in zip(got, want):
        _close(g, w)
    assert got[0].shape == got[1].shape == (2, 32)
    np.testing.assert_allclose(torch.linalg.vector_norm(got[0], dim=-1).numpy(), 1.0, rtol=1e-6)
    _close(tm.encode_image(torch.from_numpy(img)), jm.encode_image(jnp.asarray(img)))
    _close(tm.encode_text(torch.from_numpy(ids).long(), normalize=True),
           jm.encode_text(jnp.asarray(ids), normalize=True))
    video = np.random.RandomState(17).randn(2, 3, 3, 28, 28).astype(np.float32)
    _close(tm.encode_video(torch.from_numpy(video), normalize=True),
           jm.encode_video(jnp.asarray(video), normalize=True))
    assert tm.forward(text=torch.from_numpy(ids).long())[0] is None
    assert math.isclose(float(tpe.CLIP(*_clip_configs(tpe)).forward()[2]), 1 / 0.07, rel_tol=1e-6)


def test_clip_from_config_loads_a_jax_checkpoint_strictly(tmp_path, narrow_clip):
    """from_config builds the named config; ``pretrained`` without a file raises naming the missing checkpoint; a
    JAX-written state dict (under ``state_dict``, with "module." prefixes) loads strictly, a missing key raises."""
    assert tpe.CLIP.available_configs() == jpe.CLIP.available_configs()
    with pytest.raises(ValueError, match="CLIP checkpoint is not in the repository"):
        tpe.CLIP.from_config("PE-Core-L14-336", pretrained=True)
    with pytest.raises(RuntimeError, match="not found in configs"):
        tpe.CLIP.from_config("PE-Spatial-G14-448")
    jm = seeded_jax(lambda: jpe.CLIP(*_clip_configs(jpe), rngs=nnx.Rngs(0)))
    state = {f"module.{k}": torch.from_numpy(np.array(v)) for k, v in state_dict_from_module(jm).items()}
    path = str(tmp_path / "clip.pth")
    torch.save({"state_dict": state}, path)
    tm = tpe.CLIP.from_config("PE-Core-L14-336", pretrained=True, checkpoint_path=path, device="cpu")
    assert tm.visual.image_size == 28 and tm.context_length == CONTEXT
    ids = _tokens(18, b=2)
    _close(tm.encode_text(torch.from_numpy(ids).long()), jm.encode_text(jnp.asarray(ids)))
    state.pop("module.visual.proj")
    torch.save({"state_dict": state}, path)
    with pytest.raises(KeyError, match="missing_keys=\\['visual.proj'\\]"):
        tpe.CLIP.from_config("PE-Core-L14-336", pretrained=True, checkpoint_path=path)
