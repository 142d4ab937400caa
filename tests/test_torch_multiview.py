"""
The port's N-frame multi-view pointmap model against the JAX package on the
CPU: the sinusoid index table, the frame reshape, the global-attention
transformer (view-index encodings, random indices, extra tokens, RoPE), the
multi-set transformer, the alternating transformer, both IFR variants and
MultiViewPointmapModel (fp32 and bf16); its int8 trunk's layer count, the
attention routing of its layers at the full ViT-L 512 shapes (read on meta
tensors), the options the port refuses, and its checkpoints both ways
through the JAX package's native files. Weights go from the port's seeded
modules into JAX modules built from zeros; inputs come from numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.encoders.pe_utils import sinusoid_encoding_table as jax_sinusoid_encoding_table
from uniception_tpu.models.factory.multiview import MultiViewPointmapModel as JaxMultiView
from uniception_tpu.models.info_sharing import alternating_attention_transformer as jalt
from uniception_tpu.models.info_sharing import global_attention_transformer as jglobal
from uniception_tpu.models.info_sharing.base import MultiSetTransformerInput as JaxSetInput
from uniception_tpu.models.info_sharing.base import MultiViewTransformerInput as JaxViewInput
from uniception_tpu.nn.quant import Int8Linear as JaxInt8Linear
from uniception_tpu.nn.quant import quantize_linears as jax_quantize_linears
from uniception_tpu.utils import coldstart as jcs
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch import serve
from uniception_tpu_torch.models.encoders.pe_utils import sinusoid_encoding_table
from uniception_tpu_torch.models.factory.multiview import MultiViewPointmapModel
from uniception_tpu_torch.models.info_sharing import alternating_attention_transformer as alt
from uniception_tpu_torch.models.info_sharing import global_attention_transformer as glob
from uniception_tpu_torch.models.info_sharing.base import MultiSetTransformerInput, MultiViewTransformerInput
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn import blocks, quant
from uniception_tpu_torch.nn.quant import quantize_trunk
from uniception_tpu_torch.ops import attention
from uniception_tpu_torch.utils import coldstart
from uniception_tpu_torch.utils.weights import load_state_dict_numpy
from tests.test_torch_dpt import _composed_tol
from tests.test_torch_quant import jax_module

TOL = 5e-5  # fp32 max abs, the repo's parity bar per module
SMALL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=48, info_sharing_depth=2,
             info_sharing_num_heads=4)
# bf16 trunks (the port's and JAX's), ||port - jax|| / ||jax|| per output: both round every layer's output to bf16,
# in different orders of operations, so they differ by about what bf16 costs either side. Measured on the CPU over
# both attention types and two inputs: port vs JAX 0.80e-2 to 1.26e-2, JAX bf16 vs JAX fp32 0.66e-2 to 1.15e-2. The
# bar is the kernel path's bf16 bar (chip_smoke.py MODEL_REL_TOL).
BF16_REL_TOL = 2e-2
# the full-size multi-view configuration (scripts/bench_multiview.py): ViT-L 512 encoder, 12 x 768 info sharing
ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, TOKENS = 24, 1024, 16, 12, 768, 12, 1024


# the JAX modules' forward, compiled: one compile per configuration costs a fraction of an eager first call's op-by-op
# compiles on the CPU
_jax_forward = nnx.jit(lambda m, *args: m(*args))


def _jax_tables(jmod):
    """Give a JAX module built from zeros its sinusoid tables, which a JAX module keeps as plain array attributes
    that abstract construction leaves unset; the values are the ones the JAX constructor computes."""
    for _, m in nnx.iter_modules(jmod):
        for attr, n in (("view_pos_table", getattr(m, "max_num_views_for_pe", 0)),
                        ("set_pos_table", getattr(m, "max_num_sets", 0))):
            if hasattr(m, attr):
                n = n if attr == "set_pos_table" or m.use_pe_for_non_reference_views else 1
                setattr(m, attr, jnp.asarray(jax_sinusoid_encoding_table(n, m.dim, 10000.0)))
    return jmod


def _carry(jax_ctor, tmod, seed=0):
    "(JAX module with the port module's weights, every bias made non-zero; the port module in eval mode)."
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in tmod.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    jmod = _jax_tables(jax_module(jax_ctor))
    load_torch_state_dict(jmod, {k: v.float().numpy() for k, v in tmod.state_dict().items()}, verbose=False)
    return jmod, tmod.eval()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol, err


def _view_inputs(rng, views=3, b=2, c=32, h=4, w=6, per_view=0, n_global=0):
    "(port input, JAX input) of per-view BCHW features and optional extra tokens."
    feats = [rng.randn(b, c, h, w).astype(np.float32) for _ in range(views)]
    pv = [rng.randn(b, c, per_view).astype(np.float32) for _ in range(views)] if per_view else None
    g = rng.randn(b, c, n_global).astype(np.float32) if n_global else None
    t = MultiViewTransformerInput(
        features=[torch.from_numpy(f) for f in feats],
        additional_input_tokens=None if g is None else torch.from_numpy(g),
        additional_input_tokens_per_view=None if pv is None else [torch.from_numpy(x) for x in pv],
    )
    j = JaxViewInput(features=[jnp.asarray(f) for f in feats],
                     additional_input_tokens=None if g is None else jnp.asarray(g),
                     additional_input_tokens_per_view=None if pv is None else [jnp.asarray(x) for x in pv])
    return t, j


def _same_outputs(out, ref):
    "Every per-view feature and every extra token's feature of a MultiViewTransformerOutput at the fp32 bar."
    assert (out.additional_token_features is None) == (ref.additional_token_features is None)
    assert (out.additional_token_features_per_view is None) == (ref.additional_token_features_per_view is None)
    extra = [] if out.additional_token_features is None else [out.additional_token_features]
    extra_ref = [] if ref.additional_token_features is None else [ref.additional_token_features]
    for got, want in zip(out.features + extra + (out.additional_token_features_per_view or []),
                         ref.features + extra_ref + (ref.additional_token_features_per_view or [])):
        _close(got, want)


@pytest.mark.parametrize("n,d,base", [(1000, 768, 10000.0), (7, 48, 10000.0), (13, 30, 70007.0)])
def test_sinusoid_encoding_table_is_jax_bit_for_bit(n, d, base):
    ours, ref = sinusoid_encoding_table(n, d, base), jax_sinusoid_encoding_table(n, d, base)
    assert ours.dtype == np.float32 and np.array_equal(ours, ref)


def test_frame_reshape_round_trip_and_row_order():
    B, V, T, C = 2, 3, 5, 8
    x = np.random.RandomState(0).randn(B, V * T, C).astype(np.float32)
    framed = alt.reshape_for_frame_attention(torch.from_numpy(x), V, T, C)
    np.testing.assert_array_equal(framed.numpy(), np.asarray(jalt.reshape_for_frame_attention(jnp.asarray(x), V, T, C)))
    for b in range(B):
        for v in range(V):  # row b * V + v is view v of batch b
            np.testing.assert_array_equal(framed[b * V + v].numpy(), x[b, v * T:(v + 1) * T])
    np.testing.assert_array_equal(alt.reshape_from_frame_attention(framed, B, V, T, C).numpy(), x)


GLOBAL_CASES = {  # (constructor options, input options); one block, but for the first: the options act around it
    "sequential-pe": (dict(depth=2, use_rand_idx_pe_for_non_reference_views=False), {}),
    "no-nonref-pe": (dict(use_pe_for_non_reference_views=False), {}),
    "no-view-pe": (dict(distinguish_ref_and_non_ref_views=False), {}),
    "random-pe": (dict(max_num_views_for_pe=20), {}),
    "extra-tokens": (dict(use_rand_idx_pe_for_non_reference_views=False), dict(per_view=3, n_global=2)),
    "rope": (dict(custom_positional_encoding="rope", use_rand_idx_pe_for_non_reference_views=False), {}),
    "same-width": (dict(dim=32, num_heads=2, use_rand_idx_pe_for_non_reference_views=False), {}),
}


def _injected_indices(monkeypatch, cls, views, high):
    """JAX's random view indices from a key, and the port's _nonref_pe_indices made to return them (jax.random's
    bits have no torch counterpart). Returns the key to give the JAX module."""
    key = jax.random.key(5)
    drawn = np.asarray(jax.random.randint(key, (views - 1,), 1, high))
    monkeypatch.setattr(cls, "_nonref_pe_indices", lambda self, n, g: torch.tensor(drawn, dtype=torch.long))
    return key


@pytest.mark.parametrize("case", sorted(GLOBAL_CASES))
def test_global_transformer_matches_jax(case, monkeypatch):
    opts, inputs = GLOBAL_CASES[case]
    kw = dict(name="g", input_embed_dim=32, dim=48, depth=1, num_heads=4)
    kw.update(opts)
    jmod, tmod = _carry(lambda: jglobal.MultiViewGlobalAttentionTransformer(rngs=nnx.Rngs(0), **kw),
                        glob.MultiViewGlobalAttentionTransformer(generator=torch.Generator().manual_seed(1), **kw))
    assert not any("pos_table" in k for k in tmod.state_dict())
    if kw.get("dim", 48) == 32:
        assert isinstance(tmod.proj_embed, torch.nn.Identity)
    key = None
    if case == "random-pe":
        key = _injected_indices(monkeypatch, glob.MultiViewGlobalAttentionTransformer, 3, 20)
    t_in, j_in = _view_inputs(np.random.RandomState(3), **inputs)
    ref = _jax_forward(jmod, j_in, key)
    with torch.no_grad():
        out = tmod(t_in, generator=torch.Generator().manual_seed(0) if key is not None else None)
    _same_outputs(out, ref)


def test_random_view_indices_come_from_the_generator():
    kw = dict(name="g", input_embed_dim=32, dim=48, depth=1, num_heads=4, max_num_views_for_pe=50)
    m = glob.MultiViewGlobalAttentionTransformer(**kw)
    a = m._nonref_pe_indices(6, torch.Generator().manual_seed(4))
    assert torch.equal(a, m._nonref_pe_indices(6, torch.Generator().manual_seed(4)))
    assert a.shape == (5,) and int(a.min()) >= 1 and int(a.max()) < 50
    assert torch.equal(m._nonref_pe_indices(6, None), torch.arange(1, 6))
    seq = glob.MultiViewGlobalAttentionTransformer(use_rand_idx_pe_for_non_reference_views=False, **kw)
    assert torch.equal(seq._nonref_pe_indices(6, torch.Generator()), torch.arange(1, 6))


@pytest.mark.parametrize("random", [False, True], ids=["sequential", "random"])
def test_multi_set_transformer_matches_jax(random, monkeypatch):
    kw = dict(name="s", input_embed_dim=32, dim=48, depth=2, num_heads=4, max_num_sets=9,
              use_rand_idx_pe_for_non_reference_sets=random)
    jmod, tmod = _carry(lambda: jglobal.GlobalAttentionTransformer(rngs=nnx.Rngs(0), **kw),
                        glob.GlobalAttentionTransformer(generator=torch.Generator().manual_seed(1), **kw))
    key = _injected_indices(monkeypatch, glob.GlobalAttentionTransformer, 3, 9) if random else None
    rng = np.random.RandomState(4)
    sets = [rng.randn(2, 32, n).astype(np.float32) for n in (5, 11, 3)]  # uneven set sizes
    g = rng.randn(2, 32, 4).astype(np.float32)
    j_in = JaxSetInput(features=[jnp.asarray(s) for s in sets], additional_input_tokens=jnp.asarray(g))
    ref = _jax_forward(jmod, j_in, key)
    with torch.no_grad():
        out = tmod(MultiSetTransformerInput(features=[torch.from_numpy(s) for s in sets],
                                            additional_input_tokens=torch.from_numpy(g)),
                   generator=torch.Generator() if random else None)
    for got, want in zip(out.features, ref.features):
        _close(got, want)
    _close(out.additional_token_features, ref.additional_token_features)


@pytest.mark.parametrize("depth,inputs", [(4, dict(per_view=3, n_global=2)), (2, dict(n_global=5)), (2, {})],
                         ids=["per-view-and-global", "global", "none"])
def test_alternating_transformer_matches_jax(depth, inputs):
    "Depth 2 is one global and one frame layer; depth 4 also takes the global tokens from a frame layer back in."
    kw = dict(name="a", input_embed_dim=32, dim=48, depth=depth, num_heads=4, use_pe_for_non_reference_views=True,
              use_rand_idx_pe_for_non_reference_views=False)
    jmod, tmod = _carry(lambda: jalt.MultiViewAlternatingAttentionTransformer(rngs=nnx.Rngs(0), **kw),
                        alt.MultiViewAlternatingAttentionTransformer(generator=torch.Generator().manual_seed(1), **kw))
    t_in, j_in = _view_inputs(np.random.RandomState(5), **inputs)
    with torch.no_grad():
        _same_outputs(tmod(t_in), _jax_forward(jmod, j_in))


def test_alternating_transformer_with_rope_matches_jax():
    "The positions fold into the frame batch with the tokens (K2's plain version on the CPU)."
    kw = dict(name="a", input_embed_dim=32, dim=48, depth=2, num_heads=4, custom_positional_encoding="rope")
    jmod, tmod = _carry(lambda: jalt.MultiViewAlternatingAttentionTransformer(rngs=nnx.Rngs(0), **kw),
                        alt.MultiViewAlternatingAttentionTransformer(generator=torch.Generator().manual_seed(1), **kw))
    t_in, j_in = _view_inputs(np.random.RandomState(6))
    with torch.no_grad():
        _same_outputs(tmod(t_in), _jax_forward(jmod, j_in))


IFR = [dict(indices=[0, 2]), dict(indices=[-1, 1], norm_intermediate=False), dict(indices=2, intermediates_only=True)]


@pytest.mark.parametrize("ifr", IFR, ids=["indices", "raw", "only"])
@pytest.mark.parametrize("kind", ["global", "alternating"])
def test_ifr_variants_match_jax(kind, ifr):
    jcls, tcls = ((jglobal.MultiViewGlobalAttentionTransformerIFR, glob.MultiViewGlobalAttentionTransformerIFR)
                  if kind == "global" else
                  (jalt.MultiViewAlternatingAttentionTransformerIFR, alt.MultiViewAlternatingAttentionTransformerIFR))
    kw = dict(name="i", input_embed_dim=32, dim=48, depth=3, num_heads=4, use_rand_idx_pe_for_non_reference_views=False,
              **ifr)
    jmod, tmod = _carry(lambda: jcls(rngs=nnx.Rngs(0), **kw), tcls(generator=torch.Generator().manual_seed(1), **kw))
    t_in, j_in = _view_inputs(np.random.RandomState(7), n_global=2)
    ref = _jax_forward(jmod, j_in)
    with torch.no_grad():
        out = tmod(t_in)
    if ifr.get("intermediates_only"):
        ref, out = (None, ref), (None, out)
    else:
        _same_outputs(out[0], ref[0])
    assert len(out[1]) == len(ref[1])
    for o, r in zip(out[1], ref[1]):
        _same_outputs(o, r)


def _model_kw(attention_type, views=3):
    return dict(name="mv", num_views=views, img_size=(32, 48), attention_type=attention_type, **SMALL)


@functools.lru_cache(maxsize=None)
def _models(attention_type):
    "(JAX model, port model) with the same weights, fp32."
    kw = _model_kw(attention_type)
    return _carry(lambda: JaxMultiView(rngs=nnx.Rngs(0), **kw),
                  MultiViewPointmapModel(generator=torch.Generator().manual_seed(1), **kw))


def _views(seed=2, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 3, 32, 48).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("attention_type", ["alternating", "global"])
def test_multiview_model_matches_jax(attention_type):
    jmod, tmod = _models(attention_type)
    views = _views()
    ref = _jax_forward(jmod, [jnp.asarray(v) for v in views])
    with torch.no_grad():
        out = tmod([torch.from_numpy(v) for v in views])
    assert len(out) == 3
    for o, r in zip(out, ref):
        assert sorted(o) == ["conf", "pts3d"]
        assert tuple(o["pts3d"].shape) == (2, 32, 48, 3) and tuple(o["conf"].shape) == (2, 32, 48, 1)
        for key in o:
            want = np.asarray(r[key])
            assert np.abs(o[key].numpy() - want).max() <= _composed_tol(want), key


@pytest.mark.parametrize("attention_type", ["alternating", "global"])
def test_multiview_model_bf16_matches_jax_bf16(attention_type):
    "bf16 trunks on both sides (parameters and compute), fp32 heads and adaptor."
    _, tmod32 = _models(attention_type)
    kw = _model_kw(attention_type)
    tmod = MultiViewPointmapModel(dtype=torch.bfloat16, param_dtype=torch.bfloat16, **kw).eval()
    tmod.load_state_dict(tmod32.state_dict())
    jmod = _jax_tables(jax_module(lambda: JaxMultiView(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
                                                       rngs=nnx.Rngs(0), **kw)))
    load_torch_state_dict(jmod, {k: v.float().numpy() for k, v in tmod.state_dict().items()}, verbose=False)
    assert tmod.encoder.enc_blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert tmod.head.linear.weight.dtype == torch.float32
    views = _views()
    ref = _jax_forward(jmod, [jnp.asarray(v) for v in views])
    with torch.no_grad():
        out = tmod([torch.from_numpy(v) for v in views])
    for o, r in zip(out, ref):
        for key in o:
            want = np.asarray(r[key], np.float32)
            assert o[key].dtype == torch.float32
            rel = np.linalg.norm(o[key].numpy() - want) / np.linalg.norm(want)
            assert rel <= BF16_REL_TOL, (key, rel)


def test_state_dict_keys_match_jax_export():
    for attention_type in ("alternating", "global"):
        kw = _model_kw(attention_type)
        exported = state_dict_from_module(_jax_tables(jax_module(lambda: JaxMultiView(rngs=nnx.Rngs(0), **kw))))
        own = MultiViewPointmapModel(**kw).state_dict()
        assert sorted(own) == sorted(exported)
        assert all(tuple(v.shape) == exported[k].shape for k, v in own.items())
        assert not any("pos_table" in k for k in own)


def test_int8_trunk_converts_the_layers_jax_converts():
    """The port's quantize_trunk(model, "all") and bench_multiview.py's quantize_linears on the encoder and on the
    info sharing convert the same layers; min_params is scaled to the small widths on both sides (at ViT-L 512
    every trunk linear passes 2^16: 24 x 4 + 1 + 12 x 4 = 145)."""
    min_params = 48 * 48 * 3  # at these widths: every qkv, fc1 and fc2, and neither proj nor proj_embed
    kw = _model_kw("alternating")
    counts = []

    def quantized():  # traced on abstract arrays: the conversion compiles nothing
        m = JaxMultiView(rngs=nnx.Rngs(0), **kw)
        counts.extend(jax_quantize_linears(part, min_params=min_params) for part in (m.encoder, m.info_sharing))
        return m

    jmod = nnx.eval_shape(quantized)
    n_jax = sum(counts)
    tmod = MultiViewPointmapModel(**kw)
    assert quantize_trunk(tmod, "all", min_params=min_params) == n_jax == 2 * 3 + 2 * 3
    ours = {name for name, m in tmod.named_modules() if isinstance(m, quant.Int8Linear)}
    assert ours == {".".join(map(str, path)) for path, m in nnx.iter_modules(jmod) if isinstance(m, JaxInt8Linear)}
    assert ENC_DEPTH * 4 + 1 + DEC_DEPTH * 4 == 145
    assert min(ENC_DIM * ENC_DIM, ENC_DIM * DEC_DIM, DEC_DIM * DEC_DIM) >= 1 << 16


def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("attn_quant", ["none", "int8"])
@pytest.mark.parametrize("impl", ["kernel", "fused"])
def test_attention_routing_at_full_size_shapes(impl, attn_quant, monkeypatch):
    """Which kernel each attention layer of the 4- and 8-view model reaches, at ViT-L 512 shapes, on meta tensors
    (the wrappers replaced by recorders): K1 for the global layers (one key block cannot hold 4096 keys), K6 for the
    encoder and frame layers under int8 attention, K5-self for the encoder and the frame layers under "fused" (at
    most 2048 keys), and no K5 with an int8 trunk."""
    calls = []

    def recorder(name):
        def record(x, *args, **kwargs):  # K1 and K6 return q's shape, K5 x's (B, N, H * D)
            calls.append(name)
            return torch.empty_like(x)
        return record

    def k4(x, w_q, w_scale, bias=None, out_dtype=None):
        return torch.empty(*x.shape[:-1], w_q.shape[1], dtype=out_dtype or x.dtype, device=x.device)

    monkeypatch.setattr(attention, "flash_attention", recorder("K1"))
    monkeypatch.setattr(attention, "flash_attention_int8", recorder("K6"))
    monkeypatch.setattr(blocks, "fused_qkv_rope_attention", recorder("K5"))
    monkeypatch.setattr(quant, "int8_matmul_dynamic", k4)
    config.set_attention_impl(impl)
    config.set_attention_quant(attn_quant)
    try:
        with torch.device("meta"), torch.no_grad():
            enc = blocks.Attention(ENC_DIM, ENC_HEADS, qkv_bias=True, dtype=torch.bfloat16).to(torch.bfloat16)
            dec = blocks.Attention(DEC_DIM, DEC_HEADS, qkv_bias=True, dtype=torch.bfloat16).to(torch.bfloat16)
            local = {"fused": "K5", "kernel": "K6" if attn_quant == "int8" else "K1"}  # at most 1024 keys
            for layer, x, want in (
                ("encoder", _meta(4, TOKENS, ENC_DIM), local),
                ("frame", _meta(4, TOKENS, DEC_DIM), local),
                ("global 4 views", _meta(1, 4 * TOKENS, DEC_DIM), {"fused": "K1", "kernel": "K1"}),
                ("global 8 views", _meta(1, 8 * TOKENS, DEC_DIM), {"fused": "K1", "kernel": "K1"}),
            ):
                calls.clear()
                mod = enc if layer == "encoder" else dec
                mod(x, None)
                assert calls == [want[impl]], (layer, calls)
            quantize_trunk(torch.nn.ModuleDict(dict(encoder=enc, info_sharing=dec)), "all")
            for x in (_meta(4, TOKENS, DEC_DIM), _meta(1, 4 * TOKENS, DEC_DIM)):  # an int8 trunk leaves "fused"
                calls.clear()
                dec(x, None)
                assert calls == ["K6" if attn_quant == "int8" and impl == "kernel" and x.shape[1] == TOKENS else "K1"]
    finally:
        config.set_attention_impl("kernel")
        config.set_attention_quant("none")
    assert attention.single_key_block((4, TOKENS, DEC_HEADS, 64), TOKENS, torch.bfloat16)
    assert not attention.single_key_block((1, 4 * TOKENS, DEC_HEADS, 64), 4 * TOKENS, torch.bfloat16)


def test_routing_rules_at_full_size_shapes():
    "The two rules behind the routing above, read directly: one int8 key block, and the fused contract's 2048 keys."
    config.set_attention_quant("int8")
    try:
        for b, n, h, want in ((4, TOKENS, ENC_HEADS, True), (4, TOKENS, DEC_HEADS, True),
                              (1, 4 * TOKENS, DEC_HEADS, False), (1, 8 * TOKENS, DEC_HEADS, False)):
            q = _meta(b, n, h, 64)
            assert attention.uses_int8_attention(q, q, q) == want, (b, n, h)
    finally:
        config.set_attention_quant("none")
    config.set_attention_impl("fused")
    try:
        with torch.device("meta"):
            dec = blocks.Attention(DEC_DIM, DEC_HEADS, qkv_bias=True)
        assert [blocks._fused_attention_applicable(dec, n) for n in (TOKENS, 4 * TOKENS, 8 * TOKENS)] == [
            True, False, False]
        quant.quantize_linears(dec)
        assert not blocks._fused_attention_applicable(dec, TOKENS)  # int8 projections leave the fused contract
    finally:
        config.set_attention_impl("kernel")


@pytest.mark.parametrize("option", [dict(qk_norm=True), dict(init_values=1e-5), dict(drop_path=0.1),
                                    dict(proj_drop=0.1), dict(attn_drop=0.1), dict(act_layer=torch.nn.ReLU),
                                    dict(mlp_layer=torch.nn.Identity), dict(scan_blocks=True)],
                         ids=lambda o: next(iter(o)))
def test_unported_options_raise(option):
    """scan_blocks, an XLA layout, still raises; the block options once refused are now taken and reach every block
    as in the JAX package (act_layer is accepted and, as there, not passed on)."""
    kw = dict(name="g", input_embed_dim=32, dim=48, depth=2, num_heads=4)
    if "scan_blocks" in option:
        with pytest.raises(NotImplementedError, match="scan_blocks"):
            glob.MultiViewGlobalAttentionTransformer(**kw, **option)
        return
    if "mlp_layer" in option:
        option = dict(mlp_layer=lambda in_features, **_: torch.nn.Identity())
    model = glob.MultiViewGlobalAttentionTransformer(**kw, **option)
    for blk in model.self_attention_blocks:
        name = next(iter(option))
        if name == "qk_norm":
            assert isinstance(blk.attn.q_norm, blocks.LayerNorm) and isinstance(blk.attn.k_norm, blocks.LayerNorm)
        elif name == "init_values":
            assert torch.equal(blk.ls1.gamma, torch.full((48,), 1e-5)) and isinstance(blk.ls2, blocks.LayerScale)
        elif name == "drop_path":
            assert blk.drop_path1.drop_prob == blk.drop_path2.drop_prob == 0.1
        elif name == "proj_drop":
            assert blk.attn.proj_drop.p == blk.mlp.drop1.p == blk.mlp.drop2.p == 0.1
        elif name == "attn_drop":
            assert blk.attn.attn_drop == 0.1
        elif name == "act_layer":
            assert blk.mlp.act is blocks.gelu_exact
        else:
            assert isinstance(blk.mlp, torch.nn.Identity)


def test_multiview_model_refuses_what_it_does_not_take():
    # sequence parallelism is taken since the multi-GPU serving port (tests/test_torch_parallel_serving.py runs it)
    assert MultiViewPointmapModel(sequence_parallel=("mesh", "sp"), **_model_kw("global")).sequence_parallel == (
        "mesh", "sp")
    with pytest.raises(NotImplementedError, match="scan_blocks"):
        MultiViewPointmapModel(scan_blocks=True, **_model_kw("global"))
    with pytest.raises(ValueError, match="attention type"):
        MultiViewPointmapModel(**_model_kw("cross"))
    with pytest.raises(ValueError, match="Unknown custom positional encoding"):
        glob.MultiViewGlobalAttentionTransformer(name="g", input_embed_dim=32, dim=48, depth=1, num_heads=4,
                                                 custom_positional_encoding="sincos")
    rope = glob.MultiViewGlobalAttentionTransformer(name="g", input_embed_dim=32, dim=48, depth=1, num_heads=4,
                                                    custom_positional_encoding="rope")
    with pytest.raises(ValueError, match="additional tokens"):
        rope(_view_inputs(np.random.RandomState(0), n_global=1)[0])
    with pytest.raises(ValueError, match="3 views"):
        _models("global")[1]([torch.zeros(1, 3, 32, 48)] * 2)
    for bad in (dict(head="dpt"), dict(head_dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="linear head"):
            serve.build_model(32, 2, 64, 4, 2, 48, 4, device="cpu", model="multiview", **bad)


def _port_outputs(model, views):
    with torch.no_grad():
        return [{k: v.float().numpy() for k, v in o.items()} for o in model([torch.from_numpy(v) for v in views])]


@pytest.mark.parametrize("attention_type,layout", [("alternating", "loop"), ("alternating", "scan"),
                                                   ("global", "scan")])
def test_jax_native_state_serves_through_build_model(tmp_path, attention_type, layout):
    """A JAX MultiViewPointmapModel's native file (the scan layout stacks the 12-deep alternating blocks into one
    list) loads through serve.build_model(model="multiview") and gives JAX's outputs; its view_pos_table entry,
    recomputed here, is not loaded."""
    jmod, tmod = _models(attention_type)
    kw = _model_kw(attention_type)
    jscan = _jax_tables(jax_module(lambda: JaxMultiView(scan_blocks=layout == "scan", rngs=nnx.Rngs(0), **kw)))
    load_torch_state_dict(jscan, {k: v.numpy() for k, v in tmod.state_dict().items()}, verbose=False)
    path = str(tmp_path / "mv.nsv")
    jcs.save_native_state(path, jscan)
    arrays, _ = coldstart.load_native_state(path)
    assert "info_sharing.view_pos_table" in arrays
    assert ("info_sharing.self_attention_blocks.attn.qkv.kernel.value" in arrays) == (layout == "scan")
    loaded = serve.build_model((32, 48), 2, 64, 4, 2, 48, 4, device="cpu", dtype=torch.float32, checkpoint=path,
                               model="multiview", num_views=3, attention_type=attention_type)
    assert loaded.info_sharing.view_pos_table.device.type == "cpu"
    views = _views(seed=9)
    ref = _jax_forward(jmod, [jnp.asarray(v) for v in views])
    for o, r in zip(_port_outputs(loaded, views), ref):
        for key in o:
            want = np.asarray(r[key])
            assert np.abs(o[key] - want).max() <= _composed_tol(want), key


@pytest.mark.parametrize("layout", ["loop", "scan"])
def test_port_native_state_reads_back_in_jax(tmp_path, layout):
    """The port's native file (no sinusoid table: it is recomputed) serves in JAX through the JAX package's cold
    start, whose abstract construction leaves the table unset (so its own cold start of this model fails with or
    without the entry; the test sets the table), and back into the port bit for bit."""
    _, tmod = _models("global")
    path = str(tmp_path / "mv.nsv")
    coldstart.save_native_state(path, tmod, layout=layout)
    arrays, _ = coldstart.load_native_state(path)
    assert not any("pos_table" in p for p in arrays)
    kw = _model_kw("global")
    jmod = _jax_tables(jcs.materialize(jcs.abstract_construct(
        lambda: JaxMultiView(scan_blocks=layout == "scan", rngs=nnx.Rngs(0), **kw)), arrays=jcs.load_native_state(path)[0]))
    views = _views(seed=10)
    ref = _jax_forward(jmod, [jnp.asarray(v) for v in views])
    for o, r in zip(_port_outputs(tmod, views), ref):
        for key in o:
            want = np.asarray(r[key])
            assert np.abs(o[key] - want).max() <= _composed_tol(want), key
    built = coldstart.materialize(coldstart.abstract_construct(lambda: MultiViewPointmapModel(**kw)), arrays=arrays,
                                  device="cpu")
    assert all(torch.equal(v, tmod.state_dict()[k]) for k, v in built.state_dict().items())
    assert torch.equal(built.info_sharing.view_pos_table, tmod.info_sharing.view_pos_table)


@pytest.mark.parametrize("loader", ["build_model", "load_state_dict_numpy", "pretrained"])
def test_torch_layout_checkpoint_loads_without_its_table(tmp_path, loader):
    """A torch-layout .pth that carries the sinusoid table (a non-persistent buffer, recomputed here) loads through
    serve.build_model (coldstart.materialize), load_state_dict_numpy and the info sharing's pretrained path, and
    the table keeps its computed value."""
    _, tmod = _models("alternating")
    state = {k: v.numpy() for k, v in tmod.state_dict().items()}
    state["info_sharing.view_pos_table"] = np.zeros((1, 48), np.float32)
    if loader == "pretrained":
        state = {k[len("info_sharing."):]: v for k, v in state.items() if k.startswith("info_sharing.")}
    path = str(tmp_path / "mv.pth")
    torch.save({"model": state}, path)
    if loader == "build_model":
        loaded = serve.build_model((32, 48), 2, 64, 4, 2, 48, 4, device="cpu", dtype=torch.float32, checkpoint=path,
                                   model="multiview", num_views=3)
    elif loader == "load_state_dict_numpy":
        loaded = MultiViewPointmapModel(**_model_kw("alternating"))
        assert load_state_dict_numpy(loaded, state) == ([], [])
    else:
        kw = dict(name="a", input_embed_dim=64, dim=48, depth=2, num_heads=4, pretrained_checkpoint_path=path)
        loaded, tmod = alt.MultiViewAlternatingAttentionTransformer(**kw), tmod.info_sharing
    assert all(torch.equal(v, tmod.state_dict()[k]) for k, v in loaded.state_dict().items())
    table = loaded.view_pos_table if loader == "pretrained" else loaded.info_sharing.view_pos_table
    assert table.abs().sum() > 0
    assert torch.equal(table, tmod.view_pos_table if loader == "pretrained" else tmod.info_sharing.view_pos_table)
