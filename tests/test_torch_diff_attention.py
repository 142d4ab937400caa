"""
The port's differential attention family against the JAX package on the CPU, in fp32: ``lambda_init_fn``,
DiffAttention and DiffCrossAttention, DiffSelfAttentionBlock and DiffCrossAttentionBlock, and the differential
multi-view cross-attention transformer and its IFR, with and without RoPE; both registry entries build. Weights are
drawn from numpy into the JAX modules and carried across by ``state_dict_from_module`` -> ``load_state_dict_numpy``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models import info_sharing as jinfo
from uniception_tpu.models.info_sharing import diff_cross_attention_transformer as jdiff
from uniception_tpu.models.info_sharing.base import MultiViewTransformerInput as JaxViewInput
from uniception_tpu.models.utils.positional_encoding import make_patch_positions as jax_positions
from uniception_tpu.nn import blocks as jblocks
from uniception_tpu.ops.rope import Rope2D as JaxRope2D
from uniception_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch.models import info_sharing
from uniception_tpu_torch.models.info_sharing import diff_cross_attention_transformer as tdiff
from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.nn import blocks
from uniception_tpu_torch.ops.rope import Rope2D
from tests.test_torch_heads import _close, _jax_forward, carry, seeded_jax

DIM, HEADS, H, W = 48, 2, 3, 4  # two differential heads: sub-heads of 48 / 2 / 2 = 12 channels, v of 24


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    "Two intra-op threads: small CPU modules in several test workers (see tests/test_torch_training_paths.py)."
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rope(rope):
    return (JaxRope2D(100.0), Rope2D(100.0)) if rope else (None, None)


def test_lambda_init_fn_matches_jax():
    for depth in range(40):
        assert blocks.lambda_init_fn(depth) == jblocks.lambda_init_fn(depth)


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_diff_attention_matches_jax(kind, rope):
    jpe, tpe = _rope(rope)
    kw = dict(dim=DIM, depth=3, num_heads=HEADS, qkv_bias=True)
    jcls, tcls = (jblocks.DiffAttention, blocks.DiffAttention) if kind == "self" else (
        jblocks.DiffCrossAttention, blocks.DiffCrossAttention)
    jmod = seeded_jax(lambda: jcls(custom_positional_encoding=jpe, rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tcls(custom_positional_encoding=tpe, **kw))
    assert tmod.head_dim == 12 and tmod.lambda_q1.dtype == torch.float32
    rng = np.random.RandomState(1)
    x, y = rng.randn(2, H * W, DIM).astype(np.float32), rng.randn(2, 2 * H * W, DIM).astype(np.float32)
    tpos, jpos = make_patch_positions(2, H, W), jax_positions(2, H, W)
    tpos_y, jpos_y = make_patch_positions(2, 2 * H, W), jax_positions(2, 2 * H, W)
    with torch.no_grad():
        if kind == "self":
            out = tmod(torch.from_numpy(x), tpos)
            ref = _jax_forward(jmod, jnp.asarray(x), jpos)
        else:
            ty = torch.from_numpy(y)
            out = tmod(torch.from_numpy(x), ty, ty, tpos, tpos_y)
            ref = _jax_forward(jmod, jnp.asarray(x), jnp.asarray(y), jnp.asarray(y), jpos, jpos_y)
    _close(out, ref)


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_diff_blocks_match_jax(kind, rope):
    jpe, tpe = _rope(rope)
    kw = dict(dim=DIM, depth=5, num_heads=HEADS, qkv_bias=True, qk_norm=True, init_values=0.5)
    if kind == "self":
        jmod = seeded_jax(lambda: jblocks.DiffSelfAttentionBlock(custom_positional_encoding=jpe, rngs=nnx.Rngs(0),
                                                                 **kw))
        tmod = carry(jmod, blocks.DiffSelfAttentionBlock(custom_positional_encoding=tpe, **kw))
        assert isinstance(tmod.attn, blocks.DiffAttention)
    else:
        kw["norm_cross_tokens"] = False
        jmod = seeded_jax(lambda: jblocks.DiffCrossAttentionBlock(custom_positional_encoding=jpe, rngs=nnx.Rngs(0),
                                                                  **kw))
        tmod = carry(jmod, blocks.DiffCrossAttentionBlock(custom_positional_encoding=tpe, **kw))
        assert isinstance(tmod.cross_attn, blocks.DiffCrossAttention) and isinstance(tmod.attn, blocks.Attention)
    rng = np.random.RandomState(2)
    x, y = rng.randn(2, H * W, DIM).astype(np.float32), rng.randn(2, H * W, DIM).astype(np.float32)
    tpos, jpos = make_patch_positions(2, H, W), jax_positions(2, H, W)
    with torch.no_grad():
        if kind == "self":
            out, ref = tmod(torch.from_numpy(x), tpos), _jax_forward(jmod, jnp.asarray(x), jpos)
        else:
            out = tmod(torch.from_numpy(x), torch.from_numpy(y), tpos, tpos)
            ref = _jax_forward(jmod, jnp.asarray(x), jnp.asarray(y), jpos, jpos)
    _close(out, ref)


def _view_inputs(rng, views):
    feats = [rng.randn(2, 32, H, W).astype(np.float32) for _ in range(views)]
    return (MultiViewTransformerInput(features=[torch.from_numpy(f) for f in feats]),
            JaxViewInput(features=[jnp.asarray(f) for f in feats]))


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("views", [2, 3])
def test_diff_transformer_matches_jax(views, rope):
    jpe, tpe = _rope(rope)
    kw = dict(name="diff", input_embed_dim=32, num_views=views, depth=2, dim=DIM, num_heads=4)
    jmod = seeded_jax(lambda: jdiff.DifferentialMultiViewCrossAttentionTransformer(
        custom_positional_encoding=jpe, rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tdiff.DifferentialMultiViewCrossAttentionTransformer(custom_positional_encoding=tpe, **kw))
    blk = tmod.multi_view_branches[0][1]
    assert blk.attn.num_heads == 2 and blk.cross_attn.num_heads == 2 and blk.cross_attn.head_dim == 12
    assert blk.cross_attn.lambda_init == blocks.lambda_init_fn(1)
    t_in, j_in = _view_inputs(np.random.RandomState(3), views)
    with torch.no_grad():
        out = tmod(t_in)
    ref = _jax_forward(jmod, j_in)
    assert len(out.features) == views
    for got, want in zip(out.features, ref.features):
        _close(got, want)


@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
def test_diff_transformer_ifr_matches_jax(rope):
    jpe, tpe = _rope(rope)
    kw = dict(name="diff", input_embed_dim=32, num_views=2, depth=3, dim=DIM, num_heads=4, indices=[0, 1],
              norm_intermediate=False)
    jmod = seeded_jax(lambda: jdiff.DifferentialMultiViewCrossAttentionTransformerIFR(
        custom_positional_encoding=jpe, rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tdiff.DifferentialMultiViewCrossAttentionTransformerIFR(custom_positional_encoding=tpe, **kw))
    t_in, j_in = _view_inputs(np.random.RandomState(4), 2)
    with torch.no_grad():
        out, inter = tmod(t_in)
    ref, jinter = _jax_forward(jmod, j_in)
    assert len(inter) == len(jinter) == 2
    for got, want in zip([*out.features, *(f for o in inter for f in o.features)],
                         [*ref.features, *(f for o in jinter for f in o.features)]):
        _close(got, want)


def test_diff_registry_entries_build_as_in_jax():
    cls, ifr = info_sharing.INFO_SHARING_CLASSES["diff_cross_attention"]
    jcls, jifr = jinfo.INFO_SHARING_CLASSES["diff_cross_attention"]
    assert (cls.__name__, ifr.__name__) == (jcls.__name__, jifr.__name__) and issubclass(ifr, cls)
    kw = dict(name="d", input_embed_dim=32, num_views=2, depth=2, dim=DIM, num_heads=4)
    assert sorted(cls(**kw).state_dict()) == sorted(ifr(indices=[0], **kw).state_dict())
    with pytest.raises(ValueError, match="divisible by 2"):
        cls(**{**kw, "num_heads": 3})


def test_diff_transformer_loads_a_jax_checkpoint_strictly(tmp_path):
    kw = dict(name="d", input_embed_dim=32, num_views=2, depth=2, dim=DIM, num_heads=4)
    arrays = state_dict_from_module(seeded_jax(lambda: jdiff.DifferentialMultiViewCrossAttentionTransformer(
        rngs=nnx.Rngs(0), **kw), seed=5))
    path = str(tmp_path / "diff.npz")
    jax_save_checkpoint(path, arrays)
    own = tdiff.DifferentialMultiViewCrossAttentionTransformer(pretrained_checkpoint_path=path, **kw).state_dict()
    assert sorted(own) == sorted(arrays)
    assert all(np.array_equal(own[k].numpy(), arrays[k]) for k in arrays)
