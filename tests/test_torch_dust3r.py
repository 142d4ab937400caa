"""
The port's two-view DUSt3R path against the JAX package on the CPU, module by
module and as a whole: the CroCo encoder (both patch embeds, a portrait
ManyAR row), the cross-attention info-sharing transformer, the linear head
with the pointmap+confidence adaptor, ``DUSt3R.forward_pair`` and the uint8
serving function. Weights go from the JAX modules to the port through their
torch-layout state dicts; inputs come from numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.encoders.base import ViTEncoderInput as JaxViTEncoderInput
from uniception_tpu.models.encoders.croco import CroCoEncoder as JaxCroCoEncoder
from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.info_sharing.base import MultiViewTransformerInput as JaxMultiViewTransformerInput
from uniception_tpu.models.info_sharing.cross_attention_transformer import (
    MultiViewCrossAttentionTransformer as JaxMultiViewCrossAttentionTransformer,
)
from uniception_tpu.models.prediction_heads.adaptors import PointMapWithConfidenceAdaptor as JaxPointMapAdaptor
from uniception_tpu.models.prediction_heads.base import AdaptorInput as JaxAdaptorInput
from uniception_tpu.models.prediction_heads.base import PredictionHeadInput as JaxPredictionHeadInput
from uniception_tpu.models.prediction_heads.linear import LinearFeature as JaxLinearFeature
from uniception_tpu.ops.rope import Rope2D as JaxRope2D
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch import serve
from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
from uniception_tpu_torch.models.encoders.croco import CroCoEncoder
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
from uniception_tpu_torch.models.info_sharing.cross_attention_transformer import MultiViewCrossAttentionTransformer
from uniception_tpu_torch.models.prediction_heads.adaptors import PointMapWithConfidenceAdaptor
from uniception_tpu_torch.models.prediction_heads.base import AdaptorInput, PredictionHeadInput
from uniception_tpu_torch.models.prediction_heads.linear import LinearFeature
from uniception_tpu_torch.ops.rope import Rope2D
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

TOL = 5e-5  # fp32 max abs per component, the repo's parity bar
ENC = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4)
DEC = dict(info_sharing_dim=48, info_sharing_depth=2, info_sharing_num_heads=4)
INF = float("inf")
ADAPTOR = dict(
    name="pointmap", pointmap_mode="exp", pointmap_vmin=-INF, pointmap_vmax=INF,
    confidence_type="exp", confidence_vmin=1, confidence_vmax=INF,
)


def _copy_weights(jmod, tmod):
    load_state_dict_numpy(tmod, state_dict_from_module(jmod))
    return tmod.eval()


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= tol


def _composed_tol(ref):
    "exp adaptors scale errors with the output: 1e-4 * max(1, max|ref|) for composed models."
    return 1e-4 * max(1.0, float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("patch_embed_cls", ["PatchEmbedDust3R", "ManyAR_PatchEmbed"])
def test_encoder_matches_jax(patch_embed_cls):
    kw = dict(name="croco", data_norm_type="dust3r", patch_embed_cls=patch_embed_cls, img_size=(32, 48), **ENC)
    jmod = JaxCroCoEncoder(rngs=nnx.Rngs(0), **kw)
    tmod = _copy_weights(jmod, CroCoEncoder(**kw))
    img = np.random.RandomState(0).randn(2, 3, 32, 48).astype(np.float32)
    # ManyAR: the second sample is portrait (true 48x32), carried in landscape frame
    true_shape = np.array([[32, 48], [48, 32]], np.int32) if patch_embed_cls == "ManyAR_PatchEmbed" else None
    ref = jmod(JaxViTEncoderInput(
        image=jnp.asarray(img), data_norm_type="dust3r",
        true_shape=None if true_shape is None else jnp.asarray(true_shape),
    )).features
    with torch.no_grad():
        out = tmod(ViTEncoderInput(
            image=torch.from_numpy(img), data_norm_type="dust3r",
            true_shape=None if true_shape is None else torch.from_numpy(true_shape),
        )).features
    _close(out, ref)


def test_encoder_rejects_wrong_data_norm():
    enc = CroCoEncoder(name="croco", data_norm_type="dust3r", img_size=(32, 32), **ENC)
    with pytest.raises(ValueError):
        enc(ViTEncoderInput(image=torch.zeros(1, 3, 32, 32), data_norm_type="croco"))


def test_info_sharing_matches_jax():
    kw = dict(name="info", input_embed_dim=64, num_views=2, dim=48, depth=2, num_heads=4)
    jmod = JaxMultiViewCrossAttentionTransformer(custom_positional_encoding=JaxRope2D(100.0), rngs=nnx.Rngs(0), **kw)
    tmod = _copy_weights(jmod, MultiViewCrossAttentionTransformer(custom_positional_encoding=Rope2D(100.0), **kw))
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, 64, 2, 3).astype(np.float32) for _ in range(2)]
    ref = jmod(JaxMultiViewTransformerInput(features=[jnp.asarray(f) for f in feats])).features
    with torch.no_grad():
        out = tmod(MultiViewTransformerInput(features=[torch.from_numpy(f) for f in feats])).features
    for o, r in zip(out, ref):
        _close(o, r)


def test_linear_head_and_adaptor_match_jax():
    jhead = JaxLinearFeature(input_feature_dim=48, output_dim=4, patch_size=16, rngs=nnx.Rngs(0))
    thead = _copy_weights(jhead, LinearFeature(input_feature_dim=48, output_dim=4, patch_size=16))
    feat = np.random.RandomState(2).randn(2, 48, 2, 3).astype(np.float32)
    jdec = jhead(JaxPredictionHeadInput(last_feature=jnp.asarray(feat))).decoded_channels
    with torch.no_grad():
        tdec = thead(PredictionHeadInput(last_feature=torch.from_numpy(feat))).decoded_channels
    _close(tdec, jdec)
    ref = JaxPointMapAdaptor(**ADAPTOR)(JaxAdaptorInput(adaptor_feature=jdec, output_shape_hw=(32, 48)))
    out = PointMapWithConfidenceAdaptor(**ADAPTOR)(AdaptorInput(adaptor_feature=tdec, output_shape_hw=(32, 48)))
    _close(out.value, ref.value, _composed_tol(ref.value))
    _close(out.confidence, ref.confidence, _composed_tol(ref.confidence))
    assert out.confidence.min().item() >= 1.0


def test_forward_pair_matches_jax():
    jmod = JaxDUSt3R(name="dust3r_small", img_size=(32, 48), rngs=nnx.Rngs(0), **ENC, **DEC)
    tmod = _copy_weights(jmod, DUSt3R(name="dust3r_small", img_size=(32, 48), **ENC, **DEC))
    rng = np.random.RandomState(3)
    img1, img2 = (rng.randn(2, 3, 32, 48).astype(np.float32) for _ in range(2))
    ref1, ref2 = jmod.forward_pair(jnp.asarray(img1), jnp.asarray(img2))
    with torch.no_grad():
        out1, out2 = tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2))
    for out, ref in ((out1, ref1), (out2, ref2)):
        assert sorted(out) == sorted(ref)
        for key in ref:
            _close(out[key], ref[key], _composed_tol(ref[key]))


def test_serving_fn_matches_jax_serving_math():
    "uint8 in: the port's serving fn against the JAX serving_fn math of examples/serve_dust3r.py."
    dims = dict(enc_depth=2, enc_dim=64, enc_heads=4, dec_depth=2, dec_dim=48, dec_heads=4)
    jmod = JaxDUSt3R(
        name="dust3r_serve", img_size=(32, 32), patch_embed_cls="ManyAR_PatchEmbed", rngs=nnx.Rngs(0),
        enc_embed_dim=64, enc_depth=2, enc_num_heads=4, **DEC,
    )
    tmod = _copy_weights(jmod, serve.build_model(32, **dims, device="cpu", dtype=torch.float32))
    frames = np.random.RandomState(4).randint(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
    u8_1, u8_2 = frames[0::2], frames[1::2]

    def jax_prep(u8):  # serve_dust3r.py:542-546 with the dust3r norm
        return (jnp.transpose(jnp.asarray(u8), (0, 3, 1, 2)).astype(jnp.float32) / 255.0 - 0.5) / 0.5

    ts = jnp.broadcast_to(jnp.asarray([32, 32], jnp.int32), (2, 2))
    r1, r2 = jmod.forward_pair(jax_prep(u8_1), jax_prep(u8_2), true_shape1=ts, true_shape2=ts)
    refs = (r1["pts3d"], r1["conf"], r2["pts3d_in_other_view"], r2["conf"])
    outs = serve.make_serving_fn(tmod, "cpu")(u8_1, u8_2)
    assert [tuple(o.shape) for o in outs] == [(2, 32, 32, 3), (2, 32, 32, 1)] * 2
    for out, ref in zip(outs, refs):
        _close(out, ref, _composed_tol(ref))


def test_serve_main_on_cpu(capsys):
    out = serve.main([
        "--device", "cpu", "--img-size", "32", "--pairs", "4", "--batch", "2",
        "--enc-depth", "1", "--enc-dim", "64", "--enc-heads", "4", "--dec-depth", "1", "--dec-dim", "48", "--dec-heads", "4",
    ])
    assert tuple(out[0].shape) == (2, 32, 32, 3) and tuple(out[3].shape) == (2, 32, 32, 1)
    assert "pairs/s on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [{"scan_blocks": True}], ids=["scan"])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        DUSt3R(name="x", img_size=(32, 32), **ENC, **DEC, **kw)
