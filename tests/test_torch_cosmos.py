"""
The port's Cosmos image tokenizer against the JAX package on the CPU, in fp32: haar and rearrange (un)patching, the
distributions (the Gaussian's draw injected from JAX), every quantizer (FSQ and residual FSQ with exact indices,
VQ, LFQ), the 2D Encoder and Decoder at a small config (spatial compression 8 and 16, haar and rearrange), the CI
and DI networks, CosmosEncoder through encoder_factory, CosmosSingleChannel and CosmosFeature with their adaptors,
ImageTokenizer at the full CI config at 64 x 64 (as tests/models/test_tokenizer_libs.py runs it), the array helpers,
strict checkpoint loading, the PNG codec and the image CLI in a subprocess (the video path is
tests/test_torch_cosmos_video.py's). Each JAX
module is built from seeded numpy weights and carried across by ``state_dict_from_module`` ->
``load_state_dict_numpy`` (strict); inputs come from numpy. The heads and the encoder run at the CI config
narrowed in both packages' tables (channels 32, multipliers [2, 4]); the tokenizer at its published widths.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.encoders import _make_encoder_test as jax_make_encoder_test
from uniception_tpu.models.encoders.base import ViTEncoderInput as JaxViTEncoderInput
from uniception_tpu.models.libs.cosmos_tokenizer import utils as jutils
from uniception_tpu.models.libs.cosmos_tokenizer.modules import distributions as jdist
from uniception_tpu.models.libs.cosmos_tokenizer.modules import layers2d as jlayers
from uniception_tpu.models.libs.cosmos_tokenizer.modules import patching as jpatching
from uniception_tpu.models.libs.cosmos_tokenizer.modules import quantizers as jquant
from uniception_tpu.models.libs.cosmos_tokenizer import networks as jnetworks
from uniception_tpu.models.prediction_heads import base as jbase
from uniception_tpu.models.prediction_heads import cosmos as jcosmos_head
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch.models import encoders
from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
from uniception_tpu_torch.models.libs.cosmos_tokenizer import image_lib, networks, utils
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import distributions as tdist
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import layers2d as tlayers
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import patching as tpatching
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import quantizers as tquant
from uniception_tpu_torch.models.prediction_heads import base as tbase
from uniception_tpu_torch.models.prediction_heads import cosmos as tcosmos_head
from uniception_tpu_torch.utils.png import read_png, write_png
from uniception_tpu_torch.utils.weights import load_state_dict_numpy
from tests.test_torch_heads import carry, seeded_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 5e-5  # fp32 max abs, times max(1, max |JAX|): the repo's parity bar

# the JAX modules' forward, compiled: one compile costs less than an eager call's op-by-op compiles on the CPU
_jax_forward = nnx.jit(lambda m, *args: m(*args))
_jax_decode = nnx.jit(lambda m, z: m.decode(z))
_jax_encode = nnx.jit(lambda m, x: m.encode(x))

# tests/models/test_cosmos.py's small config: attention at the 16 x 16 level, GroupNorm's 32 groups on 32 channels
SMALL_CFG = dict(attn_resolutions=[16], channels=32, channels_mult=[2, 4], dropout=0.0, in_channels=3,
                 spatial_compression=8, num_res_blocks=1, out_channels=3, resolution=64, patch_size=4,
                 patch_method="haar")


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


@pytest.fixture
def narrow_ci(monkeypatch):
    "The CI config at channels 32 and multipliers [2, 4] in both packages' tables (the heads and the encoder read it)."
    for table in (jnetworks.TokenizerConfigs.CI.value, networks.TokenizerConfigs.CI.value):
        monkeypatch.setitem(table, "channels", 32)
        monkeypatch.setitem(table, "channels_mult", [2, 4])


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


def _seeded(jctor, seed=0, levels=None):
    """``seeded_jax``, with the FSQ levels given back to the JAX quantizers: FSQuantizer keeps them as numpy
    attributes, which the abstract construction turns into shapes."""
    jmod = seeded_jax(jctor, seed)
    for _, mod in nnx.iter_modules(jmod):
        if isinstance(mod, jquant.FSQuantizer):
            fresh = jquant.FSQuantizer(levels=levels)
            mod._levels, mod._basis = fresh._levels, fresh._basis
    return jmod


def _pair(jctor, tmod, seed=0, levels=None):
    "The JAX module from seeded numpy weights and the port's module carrying them (strict), in eval mode."
    jmod = _seeded(jctor, seed, levels)
    return jmod, carry(jmod, tmod)


def _randn(seed, *shape, scale=1.0):
    a = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return a, torch.from_numpy(a), jnp.asarray(a)


# --- patching ------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["haar", "rearrange"])
@pytest.mark.parametrize("patch_size", [2, 4])
def test_patching_matches_jax_and_round_trips(method, patch_size):
    "The sub-band order of the haar levels ([LL, LH, HL, HH]) decides which conv_in weights see which band."
    a, t, j = _randn(0, 2, 3, 16, 16)
    patched = tpatching.Patcher(patch_size, method)(t)
    want = jpatching.Patcher(patch_size, method)(j)
    assert patched.shape == (2, 3 * patch_size**2, 16 // patch_size, 16 // patch_size)
    _close(patched, want)
    back = tpatching.UnPatcher(patch_size, method)(patched)
    _close(back, jpatching.UnPatcher(patch_size, method)(want))
    _close(back, a)


def test_patching_rejects_an_unknown_method():
    for cls in (tpatching.Patcher, tpatching.UnPatcher):
        with pytest.raises(ValueError, match="Unknown patch method"):
            cls(2, "wavelet")(torch.zeros(1, 12, 4, 4))


# --- distributions -------------------------------------------------------------------------------------------------


def test_identity_distribution_passes_the_latent():
    _, t, j = _randn(1, 2, 4, 3, 3)
    latent, (a, b) = tdist.IdentityDistribution()(t)
    assert latent is t and a.shape == b.shape == (1,) and not a.any() and not b.any()


@pytest.mark.parametrize("sampled", [False, True])
def test_gaussian_distribution_matches_jax(sampled, monkeypatch):
    "Without a generator the mean (inference); with one, mean + exp(logvar / 2) * the draw, JAX's draw injected."
    _, t, j = _randn(2, 2, 8, 3, 3, scale=30.0)  # logvar past both clamps
    key = jax.random.key(3) if sampled else None
    jsample, (jmean, jlogvar) = jdist.GaussianDistribution()(j, key)
    if sampled:
        drawn = np.array(jax.random.normal(key, (2, 4, 3, 3), jnp.float32))
        monkeypatch.setattr(tdist.GaussianDistribution, "standard_normal", lambda self, like, g: torch.from_numpy(drawn))
    sample, (mean, logvar) = tdist.GaussianDistribution()(t, torch.Generator().manual_seed(0) if sampled else None)
    _close(mean, jmean)
    _close(logvar, jlogvar)
    assert logvar.min() == -30.0 and logvar.max() == 20.0
    _close(sample, jsample)


# --- quantizers ----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("levels,shape", [([8, 8, 8, 5, 5, 5], (2, 6, 4, 5)), ([8, 5, 5, 5], (3, 7, 4)),
                                          ([7, 5, 3], (1, 3, 6, 6))], ids=["published", "tokens", "odd-levels"])
def test_fsq_indices_and_codes_match_jax(levels, shape):
    "Indices equal exactly, codes equal where the indices do (all here), and indices -> codes round trip."
    _, t, j = _randn(4, *shape, scale=2.0)
    idx, codes, loss = tquant.FSQuantizer(levels=levels)(t)
    jidx, jcodes, jloss = jquant.FSQuantizer(levels=levels)(j)
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(codes, jcodes)
    assert loss.shape == tuple(jloss.shape) and not loss.any()
    q = tquant.FSQuantizer(levels=levels)
    assert q.codebook_size == int(np.prod(levels))
    if len(shape) == 4:
        back = q.indices_to_codes(idx)
        _close(back, jquant.FSQuantizer(levels=levels).indices_to_codes(jidx))
        _close(back, codes)


def test_residual_fsq_matches_jax():
    _, t, j = _randn(5, 2, 6, 4, 4, scale=2.0)
    q, jq = tquant.ResidualFSQuantizer(levels=[8, 8, 8, 5, 5, 5], num_quantizers=4), \
        jquant.ResidualFSQuantizer(levels=[8, 8, 8, 5, 5, 5], num_quantizers=4)
    idx, codes, loss = q(t)
    jidx, jcodes, jloss = jq(j)
    assert idx.shape == (2, 4, 4, 4) and np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(codes, jcodes)
    _close(loss, jloss)
    _close(q.indices_to_codes(idx), jq.indices_to_codes(jidx))
    assert not q.state_dict()


@pytest.mark.parametrize("legacy", [True, False])
def test_vector_quantizer_matches_jax(legacy):
    jq, q = _pair(lambda: jquant.VectorQuantizer(32, 6, legacy=legacy, rngs=nnx.Rngs(0)),
                  tquant.VectorQuantizer(32, 6, legacy=legacy))
    assert list(q.state_dict()) == ["embedding"]
    _, t, j = _randn(6, 2, 6, 3, 4, scale=0.3)
    z_q, loss, (_, _, idx) = q(t)
    jz_q, jloss, (_, _, jidx) = jq(j)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(z_q, jz_q)
    _close(loss, jloss)
    _close(q.get_codebook_entry(idx, (2, 3, 4, 6)), jq.get_codebook_entry(jidx, (2, 3, 4, 6)))


def test_lookup_free_quantizer_matches_jax():
    _, t, j = _randn(7, 2, 5, 3, 3)
    idx, z_q, loss = tquant.LFQuantizer(codebook_size=32, codebook_dim=5)(t)
    jidx, jz_q, jloss = jquant.LFQuantizer(codebook_size=32, codebook_dim=5)(j)
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(z_q, jz_q)
    _close(loss, jloss)
    with pytest.raises(AssertionError, match="2\\*\\*codebook_dim"):
        tquant.LFQuantizer(codebook_size=30, codebook_dim=5)


# --- the 2D encoder and decoder ------------------------------------------------------------------------------------


@pytest.mark.parametrize("compression,method", [(8, "haar"), (16, "haar"), (8, "rearrange")])
def test_encoder_and_decoder_match_jax(compression, method):
    """SMALL_CFG at spatial compression 8 (one downsample) and 16 (two), haar and rearrange: the level-0 attention
    blocks (16 x 16 grid), the mid blocks and the pyramid's state-dict keys carried strictly both ways."""
    cfg = dict(SMALL_CFG, spatial_compression=compression, patch_method=method)
    jenc, enc = _pair(lambda: jlayers.Encoder(z_channels=8, rngs=nnx.Rngs(0), **cfg), tlayers.Encoder(z_channels=8, **cfg))
    assert len(enc.down[0].attn) == 1 and any(k.startswith("mid.attn_1.q.") for k in enc.state_dict())
    _, x, jx = _randn(8, 1, 3, 64, 64)
    lat = 64 // compression
    out = enc(x)
    assert out.shape == (1, 8, lat, lat)
    _close(out, _jax_forward(jenc, jx))

    jdec, dec = _pair(lambda: jlayers.Decoder(z_channels=8, rngs=nnx.Rngs(0), **cfg), tlayers.Decoder(z_channels=8, **cfg),
                      seed=1)
    _, z, jz = _randn(9, 1, 8, lat, lat)
    img = dec(z)
    assert img.shape == (1, 3, 64, 64)
    _close(img, _jax_forward(jdec, jz))


# --- the CI and DI networks ----------------------------------------------------------------------------------------


@pytest.mark.parametrize("formulation", ["AE", "VAE"])
def test_continuous_image_network_matches_jax(formulation, monkeypatch):
    cfg = dict(SMALL_CFG, latent_channels=8, z_channels=8, z_factor=2 if formulation == "VAE" else 1,
               formulation=formulation)
    jnet, net = _pair(lambda: jnetworks.TokenizerModels.CI.value(rngs=nnx.Rngs(0), **cfg),
                      networks.TokenizerModels.CI.value(**cfg))
    _, x, jx = _randn(10, 2, 3, 64, 64)
    key = jax.random.key(4) if formulation == "VAE" else None
    want = _jax_forward(jnet, jx, key)
    gen = None
    if key is not None:  # the port's draw is JAX's
        mean = np.asarray(want.posteriors[0])
        drawn = np.array(jax.random.normal(key, mean.shape, jnp.float32))
        monkeypatch.setattr(tdist.GaussianDistribution, "standard_normal", lambda self, like, g: torch.from_numpy(drawn))
        gen = torch.Generator().manual_seed(0)
    out = net(x, generator=gen)
    _close(out.latent, want.latent)
    _close(out.reconstructions, want.reconstructions)
    for got, ref in zip(out.posteriors, want.posteriors):
        _close(got, ref)
    if formulation == "AE":  # the decoder alone (the VAE's is the same module)
        _close(net.decode(out.latent), _jax_decode(jnet, want.latent))


@pytest.mark.parametrize("quantizer", ["FSQ", "RESFSQ", "LFQ"])
def test_discrete_image_network_matches_jax(quantizer):
    extra = dict(levels=[8, 8, 8, 5, 5, 5], num_quantizers=2) if quantizer != "LFQ" else \
        dict(codebook_size=64, codebook_dim=6)
    cfg = dict(SMALL_CFG, z_channels=16, embedding_dim=6, quantizer=quantizer, **extra)
    jnet, net = _pair(lambda: jnetworks.TokenizerModels.DI.value(rngs=nnx.Rngs(0), **cfg),
                      networks.TokenizerModels.DI.value(**cfg), levels=extra.get("levels"))
    _, x, jx = _randn(11, 2, 3, 64, 64)
    out, want = net(x), _jax_forward(jnet, jx)
    assert out.quant_info.dtype == torch.int32 and np.array_equal(out.quant_info.numpy(), np.asarray(want.quant_info))
    _close(out.reconstructions, want.reconstructions)
    _close(out.quant_loss, want.quant_loss)
    if quantizer != "LFQ":  # LFQ has no indices -> codes in either package
        _close(net.decode(out.quant_info), _jax_decode(jnet, want.quant_info))


def test_configs_are_the_jax_packages():
    for name in ("CI", "DI", "CV", "DV"):
        assert networks.TokenizerConfigs[name].value == jnetworks.TokenizerConfigs[name].value, name


# --- the encoder and the heads -------------------------------------------------------------------------------------


def test_cosmos_encoder_through_the_factory_matches_jax(narrow_ci):
    jenc = seeded_jax(lambda: jax_make_encoder_test("cosmos_ci8x8", rngs=nnx.Rngs(0)))
    enc = encoders.encoder_factory("cosmos", name="cosmos_ci8x8", patch_size=8, device="cpu")
    load_state_dict_numpy(enc, state_dict_from_module(jenc))
    _, x, jx = _randn(12, 2, 3, 64, 32)
    out = enc.eval()(ViTEncoderInput(image=x, data_norm_type="cosmos"))
    assert out.features.shape == (2, 16, 8, 4)
    _close(out.features, _jax_forward(jenc, JaxViTEncoderInput(image=jx, data_norm_type="cosmos")).features)
    with pytest.raises(ValueError, match="normalization type dinov2"):
        enc(ViTEncoderInput(image=x, data_norm_type="dinov2"))


@pytest.mark.parametrize("patch", [8, 16])
def test_cosmos_single_channel_matches_jax(patch, narrow_ci):
    jhead, head = _pair(lambda: jcosmos_head.CosmosSingleChannel(patch, rngs=nnx.Rngs(0)),
                        tcosmos_head.CosmosSingleChannel(patch))
    _, z, jz = _randn(13, 1, 16, 4, 3)
    out = head(z)
    assert out.shape == (1, 3, 4 * patch, 3 * patch)
    _close(out, _jax_forward(jhead, jz))


@pytest.mark.parametrize("adaptor,skip_linear", [("FlowWithConfidenceAdaptor", False), ("MaskAdaptor", True)])
def test_cosmos_feature_and_its_adaptors_match_jax(adaptor, skip_linear, narrow_ci):
    """CosmosFeature over a feature map (one decoder per output channel, mean over RGB, learned scale and bias) into
    the adaptor its CLASSNAME_TO_ADAPTOR_CLASS names: flow with confidence (3 channels) or a mask (1)."""
    out_dim = 3 if adaptor == "FlowWithConfidenceAdaptor" else 1
    in_dim = 16 * out_dim if skip_linear else 24
    kw = dict(input_feature_dim=in_dim, output_dim=out_dim, patch_size=8, skip_linear=skip_linear)
    jhead, head = _pair(lambda: jcosmos_head.CosmosFeature(rngs=nnx.Rngs(0), **kw), tcosmos_head.CosmosFeature(**kw))
    assert {"output_scaling", "output_bias"} <= set(head.state_dict()) and ("linear.weight" in head.state_dict()) != skip_linear
    _, f, jf = _randn(14, 2, in_dim, 3, 4)
    out, split = head(tbase.PredictionHeadInput(last_feature=f))
    jout, jsplit = _jax_forward(jhead, jbase.PredictionHeadInput(last_feature=jf))
    assert out.decoded_channels.shape == (2, out_dim, 24, 32) and len(split) == out_dim
    _close(out.decoded_channels, jout.decoded_channels)
    for got, ref in zip(split, jsplit):
        _close(got, ref)
    assert set(tcosmos_head.CLASSNAME_TO_ADAPTOR_CLASS) == set(jcosmos_head.CLASSNAME_TO_ADAPTOR_CLASS)
    args = ("flow", (1.0, -2.0), (3.0, 0.5), (12, 16), "scale_both", False, "exp", 1.0, float("inf")) \
        if out_dim == 3 else ("mask",)
    tadapt = tcosmos_head.CLASSNAME_TO_ADAPTOR_CLASS[adaptor](*args)
    jadapt = jcosmos_head.CLASSNAME_TO_ADAPTOR_CLASS[adaptor](*args)
    got = tadapt(tbase.AdaptorInput(adaptor_feature=out.decoded_channels, output_shape_hw=(24, 32)))
    want = jadapt(jbase.AdaptorInput(adaptor_feature=jout.decoded_channels, output_shape_hw=(24, 32)))
    for name in ("value", "confidence", "logits", "mask"):
        if getattr(want, name, None) is not None:
            _close(getattr(got, name), getattr(want, name))


# --- ImageTokenizer, checkpoints, helpers --------------------------------------------------------------------------


def _jax_tokenizer_model(kind, compression):
    """The network the JAX ImageTokenizer(kind, compression) builds, with seeded numpy weights (its own init compiles
    the full-width initializers); the tests call its encode / decode / forward compiled, as the tokenizer does."""
    cfg = dict(jnetworks.TokenizerConfigs[kind].value, spatial_compression=compression)
    cfg.pop("name")
    return _seeded(lambda: jnetworks.TokenizerModels[kind].value(rngs=nnx.Rngs(0), **cfg), levels=cfg.get("levels"))


def test_image_tokenizer_at_the_full_ci_config_matches_jax():
    "The published CI widths at 8x8 compression on a 64 x 64 image: encode, decode and autoencode."
    jmodel = _jax_tokenizer_model("CI", 8)
    tok = image_lib.ImageTokenizer("CI", 8, device="cpu")
    load_state_dict_numpy(tok.model, state_dict_from_module(jmodel))
    x = np.random.RandomState(0).randn(1, 3, 64, 64).astype(np.float32).clip(-1, 1)
    latent = tok.encode(x)
    assert latent.shape == (1, 16, 8, 8)
    jlatent = _jax_encode(jmodel, jnp.asarray(x))[0]
    _close(latent, jlatent)
    _close(tok.decode(latent), _jax_decode(jmodel, jlatent))
    recon = tok.autoencode(x)
    assert isinstance(recon, np.ndarray) and recon.shape == (1, 3, 64, 64)
    _close(recon, _jax_decode(jmodel, jlatent))  # the JAX autoencode: decode(encode(x)) of the AE formulation


def test_image_tokenizer_di_matches_jax(narrow_ci, monkeypatch):
    for table in (jnetworks.TokenizerConfigs.DI.value, networks.TokenizerConfigs.DI.value):
        monkeypatch.setitem(table, "channels", 32)
        monkeypatch.setitem(table, "channels_mult", [2, 4])
    jmodel = _jax_tokenizer_model("DI", 16)
    tok = image_lib.ImageTokenizer("DI", 16, device="cpu")
    load_state_dict_numpy(tok.model, state_dict_from_module(jmodel))
    x = np.random.RandomState(1).randn(1, 3, 64, 64).astype(np.float32).clip(-1, 1)
    (idx, codes), (jidx, jcodes, _) = tok.encode(x), _jax_encode(jmodel, jnp.asarray(x))
    assert idx.shape == (1, 4, 4) and codes.shape == (1, 6, 4, 4)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(codes, jcodes)
    _close(tok.decode(idx), _jax_decode(jmodel, jidx))


def test_image_tokenizer_builds_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        image_lib.ImageTokenizer("CI", 8)


def test_checkpoints_load_strictly(tmp_path, narrow_ci):
    """A .pth of a JAX module's export loads strictly through the heads' and load_model's readers; an extra key or a
    missing one raises (the JAX package loads these with strict=False)."""
    kw = dict(input_feature_dim=24, output_dim=2, patch_size=16)
    jhead = seeded_jax(lambda: jcosmos_head.CosmosFeature(rngs=nnx.Rngs(0), **kw))
    arrays = state_dict_from_module(jhead)
    path = str(tmp_path / "head.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}}, path)
    head = tcosmos_head.CosmosFeature(pretrained_checkpoint_path=path, **kw)
    assert all(np.array_equal(v.numpy(), np.asarray(arrays[k], np.float32)) for k, v in head.state_dict().items())
    torch.save({"model": {**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}, "extra": torch.zeros(1)}},
               path)
    with pytest.raises(KeyError, match="unexpected_keys=\\['extra'\\]"):
        tcosmos_head.CosmosFeature(pretrained_checkpoint_path=path, **kw)

    cfg = dict(SMALL_CFG, latent_channels=8, z_channels=8, z_factor=1)
    jnet = seeded_jax(lambda: jnetworks.TokenizerModels.CI.value(rngs=nnx.Rngs(0), **cfg))
    state = {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_module(jnet).items()}
    torch.save(state, path)  # a bare state dict
    net = utils.load_model("CI", path, device="cpu", **cfg)
    assert all(torch.equal(v, state[k]) for k, v in net.state_dict().items())
    state.pop("quant_conv.bias")
    torch.save(state, path)
    with pytest.raises(KeyError, match="missing_keys=\\['quant_conv.bias'\\]"):
        utils.load_model("CI", path, device="cpu", **cfg)


def test_array_helpers_match_jax():
    img = np.random.RandomState(2).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    t = utils.numpy2tensor(img)
    assert t.shape == (1, 3, 5, 7) and t.dtype == torch.float32
    _close(t, jutils.numpy2tensor(img))
    assert np.array_equal(utils.tensor2numpy(t), jutils.tensor2numpy(np.asarray(jutils.numpy2tensor(img))))
    vid = np.random.RandomState(3).randint(0, 256, (4, 5, 6, 3)).astype(np.uint8)
    tv = utils.numpy2tensor(vid)
    _close(tv, jutils.numpy2tensor(vid))
    padded, crop = utils.pad_video_batch(tv, 4, 8)
    jpadded, jcrop = jutils.pad_video_batch(jnp.asarray(tv.numpy()), 4, 8)
    assert crop == jcrop and padded.shape == (1, 3, 5, 8, 8)
    _close(padded, jpadded)
    _close(utils.unpad_video_batch(padded, crop), tv)
    with pytest.raises(ValueError):
        utils.numpy2tensor(np.zeros((3, 3)))


# --- the PNG codec and the CLI -------------------------------------------------------------------------------------


def test_png_codec_reads_what_pil_writes_and_the_other_way_round(tmp_path):
    "PIL's encoder picks every scanline filter over a noisy gradient; gray and RGBA files too."
    from PIL import Image

    y, x = np.mgrid[0:37, 0:53]
    rng = np.random.RandomState(4)
    rgb = np.stack([x * 4, y * 6, (x * y) % 256], -1).astype(np.uint8)
    rgb[::3] = rng.randint(0, 256, rgb[::3].shape)
    for mode, arr in (("RGB", rgb), ("RGBA", np.concatenate([rgb, rgb[..., :1]], -1)), ("L", rgb[..., 1])):
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(arr, mode).save(path)
        assert np.array_equal(read_png(path), np.asarray(Image.open(path).convert("RGB"))), mode
    path = str(tmp_path / "mine.png")
    write_png(path, rgb)
    assert np.array_equal(np.asarray(Image.open(path)), rgb) and np.array_equal(read_png(path), rgb)


def test_image_cli_on_the_cpu(tmp_path):
    "The CLI autoencodes a PNG on the CPU (full CI width) and writes the reconstruction, as the JAX CLI's flags say."
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    write_png(src, np.random.RandomState(5).randint(0, 256, (32, 48, 3)).astype(np.uint8))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "uniception_tpu_torch.models.libs.cosmos_tokenizer.image_cli", "--device", "cpu",
         "--image", src, "--output", dst, "--tokenizer", "CI", "--spatial-compression", "16"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "input (1, 3, 32, 48) -> recon (1, 3, 32, 48)" in proc.stdout and f"wrote {dst}" in proc.stdout
    assert read_png(dst).shape == (32, 48, 3)
