"""
The port's Cosmos causal video tokenizer against the JAX package on the CPU, in fp32: 3D haar and rearrange
(un)patching, CausalConv3d at every kernel and stride shape the configs use, CausalNormalize per frame and over the
clip, every up- and downsampler (with one frame and with several), the spatial and the causal temporal attention
blocks, the BASE and FACTORIZED encoders and decoders (``legacy_mode`` on and off), the CV network as an AE and as a
VAE (JAX's draw injected), the DV network with FSQ and residual FSQ (indices equal) and the JAX package's VQ / LFQ
faults, the registries, ``load_model`` with a strict load, ``CausalVideoTokenizer`` and the CLI. Each JAX module is
built from seeded numpy weights and carried across by ``state_dict_from_module`` -> ``load_state_dict_numpy``
(strict); inputs come from numpy. Sizes are the JAX test's SMALL_CFG (tests/models/test_cosmos_video.py: 16 channels,
resolution 32, patch 2, 5-9 frames).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.libs.cosmos_tokenizer import networks as jnetworks
from uniception_tpu.models.libs.cosmos_tokenizer.modules import Decoder3DType as JDecoder3DType
from uniception_tpu.models.libs.cosmos_tokenizer.modules import Encoder3DType as JEncoder3DType
from uniception_tpu.models.libs.cosmos_tokenizer.modules import layers3d as jl
from uniception_tpu.models.libs.cosmos_tokenizer.modules import patching as jpatching
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch.models.libs.cosmos_tokenizer import networks, utils, video_cli, video_lib
from uniception_tpu_torch.models.libs.cosmos_tokenizer import modules as tmodules
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import distributions as tdist
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import layers3d as tl
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import patching as tpatching
from uniception_tpu_torch.utils.weights import load_state_dict_numpy
from tests.test_torch_cosmos import _close, _pair, _randn, _seeded
from tests.test_torch_quant import jax_module

_jax_forward = nnx.jit(lambda m, *args: m(*args))
_jax_decode = nnx.jit(lambda m, z: m.decode(z))
_jax_encode = nnx.jit(lambda m, x: m.encode(x))

# tests/models/test_cosmos_video.py's SMALL_CFG: the 8 x 8 level attends (spatial + temporal), two levels
SMALL_CFG = dict(attn_resolutions=[8], channels=16, channels_mult=[2, 4], dropout=0.0, in_channels=3, num_res_blocks=1,
                 out_channels=3, resolution=32, patch_size=2, patch_method="haar", spatial_compression=8,
                 temporal_compression=4)
LEVELS = [8, 8, 8, 5, 5, 5]
NARROW = dict(channels=16, num_res_blocks=1, resolution=32, attn_resolutions=[8])


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
def narrow_video(monkeypatch):
    """The CV and DV configs at 16 channels, one resnet block a level and resolution 32 (the 8 x 8 level attends) in
    both packages' tables; the published levels, patching and compressions stay (load_model, the tokenizer and the
    CLI read the tables)."""
    for kind in ("CV", "DV"):
        for table in (jnetworks.TokenizerConfigs[kind].value, networks.TokenizerConfigs[kind].value):
            for key, value in NARROW.items():
                monkeypatch.setitem(table, key, value)


# --- patching ------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["haar", "rearrange"])
@pytest.mark.parametrize("patch_size", [2, 4])
def test_patcher3d_matches_jax_and_round_trips(method, patch_size):
    "The first frame repeated p times, the eight sub-bands' order per level; the inverse drops p - 1 frames."
    a, t, j = _randn(0, 2, 3, 1 + 2 * patch_size, 16, 16)
    patched = tpatching.Patcher3D(patch_size, method)(t)
    want = jpatching.Patcher3D(patch_size, method)(j)
    assert patched.shape == (2, 3 * patch_size**3, 3, 16 // patch_size, 16 // patch_size)
    _close(patched, want)
    back = tpatching.UnPatcher3D(patch_size, method)(patched)
    _close(back, jpatching.UnPatcher3D(patch_size, method)(want))
    _close(back, a)


def test_patcher3d_rejects_an_unknown_method():
    for cls in (tpatching.Patcher3D, tpatching.UnPatcher3D):
        with pytest.raises(ValueError, match="Unknown patch method"):
            cls(2, "wavelet")(torch.zeros(1, 24, 2, 4, 4))


# --- the layers ----------------------------------------------------------------------------------------------------

# (kernel, stride, time_stride, padding): every CausalConv3d the configs build (the resnet blocks' and conv_in's
# factorized pair, the BASE variant's 3x3x3, the 1x1x1 projections, the hybrid samplers' strided convs and
# CausalDownsample3d's), and a dilated one
CONV_SHAPES = [((1, 3, 3), 1, 1, 1), ((3, 1, 1), 1, 1, 0), (3, 1, 1, 1), (1, 1, 1, 0), ((1, 3, 3), 2, 1, 0),
               ((3, 1, 1), 1, 2, 0), (3, 2, 2, 0)]


@pytest.mark.parametrize("kernel,stride,time_stride,padding", CONV_SHAPES)
def test_causal_conv3d_matches_jax(kernel, stride, time_stride, padding):
    kw = dict(kernel_size=kernel, stride=stride, time_stride=time_stride, padding=padding)
    jm, tm = _pair(lambda: jl.CausalConv3d(8, 12, rngs=nnx.Rngs(0), **kw), tl.CausalConv3d(8, 12, **kw))
    assert set(tm.state_dict()) == {"conv3d.weight", "conv3d.bias"}
    _, x, jx = _randn(1, 2, 8, 5, 9, 10)
    out = tm(x)
    _close(out, _jax_forward(jm, jx))


def test_causal_conv3d_with_dilation_matches_jax():
    kw = dict(kernel_size=3, padding=2, dilation=2, time_dilation=2)
    jm, tm = _pair(lambda: jl.CausalConv3d(4, 4, rngs=nnx.Rngs(0), **kw), tl.CausalConv3d(4, 4, **kw))
    _, x, jx = _randn(2, 1, 4, 6, 8, 8)
    _close(tm(x), _jax_forward(jm, jx))


@pytest.mark.parametrize("groups", [1, 32])
def test_causal_normalize_matches_jax(groups):
    "One group: statistics per frame (the frames folded into the batch); 32: over the whole clip per group."
    jm, tm = _pair(lambda: jl.CausalNormalize(64, groups, rngs=nnx.Rngs(0)), tl.CausalNormalize(64, groups))
    assert set(tm.state_dict()) == {"norm.weight", "norm.bias"}
    _, x, jx = _randn(3, 2, 64, 3, 5, 6, scale=2.0)
    out = tm(x)
    _close(out, _jax_forward(jm, jx))
    if groups == 1:  # frame 0 alone normalizes as it does within the clip: causal
        _close(tm(x[:, :, :1]), np.asarray(_jax_forward(jm, jx))[:, :, :1])


SAMPLERS = {
    "upsample": lambda m, kw: m.CausalUpsample3d(8, **kw),
    "downsample": lambda m, kw: m.CausalDownsample3d(8, **kw),
    "hybrid up": lambda m, kw: m.CausalHybridUpsample3d(8, **kw),
    "hybrid up time": lambda m, kw: m.CausalHybridUpsample3d(8, spatial_up=False, **kw),
    "hybrid up space": lambda m, kw: m.CausalHybridUpsample3d(8, temporal_up=False, **kw),
    "hybrid up none": lambda m, kw: m.CausalHybridUpsample3d(8, spatial_up=False, temporal_up=False, **kw),
    "hybrid down": lambda m, kw: m.CausalHybridDownsample3d(8, **kw),
    "hybrid down time": lambda m, kw: m.CausalHybridDownsample3d(8, spatial_down=False, **kw),
    "hybrid down space": lambda m, kw: m.CausalHybridDownsample3d(8, temporal_down=False, **kw),
    "hybrid down none": lambda m, kw: m.CausalHybridDownsample3d(8, spatial_down=False, temporal_down=False, **kw),
}


@pytest.mark.parametrize("frames", [1, 5])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_samplers_match_jax(name, frames):
    "Every sampler at 5 frames and at 1 (its time factor is 1 there: one frame stays one)."
    jm, tm = _pair(lambda: SAMPLERS[name](jl, dict(rngs=nnx.Rngs(0))), SAMPLERS[name](tl, {}))
    _, x, jx = _randn(4, 2, 8, frames, 8, 8)
    out, want = tm(x), _jax_forward(jm, jx)
    assert out.shape == want.shape
    _close(out, want)


@pytest.mark.parametrize("block", ["CausalAttnBlock", "CausalTemporalAttnBlock"])
def test_attention_blocks_match_jax(block):
    "The spatial block (K1's plain version on the CPU, one head of D = C) and the causal temporal einsum block."
    jm, tm = _pair(lambda: getattr(jl, block)(32, rngs=nnx.Rngs(0)), getattr(tl, block)(32))
    _, x, jx = _randn(5, 2, 32, 4, 6, 5)
    out = tm(x)
    _close(out, _jax_forward(jm, jx))
    if block == "CausalTemporalAttnBlock":  # causal: the first two frames do not see the later ones
        _close(tm(x[:, :, :2]), np.asarray(_jax_forward(jm, jx))[:, :, :2])


@pytest.mark.parametrize("kind", ["Base", "Factorized", "Factorized legacy"])
def test_encoders_and_decoders_match_jax(kind):
    """BASE (per-frame 2D patching, 4 groups) and FACTORIZED (3D patching; legacy_mode on and off picks which levels
    upsample in time) on 5 frames of 32 x 32, state dicts carried strictly both ways."""
    cfg = dict(SMALL_CFG, legacy_mode=kind.endswith("legacy"))
    if kind == "Base":
        cfg = dict(cfg, num_groups=4)
        cfg.pop("spatial_compression"), cfg.pop("temporal_compression")
    variant = kind.split()[0]
    jenc, enc = _pair(lambda: getattr(jl, f"Encoder{variant}")(z_channels=4, rngs=nnx.Rngs(0), **cfg),
                      getattr(tl, f"Encoder{variant}")(z_channels=4, **cfg))
    _, x, jx = _randn(6, 1, 3, 5, 32, 32)
    out = enc(x)
    assert out.shape == (1, 4, 2, 8, 8)
    _close(out, _jax_forward(jenc, jx))
    jdec, dec = _pair(lambda: getattr(jl, f"Decoder{variant}")(z_channels=4, rngs=nnx.Rngs(0), **cfg),
                      getattr(tl, f"Decoder{variant}")(z_channels=4, **cfg), seed=1)
    _, z, jz = _randn(7, 1, 4, 2, 8, 8)
    video, want = dec(z), _jax_forward(jdec, jz)
    assert video.shape == want.shape == ((1, 3, 3, 32, 32) if kind == "Factorized" else (1, 3, 5, 32, 32))
    _close(video, want)


# --- the CV and DV networks ----------------------------------------------------------------------------------------


@pytest.mark.parametrize("formulation", ["AE", "VAE"])
def test_continuous_video_network_matches_jax(formulation, monkeypatch):
    """CV with the FACTORIZED encoder and decoder. The encoder's channels_mult is [1, 2]: at temporal compression 4
    the reference builds the decoder alone with [2, 4] (continuous_video.py:32-33), which the strict load checks."""
    cfg = dict(SMALL_CFG, channels_mult=[1, 2], latent_channels=4, z_channels=4, z_factor=2 if formulation == "VAE"
               else 1, formulation=formulation, encoder="FACTORIZED", decoder="FACTORIZED")
    jnet, net = _pair(lambda: jnetworks.TokenizerModels.CV.value(rngs=nnx.Rngs(0), **cfg),
                      networks.TokenizerModels.CV.value(**cfg))
    assert net.decoder.conv_in[0].conv3d.out_channels == 4 * 16 and net.encoder.down[1].block[0].conv1[0].conv3d \
        .out_channels == 2 * 16
    _, x, jx = _randn(8, 2, 3, 5, 32, 32)
    key = jax.random.key(4) if formulation == "VAE" else None
    want = _jax_forward(jnet, jx, key)
    gen = None
    if key is not None:  # the port's draw is JAX's
        drawn = np.array(jax.random.normal(key, np.asarray(want.posteriors[0]).shape, jnp.float32))
        monkeypatch.setattr(tdist.GaussianDistribution, "standard_normal", lambda self, like, g: torch.from_numpy(drawn))
        gen = torch.Generator().manual_seed(0)
    out = net(x, generator=gen)
    assert out.latent.shape == (2, 4, 2, 8, 8)
    _close(out.latent, want.latent)
    _close(out.reconstructions, want.reconstructions)
    for got, ref in zip(out.posteriors, want.posteriors):
        _close(got, ref)
    if formulation == "AE":  # the decoder alone: the forward decodes the latent itself
        _close(net.decode(out.latent), want.reconstructions)


@pytest.mark.parametrize("quantizer", ["FSQ", "RESFSQ"])
def test_discrete_video_network_matches_jax(quantizer):
    "DV over 5-D latents: FSQ indices (B, T, H, W), residual FSQ (B, 2, T, H, W), equal to JAX's; decode from them."
    cfg = dict(SMALL_CFG, z_channels=16, embedding_dim=6, quantizer=quantizer, levels=LEVELS, num_quantizers=2,
               encoder="FACTORIZED", decoder="FACTORIZED")
    jnet, net = _pair(lambda: jnetworks.TokenizerModels.DV.value(rngs=nnx.Rngs(0), **cfg),
                      networks.TokenizerModels.DV.value(**cfg), levels=LEVELS)
    _, x, jx = _randn(9, 2, 3, 5, 32, 32)
    out, want = net(x), _jax_forward(jnet, jx)
    assert out.quant_info.shape == ((2, 2, 8, 8) if quantizer == "FSQ" else (2, 2, 2, 8, 8))
    assert out.quant_info.dtype == torch.int32 and np.array_equal(out.quant_info.numpy(), np.asarray(want.quant_info))
    _close(out.reconstructions, want.reconstructions)
    _close(out.quant_loss, want.quant_loss)
    _close(net.decode(out.quant_info), want.reconstructions)  # the indices' codes are the forward's codes


def test_discrete_video_vq_and_lfq_fail_as_in_jax():
    """The JAX package's DV cannot build VQ (its quantizer is not given embedding_dim) and LFQ's forward takes no 5-D
    latent; the port copies both (ROADMAP queue 3)."""
    vq = dict(SMALL_CFG, z_channels=8, embedding_dim=6, quantizer="VQ", num_embeddings=32, encoder="FACTORIZED",
              decoder="FACTORIZED")
    for build in (lambda: nnx.eval_shape(lambda: jnetworks.TokenizerModels.DV.value(rngs=nnx.Rngs(0), **vq)),
                  lambda: networks.TokenizerModels.DV.value(**vq)):
        with pytest.raises(TypeError, match="embedding_dim"):
            build()
    lfq = dict(vq, quantizer="LFQ", codebook_size=64, codebook_dim=6)
    jnet = jax_module(lambda: jnetworks.TokenizerModels.DV.value(rngs=nnx.Rngs(0), **lfq))
    net = networks.TokenizerModels.DV.value(**lfq)
    _, z, jz = _randn(10, 1, 6, 2, 8, 8)  # the 5-D latent quant_conv hands the quantizer
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jnet.quantizer(jz)
    with pytest.raises(RuntimeError, match="size of tensor"):
        net.quantizer(z)


def test_registries_and_configs_are_the_jax_packages():
    "The member lists of every registry, and the video configs verbatim; CV and DV build the real classes."
    for name in ("TokenizerConfigs", "TokenizerModels"):
        assert list(getattr(networks, name).__members__) == list(getattr(jnetworks, name).__members__)
    assert [m.name for m in tmodules.Encoder3DType] == [m.name for m in JEncoder3DType] == ["BASE", "FACTORIZED"]
    assert [m.name for m in tmodules.Decoder3DType] == [m.name for m in JDecoder3DType]
    assert tmodules.Encoder3DType.FACTORIZED.value is tl.EncoderFactorized
    assert tmodules.Decoder3DType.BASE.value is tl.DecoderBase
    for name in ("CV", "DV"):
        assert networks.TokenizerConfigs[name].value == jnetworks.TokenizerConfigs[name].value, name
        assert networks.TokenizerModels[name].value.__name__ == jnetworks.TokenizerModels[name].value.__name__
    assert not hasattr(tmodules, "COSMOS_3D")


# --- load_model, the tokenizer, the CLI ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_video_model(kind, spatial, temporal):
    """The network the JAX CausalVideoTokenizer(kind, spatial, temporal) builds from its table narrowed by NARROW,
    seeded; built once (its abstract construction traces every initializer)."""
    cfg = dict(jnetworks.TokenizerConfigs[kind].value, **NARROW, spatial_compression=spatial,
               temporal_compression=temporal)
    cfg.pop("name")
    return _seeded(lambda: jnetworks.TokenizerModels[kind].value(rngs=nnx.Rngs(0), **cfg), levels=cfg.get("levels"))


def test_load_model_loads_strictly(tmp_path, narrow_video):
    "A .pth of a JAX CV's export loads strictly; a missing key raises (the JAX package loads with strict=False)."
    jnet = _jax_video_model("CV", 8, 8)
    state = {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_module(jnet).items()}
    path = str(tmp_path / "cv.pth")
    torch.save({"model": state}, path)
    net = utils.load_model("CV", path, device="cpu")
    assert all(torch.equal(v, state[k]) for k, v in net.state_dict().items())
    state.pop("decoder.conv_out.1.conv3d.bias")
    torch.save(state, path)
    with pytest.raises(KeyError, match="missing_keys=\\['decoder.conv_out.1.conv3d.bias'\\]"):
        utils.load_model("CV", path, device="cpu")


@pytest.mark.parametrize("kind,spatial", [("CV", 8), ("DV", 16)])
def test_causal_video_tokenizer_matches_jax(kind, spatial, narrow_video):
    """encode, decode and autoencode of 9 frames at 32 x 32 through CausalVideoTokenizer at the published
    compressions (CV8x8x8, DV8x16x16), the tables narrowed: 9 frames -> 2 latent frames -> 9."""
    jmodel = _jax_video_model(kind, spatial, 8)
    tok = video_lib.CausalVideoTokenizer(kind, spatial, 8, device="cpu")
    load_state_dict_numpy(tok.model, state_dict_from_module(jmodel))
    x = np.random.RandomState(11).randn(1, 3, 9, 32, 32).astype(np.float32).clip(-1, 1)
    jenc = _jax_encode(jmodel, jnp.asarray(x))
    lat = 32 // spatial
    if kind == "CV":
        latent = tok.encode(x)
        assert latent.shape == (1, 16, 2, lat, lat)
        _close(latent, jenc[0])
        want = _jax_decode(jmodel, jenc[0])
        _close(tok.decode(latent), want)
    else:
        idx, codes = tok.encode(x)
        assert idx.shape == (1, 2, lat, lat) and codes.shape == (1, 6, 2, lat, lat)
        assert np.array_equal(idx.numpy(), np.asarray(jenc[0]))
        _close(codes, jenc[1])
        want = _jax_decode(jmodel, jenc[0])  # the forward's decoder input: the codes of these indices
        _close(tok.decode(idx), want)
    recon = tok.autoencode(x)
    assert isinstance(recon, np.ndarray) and recon.shape == x.shape
    _close(recon, want)


def test_causal_video_tokenizer_builds_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video_lib.CausalVideoTokenizer("CV")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video_cli.main(["--size", "16"])


@pytest.mark.parametrize("kind,spatial", [("CV", 8), ("DV", 16)])
def test_video_cli_on_the_cpu(kind, spatial, narrow_video, capsys):
    "The CLI autoencodes the seeded clip on the CPU and prints the JAX CLI's line, its error the tokenizer's own."
    video_cli.main(["--device", "cpu", "--tokenizer", kind, "--spatial-compression", str(spatial), "--frames", "9",
                    "--size", "32"])
    line = capsys.readouterr().out.strip()
    m = re.fullmatch(r"autoencode: input \(1, 3, 9, 32, 32\) -> recon \(1, 3, 9, 32, 32\), mean abs err (\d+\.\d{4})",
                     line)
    assert m, line
    x = np.random.RandomState(0).randn(1, 3, 9, 32, 32).astype(np.float32).clip(-1, 1)
    recon = video_lib.CausalVideoTokenizer(kind, spatial, 8, device="cpu").autoencode(x)
    assert m.group(1) == f"{np.abs(recon - x).mean():.4f}"
