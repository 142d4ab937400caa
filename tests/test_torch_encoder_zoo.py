"""
The port's encoder zoo against the JAX package on the CPU: RADIO (the ViT variants, heads of 80 and 64, and their
intermediate-feature returner), E-RADIO (heads of 32, two window sizes, the window choice, the partition and
merge), DINOv3's ViT (storage tokens, RoPE on the patch tokens only, the MLP and the SwiGLU-fused FFN, heads of 64
and 128) and ConvNeXt (and both returners), the Perception Encoder's vision transformer (heads of 96 and 64, with
and without a cls token, the PE table resized off its grid, LayerScale, the pooled embedding) and its encoder and
returner, Pixio (heads of 80, the PE table resized bicubically), the dense representation encoder (image and
non-image inputs) and the global representation encoder, each at f32 within the repo's 5e-5 bar. Each runs a few
blocks at narrow widths: the published configurations are swapped for narrow ones in both packages' tables. Every
encoder also loads a checkpoint written from a seeded JAX module under its torch key names, strictly, and gives
the JAX module's features; three load the JAX package's native state (``.nsv``: HWIO convs, depthwise and
transposed, to OIHW). The registry's key set is the JAX package's. Inputs come from numpy; weights are drawn in
the port from numpy and carried into JAX modules built from zeros.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models import encoders as jencoders
from uniception_tpu.models.encoders import dense_rep_encoder as jdense
from uniception_tpu.models.encoders import dinov3 as jdinov3
from uniception_tpu.models.encoders import eradio as jeradio
from uniception_tpu.models.encoders import global_rep_encoder as jglobal
from uniception_tpu.models.encoders import perception_encoder as jpenc
from uniception_tpu.models.encoders import pixio as jpixio
from uniception_tpu.models.encoders import radio as jradio
from uniception_tpu.models.encoders.base import EncoderGlobalRepInput as JaxGlobalInput
from uniception_tpu.models.encoders.base import ViTEncoderInput as JaxInput
from uniception_tpu.models.encoders.base import ViTEncoderNonImageInput as JaxNonImageInput
from uniception_tpu.models.libs.perception_encoder import pe as jpe
from uniception_tpu.utils import coldstart as jcs
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch.models import encoders
from uniception_tpu_torch.models.encoders import (
    dense_rep_encoder,
    dinov3,
    eradio,
    global_rep_encoder,
    perception_encoder,
    pixio,
    radio,
)
from uniception_tpu_torch.models.encoders.base import EncoderGlobalRepInput, ViTEncoderInput, ViTEncoderNonImageInput
from uniception_tpu_torch.models.libs.perception_encoder import pe
from uniception_tpu_torch.utils import coldstart
from tests.test_torch_quant import jax_module

TOL = 5e-5  # fp32 max abs per component, the repo's parity bar


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


@pytest.fixture(autouse=True)
def narrow(monkeypatch):
    "The narrow configurations of :func:`narrow_configs` in every test here."
    narrow_configs(monkeypatch)


def narrow_configs(monkeypatch):
    """Narrow stand-ins for the published configurations, in both packages' tables: RADIO v2.5-h keeps its heads
    of 80 (160 / 2) and -b its heads of 64, E-RADIO its heads of 32 (64 / 2, 128 / 4), DINOv3 ``small`` heads of 64
    and ``7b`` (SwiGLU) heads of 128, PE-G14 heads of 96 and PE-L14 (cls token) heads of 64; two blocks each."""
    for table in (jradio._RADIO_CONFIGS, radio.RADIO_CONFIGS):
        monkeypatch.setitem(table, "radio_v2.5-h", dict(embed_dim=160, depth=2, num_heads=2))
        monkeypatch.setitem(table, "radio_v2.5-b", dict(embed_dim=128, depth=2, num_heads=2))
        monkeypatch.setitem(table, "e-radio_v2", dict(embed_dim=48, depth=0, num_heads=0))
    for table in (jeradio.ERADIO_CONFIGS, eradio.ERADIO_CONFIGS):
        monkeypatch.setitem(table, "e-radio_v2", dict(channels=(16, 32, 64, 128), conv_depths=(1, 1),
                                                      attn_depths=(1, 1), num_heads=(2, 4), out_dim=48))
    for table in (jdinov3._DINOV3_VIT_CONFIGS, dinov3.DINOV3_VIT_CONFIGS):
        monkeypatch.setitem(table, "small", dict(embed_dim=128, depth=2, num_heads=2, ffn="mlp"))
        monkeypatch.setitem(table, "7b", dict(embed_dim=256, depth=2, num_heads=2, ffn="swiglu"))
    for table in (jdinov3._CONVNEXT_CONFIGS, dinov3.CONVNEXT_CONFIGS):
        monkeypatch.setitem(table, "base", dict(depths=(1, 1, 2, 1), dims=(8, 16, 32, 64)))
    for mod in (jpe, pe):
        g = mod.PEConfig(image_size=56, patch_size=14, width=192, layers=3, heads=2, mlp_ratio=8960 / 1536,
                         pool_type="attn", output_dim=64, use_cls_token=False)
        l14 = mod.PEConfig(image_size=42, patch_size=14, width=128, layers=2, heads=2, mlp_ratio=4.0,
                           pool_type="attn", output_dim=32, use_cls_token=True)
        monkeypatch.setitem(mod.PE_VISION_CONFIG, "PE-Core-G14-448", g)
        monkeypatch.setitem(mod.PE_VISION_CONFIG, "PE-Core-L14-336", l14)
        monkeypatch.setitem(mod.PE_VISION_CONFIG, "PE-Lang-G14-448", replace(
            g, pool_type="none", use_ln_post=False, output_dim=None, ls_init_value=0.1, layers=2))
        monkeypatch.setitem(mod.PE_VISION_CONFIG, "PE-Spatial-G14-448", replace(
            g, pool_type="none", use_ln_post=False, output_dim=None))


PIXIO = dict(img_size=64, patch_size=16, embed_dim=160, depth=2, num_heads=2)  # heads of 80
DENSE = dict(name="dense", in_chans=3, enc_embed_dim=32, patch_size=4, intermediate_dims=[48, 64, 64],
             input_size_for_pe=32)
GLOBAL = dict(name="global", in_chans=5, enc_embed_dim=32, intermediate_dims=[8, 16, 24])


def _ones_like_key(key: str) -> bool:
    "Norm weights and LayerScale gammas are drawn around 1, everything else around 0."
    leaf = key.rsplit(".", 1)[-1]
    return leaf == "gamma" or (leaf == "weight" and any(n in key for n in ("norm", "ln_", "layernorm")))


def _randomize(tmod, seed=0):
    """Redraw every entry of the port module's state from numpy (norm and LayerScale weights around 1, the rest
    around 0 at about 1/sqrt(fan-in)); returns the state as numpy arrays, the port module in eval mode."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in tmod.state_dict().items():
        ones = _ones_like_key(k)
        fan = int(np.prod(v.shape[1:])) if v.dim() >= 2 else v.shape[0]
        scale = 0.2 if ones else 0.5 / np.sqrt(max(fan, 1))
        state[k] = (float(ones) + rng.randn(*v.shape) * scale).astype(np.float32)
    tmod.load_state_dict({k: torch.from_numpy(a) for k, a in state.items()})
    tmod.eval()
    return state


def _carry(jax_ctor, tmod, seed=0, eager=False):
    """(JAX module holding the port module's redrawn weights, strictly, the port module). The JAX module is built
    from zeros (no initializer compiled), or with ``eager`` by its constructor (a module with plain array
    attributes)."""
    state = _randomize(tmod, seed)
    jmod = jax_ctor() if eager else jax_module(jax_ctor)
    load_torch_state_dict(jmod, state, verbose=False)
    return jmod, tmod


_jax_forward = nnx.jit(lambda m, *args: m(*args))
_jax_features = nnx.jit(lambda m, x: m.forward_features(x))
_jax_normed_features = nnx.jit(lambda m, x: m.forward_features(x, norm=True))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
    err = np.abs(got.float().numpy() - want).max(initial=0.0)
    assert err <= tol, err


def _image(seed, h, w, b=2, c=3):
    return np.random.RandomState(seed).randn(b, c, h, w).astype(np.float32)


def _inputs(img, norm):
    return (ViTEncoderInput(image=torch.from_numpy(img), data_norm_type=norm),
            JaxInput(image=jnp.asarray(img), data_norm_type=norm))


def _close_outputs(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.features, w.features)
    else:
        _close(got.features, want.features)


# --- RADIO and E-RADIO -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (80, 48)], ids=["64x64", "80x48"])
@pytest.mark.parametrize("version", ["radio_v2.5-h", "radio_v2.5-b"])
def test_radio_vit_matches_jax(version, hw):
    "The ViT variants (heads of 80 and 64, 8 registers) on a square and a non-square grid (the PE table resized)."
    kw = dict(name="radio", model_version=version)
    jmod, tmod = _carry(lambda: jradio.RADIOEncoder(rngs=nnx.Rngs(0), **kw), radio.RADIOEncoder(**kw))
    assert tmod.model.blocks[0].attn.head_dim == 160 // 2 if version.endswith("h") else 64
    t_in, j_in = _inputs(_image(1, *hw), "radio")
    got, want = tmod(t_in), _jax_forward(jmod, j_in)
    assert tuple(got.features.shape) == (2, tmod.enc_embed_dim, hw[0] // 16, hw[1] // 16)
    _close_outputs(got, want)


@pytest.mark.parametrize("indices,norm", [(1, True), ([0, 1], False), ([-2], True)])
def test_radio_intermediate_feature_returner_matches_jax(indices, norm):
    kw = dict(name="radio", model_version="radio_v2.5-h", indices=indices, norm_intermediate=norm)
    jmod, tmod = _carry(lambda: jradio.RADIOIntermediateFeatureReturner(rngs=nnx.Rngs(0), **kw),
                        radio.RADIOIntermediateFeatureReturner(**kw))
    t_in, j_in = _inputs(_image(2, 48, 64), "radio")
    _close_outputs(tmod(t_in), _jax_forward(jmod, j_in))


def test_radio_keep_first_n_layers_and_argument_checks():
    kw = dict(name="radio", model_version="radio_v2.5-h", keep_first_n_layers=1)
    jmod, tmod = _carry(lambda: jradio.RADIOEncoder(rngs=nnx.Rngs(0), **kw), radio.RADIOEncoder(**kw))
    assert len(tmod.model.blocks) == tmod.model.depth == 1
    t_in, j_in = _inputs(_image(3, 32, 48), "radio")
    _close_outputs(tmod(t_in), _jax_forward(jmod, j_in))
    with pytest.raises(ValueError, match="Input shape"):
        radio.RADIOEncoder(name="e", model_version="e-radio_v2")
    with pytest.raises(ValueError, match="Patch size must be 16"):
        radio.RADIOEncoder(name="r", model_version="radio_v2.5-h", patch_size=14)
    with pytest.raises(ValueError, match="normalization type"):
        tmod(ViTEncoderInput(image=torch.zeros(1, 3, 32, 32), data_norm_type="dinov2"))


@pytest.mark.parametrize("shape,window", [((512, 512), 16), ((224, 224), 7), ((192, 128), 2), ((128, 128), 4),
                                          ((96, 160), 1)])
def test_eradio_window_choice_matches_jax(shape, window):
    "The largest window up to 16 that tiles the /32 grid: 16 at 512 (windows of 1024 and 256 tokens), 7 at 224."
    jmod = jax_module(lambda: jeradio.ERadio(rngs=nnx.Rngs(0)))
    tmod = eradio.ERadio(device="meta")
    assert jmod.set_optimal_window_size(shape) == tmod.set_optimal_window_size(shape) == window


def test_eradio_window_partition_and_merge_match_jax():
    x = np.random.RandomState(4).randn(2, 6, 8, 5).astype(np.float32)
    t = eradio.window_partition(torch.from_numpy(x), 2)
    _close(t, jeradio._window_partition(jnp.asarray(x), 2), tol=0)
    assert torch.equal(eradio.window_merge(t, 2, 6, 8), torch.from_numpy(x))


@pytest.mark.parametrize("hw", [(128, 128), (192, 128)], ids=["128x128-window4", "192x128-window2"])
def test_eradio_matches_jax(hw):
    """E-RADIO through the RADIO encoder (heads of 32) at two window sizes, a non-square one among them: the patch
    features, and the trunk's summary and tokens."""
    kw = dict(name="eradio", model_version="e-radio_v2", eradio_input_shape=hw)
    jmod, tmod = _carry(lambda: jradio.RADIOEncoder(rngs=nnx.Rngs(0), **kw), radio.RADIOEncoder(**kw))
    assert tmod.model.window_size == jmod.model.window_size == {128: 4, 192: 2}[hw[0]]
    assert tmod.model.stage3[0].head_dim == tmod.model.stage4[0].head_dim == 32
    img = _image(5, *hw)
    t_in, j_in = _inputs(img, "radio")
    _close_outputs(tmod(t_in), _jax_forward(jmod, j_in))
    summary, tokens = tmod.model(torch.from_numpy(img))
    j_summary, j_tokens = _jax_forward(jmod.model, jnp.asarray(img))
    _close(summary, j_summary)
    _close(tokens, j_tokens)


# --- DINOv3 --------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (80, 48)], ids=["64x64", "80x48"])
@pytest.mark.parametrize("size", ["small", "7b"])
def test_dinov3_matches_jax(size, hw):
    """The ViT (MLP with heads of 64; SwiGLU with heads of 128), RoPE on the patch tokens only: features, and the
    cls and 4 storage tokens of forward_features."""
    kw = dict(name="dinov3", size=size)
    jmod, tmod = _carry(lambda: jdinov3.DINOv3Encoder(rngs=nnx.Rngs(0), **kw), dinov3.DINOv3Encoder(**kw))
    img = _image(6, *hw)
    t_in, j_in = _inputs(img, "dinov3")
    _close_outputs(tmod(t_in), _jax_forward(jmod, j_in))
    got, want = tmod.model.forward_features(torch.from_numpy(img)), _jax_features(jmod.model, jnp.asarray(img))
    assert tuple(got["x_norm_regtokens"].shape) == (2, 4, tmod.enc_embed_dim)
    for key in ("x_norm_clstoken", "x_norm_regtokens", "x_norm_patchtokens"):
        _close(got[key], want[key])


@pytest.mark.parametrize("indices,norm", [(1, True), ([0, 1], False)])
def test_dinov3_intermediate_feature_returner_matches_jax(indices, norm):
    kw = dict(name="dinov3", size="small", indices=indices, norm_intermediate=norm)
    jmod, tmod = _carry(lambda: jdinov3.DINOv3IntermediateFeatureReturner(rngs=nnx.Rngs(0), **kw),
                        dinov3.DINOv3IntermediateFeatureReturner(**kw))
    t_in, j_in = _inputs(_image(7, 48, 64), "dinov3")
    _close_outputs(tmod(t_in), _jax_forward(jmod, j_in))


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)], ids=["64x64", "96x64"])
def test_dinov3_convnext_and_its_returner_match_jax(hw):
    """ConvNeXt: the depthwise 7x7 and the LayerNorm over the channels, channels-last as in JAX; the stride-32
    features and every stage's output."""
    kw = dict(name="convnext", size="base")
    jmod, tmod = _carry(lambda: jdinov3.DINOv3ConvNextEncoder(rngs=nnx.Rngs(0), **kw),
                        dinov3.DINOv3ConvNextEncoder(**kw))
    img = _image(8, *hw)
    t_in, j_in = _inputs(img, "dinov3")
    got = tmod(t_in)
    assert tuple(got.features.shape) == (2, 64, hw[0] // 32, hw[1] // 32)
    _close_outputs(got, _jax_forward(jmod, j_in))
    ifr_kw = dict(kw, indices=[0, 2, 3])
    jifr, tifr = _carry(lambda: jdinov3.DINOv3ConvNextIntermediateFeatureReturner(rngs=nnx.Rngs(0), **ifr_kw),
                        dinov3.DINOv3ConvNextIntermediateFeatureReturner(**ifr_kw), seed=1)
    _close_outputs(tifr(t_in), _jax_forward(jifr, j_in))


# --- Pixio, dense and global representation encoders ----------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (80, 48)], ids=["native", "80x48"])
def test_pixio_matches_jax(hw):
    "Heads of 80, 8 cls tokens; off the 4 x 4 grid the PE table is resized bicubically by size (non-square)."
    jmod, tmod = _carry(lambda: jpixio.PixioEncoder(rngs=nnx.Rngs(0), **PIXIO), pixio.PixioEncoder(**PIXIO))
    t_in, j_in = _inputs(_image(13, *hw), "pixio")
    _close_outputs(tmod(t_in), _jax_forward(jmod, j_in))


def test_pixio_constructors_build_the_published_sizes():
    for ctor, (dim, depth, heads) in [(pixio.pixio_vitb16, (768, 12, 12)), (pixio.pixio_vith16, (1280, 32, 16)),
                                      (pixio.pixio_vit5b16, (3072, 48, 32))]:
        enc = ctor(device="meta")
        assert (enc.enc_embed_dim, len(enc.blocks), enc.blocks[0].attn.num_heads) == (dim, depth, heads)


@pytest.mark.parametrize("kind,hw", [("image", (32, 32)), ("image", (40, 24)), ("non-image", (32, 32))])
def test_dense_rep_encoder_matches_jax(kind, hw):
    "Pixel unshuffle, the 3x3 and 1x1 convs and residual blocks, the sinusoid PE on and off its grid."
    jmod, tmod = _carry(lambda: jdense.DenseRepresentationEncoder(rngs=nnx.Rngs(0), **DENSE),
                        dense_rep_encoder.DenseRepresentationEncoder(**DENSE), eager=True)
    img = _image(14, *hw)
    if kind == "image":
        t_in, j_in = _inputs(img, "dense_rep_encoder")
    else:
        t_in, j_in = ViTEncoderNonImageInput(data=torch.from_numpy(img)), JaxNonImageInput(data=jnp.asarray(img))
    _close_outputs(tmod(t_in), _jax_forward(jmod, j_in))
    assert "pos_embed" not in tmod.state_dict()


def test_global_rep_encoder_matches_jax():
    jmod, tmod = _carry(lambda: jglobal.GlobalRepresentationEncoder(rngs=nnx.Rngs(0), **GLOBAL),
                        global_rep_encoder.GlobalRepresentationEncoder(**GLOBAL))
    assert "encoder.0.0.0.0.weight" in tmod.state_dict()
    data = np.random.RandomState(15).randn(3, 5).astype(np.float32)
    got = tmod(EncoderGlobalRepInput(data=torch.from_numpy(data)))
    _close(got.features, _jax_forward(jmod, JaxGlobalInput(data=jnp.asarray(data))).features)


# --- checkpoints --------------------------------------------------------------------------------------------------

# (JAX constructor, port constructor, input kind, normalization) of each new encoder's checkpoint test
CKPT = {
    "radio": (lambda kw: jradio.RADIOEncoder(**kw), lambda kw: radio.RADIOEncoder(**kw),
              dict(name="radio", model_version="radio_v2.5-h"), "radio", (32, 48)),
    "eradio": (lambda kw: jradio.RADIOEncoder(**kw), lambda kw: radio.RADIOEncoder(**kw),
               dict(name="eradio", model_version="e-radio_v2", eradio_input_shape=(128, 64)), "radio", (128, 64)),
    "dinov3": (lambda kw: jdinov3.DINOv3Encoder(**kw), lambda kw: dinov3.DINOv3Encoder(**kw),
               dict(name="dinov3", size="7b"), "dinov3", (32, 48)),
    "dinov3_convnext": (lambda kw: jdinov3.DINOv3ConvNextEncoder(**kw), lambda kw: dinov3.DINOv3ConvNextEncoder(**kw),
                        dict(name="convnext", size="base"), "dinov3", (64, 64)),
    "perception_encoder": (lambda kw: jpenc.PerceptionEncoder(**kw), lambda kw: perception_encoder.PerceptionEncoder(**kw),
                           dict(name="pe", size="large"), "perception_encoder", (42, 56)),
    "pixio": (lambda kw: jpixio.PixioEncoder(**kw), lambda kw: pixio.PixioEncoder(**kw), PIXIO, "pixio", (48, 32)),
    "dense_rep_encoder": (lambda kw: jdense.DenseRepresentationEncoder(**kw),
                          lambda kw: dense_rep_encoder.DenseRepresentationEncoder(**kw), DENSE, "dense_rep_encoder",
                          (32, 32)),
    "global_rep_encoder": (lambda kw: jglobal.GlobalRepresentationEncoder(**kw),
                           lambda kw: global_rep_encoder.GlobalRepresentationEncoder(**kw), GLOBAL, None, None),
}


def _seeded(key, seed):
    """The JAX module of ``CKPT[key]`` holding weights drawn from numpy with ``seed`` (through a port module of the
    same configuration, which is then dropped)."""
    jctor, tctor, kw, _, _ = CKPT[key]
    return _carry(lambda: jctor(dict(kw, rngs=nnx.Rngs(0))), tctor(dict(kw)), seed=seed,
                  eager=key == "dense_rep_encoder")[0]


@pytest.mark.parametrize("key", sorted(CKPT))
def test_checkpoint_from_a_seeded_jax_module_loads_strictly(tmp_path, key):
    """A seeded JAX module, saved as a .pth under its torch key names (the ``model`` entry; PE's own file holds the
    vision transformer's keys), loads strictly into a freshly built port encoder through its checkpoint argument
    and gives the JAX module's features; a key too many is refused."""
    jctor, tctor, kw, norm, hw = CKPT[key]
    jmod = _seeded(key, 3)
    path = str(tmp_path / f"{key}.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_module(jmod).items()}}, path)
    arg = "pe_checkpoint_path" if key == "perception_encoder" else "pretrained_checkpoint_path"
    if key == "perception_encoder":  # PE's own file holds the vision transformer's keys
        torch.save({k[len("model."):]: v for k, v in torch.load(path)["model"].items()}, path)
    tmod = tctor(dict(kw, **{arg: path})).eval()
    if norm is None:
        data = np.random.RandomState(16).randn(2, kw["in_chans"]).astype(np.float32)
        got = tmod(EncoderGlobalRepInput(data=torch.from_numpy(data))).features
        want = _jax_forward(jmod, JaxGlobalInput(data=jnp.asarray(data))).features
    else:
        t_in, j_in = _inputs(_image(17, *hw), norm)
        got, want = tmod(t_in).features, _jax_forward(jmod, j_in).features
    _close(got, want)
    bad = str(tmp_path / "bad.pth")
    torch.save({"model": {**torch.load(path).get("model", torch.load(path)), "extra.weight": torch.zeros(1)}}, bad)
    with pytest.raises(KeyError, match="strict load failed"):
        tctor(dict(kw, **{arg: bad}))


def test_full_depth_checkpoint_loads_into_a_cut_encoder(tmp_path):
    "keep_first_n_layers builds the first blocks only; a full-depth file's later blocks are dropped on load."
    full = dict(name="radio", model_version="radio_v2.5-h")
    _, tmod = _carry(lambda: jradio.RADIOEncoder(rngs=nnx.Rngs(0), **full), radio.RADIOEncoder(**full))
    path = str(tmp_path / "radio.pth")
    torch.save({"model": tmod.state_dict()}, path)
    cut = dict(full, keep_first_n_layers=1)
    jcut, _ = _carry(lambda: jradio.RADIOEncoder(rngs=nnx.Rngs(0), **cut), radio.RADIOEncoder(**cut))
    load_torch_state_dict(jcut, {k: v.numpy() for k, v in tmod.state_dict().items() if ".blocks.1." not in k},
                          verbose=False)
    loaded = radio.RADIOEncoder(pretrained_checkpoint_path=path, **cut).eval()
    assert len(loaded.model.blocks) == loaded.model.depth == 1
    t_in, j_in = _inputs(_image(19, 32, 32), "radio")
    _close_outputs(loaded(t_in), _jax_forward(jcut, j_in))


@pytest.mark.parametrize("key", ["eradio", "dinov3_convnext", "dinov3"])
def test_jax_native_state_loads_into_the_port(tmp_path, key):
    """The JAX package's native file (JAX's layouts: HWIO convs, the depthwise 7x7, E-RADIO's transposed conv)
    loads into the port's encoder built on the meta device and gives the JAX module's features."""
    jctor, tctor, kw, norm, hw = CKPT[key]
    jmod = _seeded(key, 4)
    path = str(tmp_path / f"{key}.nsv")
    jcs.save_native_state(path, jmod)
    arrays, _ = coldstart.load_native_state(path)
    tmod = coldstart.materialize(coldstart.abstract_construct(lambda: tctor(dict(kw))), arrays=arrays,
                                 device="cpu").eval()
    t_in, j_in = _inputs(_image(18, *hw), norm)
    _close(tmod(t_in).features, _jax_forward(jmod, j_in).features)


# --- the registry -------------------------------------------------------------------------------------------------


def test_registry_key_set_is_the_jax_packages():
    "Every JAX encoder key is a port key and the other way round, so a new key on either side fails here."
    assert set(encoders.get_available_encoders()) == set(jencoders.get_available_encoders())
    assert [k for k in encoders.get_available_encoders() if not encoders.is_ported(k)] == []


def test_image_normalizations_of_the_zoo_are_the_jax_packages():
    "Every key of the JAX table is a port key and the other way round, with the same mean and std."
    from uniception_tpu.models.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT as JAX_NORMS
    from uniception_tpu_torch.models.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT

    assert set(IMAGE_NORMALIZATION_DICT) == set(JAX_NORMS)
    for key in JAX_NORMS:
        np.testing.assert_allclose(IMAGE_NORMALIZATION_DICT[key].mean, JAX_NORMS[key].mean, rtol=0, atol=1e-7)
        np.testing.assert_allclose(IMAGE_NORMALIZATION_DICT[key].std, JAX_NORMS[key].std, rtol=0, atol=1e-7)
