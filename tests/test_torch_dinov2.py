"""
The port's DINOv2 encoder family against the JAX package on the CPU: the DinoVisionTransformer trunk (0 and 4
registers, the MLP and the SwiGLU-fused FFN, square and non-square inputs), DINOv2Encoder (features, cls +
register tokens, keep_first_n_layers, norm_returned_features) and its intermediate-feature returner, checkpoints
in torch.hub's and UniCeption's key layouts, DUNE with its checkpoint remap, CroCo's intermediate-feature returner,
the PatchEmbedder, the encoder registry with its factories and the ``list`` CLI, and the JAX package's native
(``.nsv``) files of a DINOv2 encoder in both layouts. Weights are drawn in the port from numpy and carried into
JAX modules built from zeros; inputs come from numpy.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models import encoders as jencoders
from uniception_tpu.models.encoders import croco as jcroco
from uniception_tpu.models.encoders import dinov2 as jdinov2
from uniception_tpu.models.encoders import dune as jdune
from uniception_tpu.models.encoders import patch_embedder as jpatch
from uniception_tpu.models.encoders import vit as jvit
from uniception_tpu.models.encoders.base import ViTEncoderInput as JaxInput
from uniception_tpu.models.encoders.base import ViTEncoderNonImageInput as JaxNonImageInput
from uniception_tpu.nn.blocks import layer_norm_factory as jax_layer_norm_factory
from uniception_tpu.utils import coldstart as jcs
from uniception_tpu.utils.torch_compat import _leaf_entries, load_torch_state_dict, state_dict_from_module, torch_key_for
from uniception_tpu_torch.models import encoders
from uniception_tpu_torch.models.encoders import croco, dinov2, dune, patch_embedder, vit
from uniception_tpu_torch.models.encoders.base import ViTEncoderInput, ViTEncoderNonImageInput
from uniception_tpu_torch.nn.blocks import layer_norm_factory
from uniception_tpu_torch.utils import coldstart
from uniception_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_encoder_zoo import narrow_configs
from tests.test_torch_quant import jax_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 5e-5  # fp32 max abs per component, the repo's parity bar
SMALL = dict(name="dinov2", size="small", keep_first_n_layers=2)  # ViT-S width (384, 6 heads of 64), 2 blocks


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


def _randomize(tmod, seed=0):
    """Redraw every entry of the port module's state from numpy (norm and LayerScale weights around 1, the rest
    around 0 at about 1/sqrt(width)); returns the state as numpy arrays, the port module in eval mode."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in tmod.state_dict().items():
        ones = k.endswith("gamma") or ("norm" in k and k.endswith("weight"))
        scale = 0.2 if ones else 0.5 / np.sqrt(max(v.shape[-1], 1))
        state[k] = (float(ones) + rng.randn(*v.shape) * scale).astype(np.float32)
    tmod.load_state_dict({k: torch.from_numpy(a) for k, a in state.items()})
    tmod.eval()
    return state


def _carry(jax_ctor, tmod, seed=0, eager=False):
    """(JAX module holding the port module's redrawn weights, the port module). The JAX module is built from zeros
    (no initializer compiled), or with ``eager`` by its constructor (a scan-stacked module's per-depth RNG keys)."""
    state = _randomize(tmod, seed)
    jmod = jax_ctor() if eager else jax_module(jax_ctor)
    load_torch_state_dict(jmod, state, verbose=False)
    return jmod, tmod


# the JAX modules' forward, compiled: one compile costs a fraction of an eager call's op-by-op compiles on the CPU
_jax_forward = nnx.jit(lambda m, *args: m(*args))
_jax_features = nnx.jit(lambda m, x: m.forward_features(x))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
    err = np.abs(got.float().numpy() - want).max(initial=0.0)
    assert err <= tol, err


def _image(seed, h, w, b=2):
    return np.random.RandomState(seed).randn(b, 3, h, w).astype(np.float32)


def _inputs(img, norm="dinov2"):
    return ViTEncoderInput(image=torch.from_numpy(img), data_norm_type=norm), JaxInput(image=jnp.asarray(img),
                                                                                       data_norm_type=norm)


@pytest.mark.parametrize("registers,ffn,hw", [(0, "mlp", (56, 56)), (4, "mlp", (56, 56)), (0, "mlp", (84, 70)),
                                              (4, "mlp", (84, 70)), (4, "swiglufused", (84, 70))])
def test_trunk_matches_jax(registers, ffn, hw):
    "The trunk at 56 x 56 (its native PE grid) and 84 x 70 (6 x 5 patches: the interpolated PE), heads of 16."
    kw = dict(img_size=56, patch_size=14, embed_dim=64, depth=2, num_heads=4, num_register_tokens=registers,
              ffn_layer=ffn)
    jmod, tmod = _carry(lambda: jvit.DinoVisionTransformer(rngs=nnx.Rngs(0), **kw), vit.DinoVisionTransformer(**kw))
    img = _image(0, *hw)
    got, want = tmod.forward_features(torch.from_numpy(img)), _jax_features(jmod, jnp.asarray(img))
    assert got["grid_hw"] == tuple(int(n) for n in want["grid_hw"]) == (hw[0] // 14, hw[1] // 14)
    for key in ("x_norm_clstoken", "x_norm_regtokens", "x_norm_patchtokens"):
        _close(got[key], want[key])


@pytest.mark.parametrize("with_registers", [False, True], ids=["no_reg", "reg"])
@pytest.mark.parametrize("hw", [(56, 56), (84, 70)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_dinov2_encoder_matches_jax(with_registers, hw):
    "ViT-S width, 2 blocks: BCHW features and the (B, D, 1 + R) cls + register tokens."
    jmod, tmod = _carry(lambda: jdinov2.DINOv2Encoder(with_registers=with_registers, rngs=nnx.Rngs(0), **SMALL),
                        dinov2.DINOv2Encoder(with_registers=with_registers, **SMALL))
    assert tmod.name == ("dinov2_reg" if with_registers else "dinov2") == jmod.name
    t_in, j_in = _inputs(_image(1, *hw))
    got, want = tmod(t_in), _jax_forward(jmod, j_in)
    assert tuple(got.features.shape) == (2, 384, hw[0] // 14, hw[1] // 14)
    _close(got.features, want.features)
    assert tuple(got.registers.shape) == (2, 384, 5 if with_registers else 1)
    _close(got.registers, want.registers)


def test_keep_first_n_layers_and_unnormed_features_match_jax():
    kw = dict(SMALL, norm_returned_features=False)
    jmod, tmod = _carry(lambda: jdinov2.DINOv2Encoder(rngs=nnx.Rngs(0), **kw), dinov2.DINOv2Encoder(**kw))
    assert len(tmod.model.blocks) == tmod.model.depth == 2
    assert sorted(tmod.state_dict()) == sorted(state_dict_from_module(jmod))
    assert not any(k.startswith(("model.blocks.2.", "model.norm.")) for k in tmod.state_dict())
    t_in, j_in = _inputs(_image(2, 56, 56))
    got, want = tmod(t_in), _jax_forward(jmod, j_in)
    _close(got.features, want.features)
    _close(got.registers, want.registers)


@pytest.mark.parametrize("indices,norm", [([0, -1], True), (2, False), ([-2], True)])
def test_intermediate_feature_returner_matches_jax(indices, norm):
    "Positive and negative indices and a last-n count, with and without the final norm, over 3 blocks."
    kw = dict(SMALL, keep_first_n_layers=3, with_registers=True, indices=indices, norm_intermediate=norm)
    jmod, tmod = _carry(lambda: jdinov2.DINOv2IntermediateFeatureReturner(rngs=nnx.Rngs(0), **kw),
                        dinov2.DINOv2IntermediateFeatureReturner(**kw))
    t_in, j_in = _inputs(_image(3, 84, 70, b=1))
    got, want = tmod(t_in), _jax_forward(jmod, j_in)
    assert len(got) == len(want) == (len(indices) if isinstance(indices, list) else indices)
    for g, w in zip(got, want):
        assert g.registers is None
        _close(g.features, w.features)


@pytest.mark.parametrize("layout", ["hub .pth", "uniception .npz"])
def test_pretrained_checkpoint_loads_hub_and_uniception_layouts(tmp_path, layout):
    """A torch.hub state dict (no ``model.`` prefix) or a UniCeption one (``model.*``, the JAX package's file),
    each with the unused mask_token, loads strict through pretrained_checkpoint_path."""
    src = dinov2.DINOv2Encoder(with_registers=True, **SMALL)
    state = _randomize(src, seed=4)
    if layout == "hub .pth":
        path = str(tmp_path / "dinov2.pth")
        hub = {k[len("model."):]: torch.from_numpy(v) for k, v in state.items()}
        torch.save({**hub, "mask_token": torch.zeros(1, 384)}, path)
    else:
        path = str(tmp_path / "dinov2.npz")
        save_checkpoint(path, {**state, "model.mask_token": np.zeros((1, 384), np.float32)})
    loaded = dinov2.DINOv2Encoder(with_registers=True, pretrained_checkpoint_path=path, **SMALL)
    assert loaded.state_dict().keys() == state.keys()
    assert all(torch.equal(loaded.state_dict()[k], torch.from_numpy(v)) for k, v in state.items())


def _dune_layout(state):
    "The DUNE checkpoint layout of an encoder state: ``encoder.*``, blocks chunked as blocks.0.N, extra entries."
    out = {}
    for k, v in state.items():
        k = k[len("model."):]
        if k.startswith("blocks."):
            _, idx, rest = k.split(".", 2)
            k = f"blocks.0.{idx}.{rest}"
        out["encoder." + k] = v
    out["encoder.mask_token"] = np.zeros((1, 384), np.float32)
    out["projectors.0.weight"] = np.zeros((4, 4), np.float32)
    return out


def test_dune_remap_round_trip_and_forward_match_jax(tmp_path):
    "DUNE (ViT-S width, 2 blocks, PE table for 448) from a DUNE-layout checkpoint, in both packages."
    kw = dict(name="dune", vit_size="small", keep_first_n_layers=2)
    src = dune.DUNEEncoder(**kw)
    assert tuple(src.model.pos_embed.shape) == (1, 32 * 32 + 1, 384)
    state = _randomize(src, seed=6)
    ckpt = _dune_layout(state)
    remapped = dune._extract_and_remap_encoder_weights(ckpt)
    assert remapped.keys() == jdune._extract_and_remap_encoder_weights(ckpt).keys() == state.keys()
    assert all(np.array_equal(remapped[k], v) for k, v in state.items())
    path = str(tmp_path / "dune.npz")
    save_checkpoint(path, ckpt)
    tmod = dune.DUNEEncoder(pretrained_checkpoint_path=path, **kw).eval()
    assert all(torch.equal(tmod.state_dict()[k], torch.from_numpy(v)) for k, v in state.items())
    jmod = jdune.DUNEEncoder(pretrained_checkpoint_path=path, rngs=nnx.Rngs(0), **kw)
    t_in, j_in = _inputs(_image(7, 84, 70), norm="dune")
    got, want = tmod(t_in), _jax_forward(jmod, j_in)
    assert got.registers is None
    _close(got.features, want.features)


def test_dune_intermediate_feature_returner_matches_jax():
    kw = dict(name="dune", vit_size="small", keep_first_n_layers=2, indices=[0, 1])
    jmod, tmod = _carry(lambda: jdune.DUNEIntermediateFeatureReturner(rngs=nnx.Rngs(0), **kw),
                        dune.DUNEIntermediateFeatureReturner(**kw))
    t_in, j_in = _inputs(_image(8, 56, 42, b=1), norm="dune")
    for g, w in zip(tmod(t_in), _jax_forward(jmod, j_in)):
        _close(g.features, w.features)


CROCO = dict(name="croco", data_norm_type="croco", patch_embed_cls="PatchEmbedDust3R", img_size=(32, 32),
             patch_size=16, enc_embed_dim=64, enc_depth=3, enc_num_heads=4)


@pytest.mark.parametrize("ifr", [dict(indices=None), dict(indices=[0, -1], norm_intermediate=False),
                                 dict(indices=2, intermediates_only=False),
                                 dict(indices=[1], stop_early=True, intermediates_only=False)],
                         ids=["all", "0,-1 unnormed", "last 2 + final", "stop early"])
def test_croco_intermediate_feature_returner_matches_jax(ifr):
    jmod, tmod = _carry(lambda: jcroco.CroCoIntermediateFeatureReturner(rngs=nnx.Rngs(0), **CROCO, **ifr),
                        croco.CroCoIntermediateFeatureReturner(**CROCO, **ifr))
    t_in, j_in = _inputs(_image(9, 32, 48), norm="croco")
    got, want = tmod(t_in), _jax_forward(jmod, j_in)
    if not ifr.get("intermediates_only", True):
        _close(got[0].features, want[0].features)
        got, want = got[1], want[1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.features, w.features)


def test_croco_pretrained_checkpoint_and_its_attributes(tmp_path):
    "A reference CroCo checkpoint loads; its data_norm_type must be the encoder's unless overridden."
    state = _randomize(croco.CroCoEncoder(**CROCO), seed=10)
    path = str(tmp_path / "croco.npz")
    save_checkpoint(path, state, data_norm_type="croco", patch_embed_cls="PatchEmbedDust3R")
    loaded = croco.CroCoEncoder(pretrained_checkpoint_path=path, **CROCO)
    assert all(torch.equal(loaded.state_dict()[k], torch.from_numpy(v)) for k, v in state.items())
    other = dict(CROCO, data_norm_type="dust3r")
    with pytest.raises(ValueError, match="data_norm_type"):
        croco.CroCoEncoder(pretrained_checkpoint_path=path, **other)
    croco.CroCoEncoder(pretrained_checkpoint_path=path, override_checkpoint_attributes=True, **other)


@pytest.mark.parametrize("kind,hw,norm", [("image", (56, 56), False), ("image", (84, 70), True),
                                          ("non-image", (42, 70), False)])
def test_patch_embedder_matches_jax(kind, hw, norm):
    kw = dict(name="pe", input_size=56, patch_size=14, in_chans=3 if kind == "image" else 5, enc_embed_dim=48)
    jkw, tkw = dict(kw), dict(kw)
    if norm:
        jkw["norm_layer"], tkw["norm_layer"] = jax_layer_norm_factory(1e-5), layer_norm_factory(1e-5)
    jmod, tmod = _carry(lambda: jpatch.PatchEmbedder(rngs=nnx.Rngs(0), **jkw), patch_embedder.PatchEmbedder(**tkw))
    data = np.random.RandomState(11).randn(2, kw["in_chans"], *hw).astype(np.float32)
    if kind == "image":
        t_in, j_in = _inputs(data, norm="patch_embedder")
    else:
        t_in, j_in = ViTEncoderNonImageInput(data=torch.from_numpy(data)), JaxNonImageInput(data=jnp.asarray(data))
    _close(tmod(t_in).features, _jax_forward(jmod, j_in).features)


def test_registry_lists_every_jax_key():
    assert sorted(encoders.ENCODER_CONFIGS) == sorted(jencoders.ENCODER_CONFIGS) == encoders.get_available_encoders()
    for key, cfg in encoders.ENCODER_CONFIGS.items():
        jcfg = jencoders.ENCODER_CONFIGS[key]
        assert cfg["supported_models"] == jcfg["supported_models"], key
        assert ("intermediate_feature_returner_class" in cfg) == ("intermediate_feature_returner_class" in jcfg), key
        assert encoders.is_ported(key), key  # every JAX key builds in the port


@pytest.mark.parametrize("key,kw", [
    ("croco", CROCO), ("dinov2", SMALL), ("dune", dict(name="dune", vit_size="small", keep_first_n_layers=1)),
    ("patch_embedder", dict(name="pe", enc_embed_dim=32, input_size=28)),
    ("radio", dict(name="radio", model_version="radio_v2.5-b", keep_first_n_layers=1)),
    ("dinov3", dict(name="dinov3", size="small", keep_first_n_layers=1)),
    ("dinov3_convnext", dict(name="convnext", size="base")),
    ("perception_encoder", dict(name="pe", size="large", keep_first_n_layers=0)),
    ("pixio", dict(name="pixio", embed_dim=64, depth=1, num_heads=2)),
    ("dense_rep_encoder", dict(name="dense", patch_size=4, intermediate_dims=[48, 64], enc_embed_dim=32)),
    ("global_rep_encoder", dict(name="global", intermediate_dims=[8], enc_embed_dim=16)),
    ("cosmos", dict(name="cosmos", patch_size=16)),
])
def test_factories_build_every_ported_key(key, kw, monkeypatch):
    """Each ported key builds on the CPU from a seed (the same weights for the same seed), and its IFR where it has
    one; the zoo's published configurations at tests/test_torch_encoder_zoo.py's narrow widths."""
    narrow_configs(monkeypatch)
    enc = encoders.encoder_factory(key, device="cpu", seed=3, **kw)
    assert isinstance(enc, encoders.ENCODER_CONFIGS[key]["class"])
    again = encoders.encoder_factory(key, device="cpu", seed=3, **kw).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in enc.state_dict().items())
    if "intermediate_feature_returner_class" in encoders.ENCODER_CONFIGS[key]:
        ifr = encoders.feature_returner_encoder_factory(key, device="cpu", **kw)
        assert isinstance(ifr, encoders.ENCODER_CONFIGS[key]["intermediate_feature_returner_class"])
    else:
        with pytest.raises(ValueError, match="no intermediate-feature-returner"):
            encoders.feature_returner_encoder_factory(key, device="cpu", **kw)


def test_factories_refuse_unknown_keys_and_build_on_the_card_by_default():
    for factory in (encoders.encoder_factory, encoders.feature_returner_encoder_factory):
        with pytest.raises(ValueError, match="Unknown encoder"):
            factory("dinov4", name="x")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encoders.encoder_factory("dinov2", **SMALL)


# JAX's canonical test strings; those marked True are also built abstractly in JAX and their shapes compared
CANONICAL = {"dummy": True, "croco": False, "dust3r_224": False, "dust3r_512": False, "dust3r_512_dpt": False,
             "mast3r_512": False, "dinov2_small": False, "dinov2_base_reg": False, "dinov2_large_dav2": False,
             "dinov2_giant_reg": True, "dune": True, "patch_embedder": True, "radio_v2.5-b": True, "e-radio_v2": True,
             "dinov3_base": True, "dinov3_convnext_base": True, "perception_encoder_core_base": True, "pixio": True,
             "cosmos_ci8x8": True, "cosmos_ci16x16": True}


@pytest.mark.parametrize("encoder_str", sorted(CANONICAL))
def test_canonical_test_configurations_build_offline(encoder_str):
    """JAX's canonical configurations build on the meta device (full size, no memory) with no checkpoint file and
    none passed; for some, the names, normalization and every state-dict shape are JAX's (built abstractly)."""
    enc = encoders._make_encoder_test(encoder_str, device="meta")
    assert isinstance(enc, encoders.UniCeptionEncoderBase)
    assert all(p.device.type == "meta" for p in enc.parameters())
    if not CANONICAL[encoder_str]:
        return
    jenc = jencoders._make_encoder_test(encoder_str) if encoder_str == "dummy" else nnx.eval_shape(
        lambda: jencoders._make_encoder_test(encoder_str, rngs=nnx.Rngs(0)))
    assert enc.name == jenc.name and enc.data_norm_type == jenc.data_norm_type
    if encoder_str != "dummy":
        assert {k: tuple(v.shape) for k, v in enc.state_dict().items()} == _torch_layout_shapes(jenc)


def _torch_layout_shapes(abstract_jax_module):
    "{torch state-dict key: shape} of an abstract JAX module (torch_compat's key and layout rules)."
    shapes = {}
    for dotted, owner, attr, var in _leaf_entries(abstract_jax_module):
        shape = tuple(var.get_value().shape)
        if attr == "kernel" and isinstance(owner, nnx.Linear):
            shape = shape[::-1]
        elif attr == "kernel" and isinstance(owner, nnx.Conv):
            shape = (shape[3], shape[2], shape[0], shape[1])
        elif attr == "kernel" and isinstance(owner, nnx.ConvTranspose):
            shape = (shape[2], shape[3], shape[0], shape[1])
        shapes[torch_key_for(dotted, owner, attr)] = shape
    return shapes


@pytest.mark.parametrize("encoder_str,patch", [("cosmos_ci8x8", 8), ("cosmos_ci16x16", 16)])
def test_canonical_cosmos_strings_take_their_patch_size(encoder_str, patch):
    "JAX reads the Cosmos patch size (the spatial compression) from the string's last field, and so does the port."
    enc = encoders._make_encoder_test(encoder_str, device="meta")
    assert isinstance(enc, encoders.CosmosEncoder) and enc.patch_size == patch and enc.enc_embed_dim == 16
    assert [hasattr(level, "downsample") for level in enc.encoder.down] == [True, patch == 16, False]


def test_canonical_dinov3_string_parses_its_size_as_the_jax_package_does():
    "JAX reads the size as the string's last field, so its canonical 'dinov3_vitb16' names no size in either."
    with pytest.raises(KeyError):
        nnx.eval_shape(lambda: jencoders._make_encoder_test("dinov3_vitb16", rngs=nnx.Rngs(0)))
    with pytest.raises(ValueError, match="Unknown DINOv3 size 'vitb16'"):
        encoders._make_encoder_test("dinov3_vitb16", device="meta")


def test_list_cli_prints_the_registry():
    proc = subprocess.run([sys.executable, "-m", "uniception_tpu_torch.models.encoders.list"], cwd=REPO,
                          capture_output=True, text=True, timeout=300, check=True)
    lines = {line.split()[0]: line for line in proc.stdout.splitlines()[1:]}
    assert sorted(lines) == sorted(jencoders.ENCODER_CONFIGS)
    for key, line in lines.items():
        ifr = "yes" if "intermediate_feature_returner_class" in jencoders.ENCODER_CONFIGS[key] else "no"
        assert f"IFR: {ifr}" in line
        assert "port: builds" in line
        assert ", ".join(jencoders.ENCODER_CONFIGS[key]["supported_models"]) in line


@pytest.mark.parametrize("layout", ["loop", "scan"])
def test_jax_native_state_loads_into_the_port(tmp_path, layout):
    """A JAX DINOv2-reg encoder's native file (the scan layout stacks the blocks) loads into the port's encoder
    built on the meta device, strict, and gives JAX's features and registers."""
    kw = dict(SMALL, with_registers=True)
    jmod, _ = _carry(lambda: jdinov2.DINOv2Encoder(scan_blocks=layout == "scan", rngs=nnx.Rngs(0), **kw),
                     dinov2.DINOv2Encoder(**kw), eager=True)
    path = str(tmp_path / "dinov2.nsv")
    jcs.save_native_state(path, jmod)
    arrays, _ = coldstart.load_native_state(path)
    assert ("model.blocks.attn.qkv.kernel.value" in arrays) == (layout == "scan")
    tmod = coldstart.materialize(coldstart.abstract_construct(lambda: dinov2.DINOv2Encoder(**kw)), arrays=arrays,
                                 device="cpu").eval()
    t_in, j_in = _inputs(_image(12, 84, 70, b=1))
    got, want = tmod(t_in), _jax_forward(jmod, j_in)
    _close(got.features, want.features)
    _close(got.registers, want.registers)
