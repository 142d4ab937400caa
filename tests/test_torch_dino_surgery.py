"""
The DINOv2 -> info-sharing composition against the JAX package on the CPU: the global- and alternating-attention
transformers with the block options that DINOv2 blocks need (LayerScale, qk-norm, SwiGLU-fused FFN, stochastic
depth and dropout in eval mode), the info-sharing registry, the surgery (``convert_dino_to_info_sharing``: the
same keys and arrays as the JAX script, its file and metadata, its check), and the slice as a whole: DINOv2-S with
registers -> its intermediate features -> a global transformer initialised from its later blocks, over two views.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models import info_sharing as jinfo
from uniception_tpu.models.encoders import dinov2 as jdinov2
from uniception_tpu.models.encoders.base import ViTEncoderInput as JaxInput
from uniception_tpu.models.info_sharing import alternating_attention_transformer as jalt
from uniception_tpu.models.info_sharing import global_attention_transformer as jglobal
from uniception_tpu.models.info_sharing.base import MultiViewTransformerInput as JaxViewInput
from uniception_tpu.nn import blocks as jblocks
from uniception_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from uniception_tpu.utils.torch_compat import load_torch_state_dict
from uniception_tpu_torch import convert_dino_to_info_sharing as surgery
from uniception_tpu_torch.models import info_sharing
from uniception_tpu_torch.models.encoders import dinov2
from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
from uniception_tpu_torch.models.info_sharing import alternating_attention_transformer as alt
from uniception_tpu_torch.models.info_sharing import global_attention_transformer as glob
from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
from uniception_tpu_torch.nn import blocks
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_dinov2 import _randomize
from tests.test_torch_multiview import _carry, _jax_forward, _same_outputs, _view_inputs
from tests.test_torch_quant import jax_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 5e-5  # fp32 max abs per component, the repo's parity bar
# DINOv2-S with registers, 4 blocks: blocks 0-1 run in the encoder, blocks 2-3 become the info sharing
ENCODER = dict(name="dinov2", size="small", with_registers=True, keep_first_n_layers=4)
START, END = 2, 4


def _jax_script():
    "The JAX package's scripts/convert_dino_to_info_sharing.py, loaded by its path (scripts/ is not a package)."
    spec = importlib.util.spec_from_file_location("jax_convert_dino", os.path.join(REPO, "scripts",
                                                                                   "convert_dino_to_info_sharing.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    "Two intra-op threads: small CPU modules in several test workers (see tests/test_torch_training_paths.py)."
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# the block options the transformers once refused, in two groups: what a DINOv2-initialised transformer carries, and the
# training-time ones (dropout, stochastic depth) that are identities in eval mode; act_layer is accepted and, as in
# the JAX package, not passed to the blocks
OPTION_GROUPS = {
    "layerscale+qk_norm+swiglu": (dict(init_values=0.5, qk_norm=True), True, False),
    "drops+act_layer (eval)": (dict(init_values=1.0, drop_path=0.2, proj_drop=0.1, attn_drop=0.1), False, True),
}  # (options, SwiGLUFFNFused as mlp_layer, ReLU as act_layer)


@pytest.mark.parametrize("kind", ["global", "alternating"])
@pytest.mark.parametrize("group", sorted(OPTION_GROUPS))
def test_info_sharing_with_block_options_matches_jax(kind, group):
    opts, swiglu, relu = OPTION_GROUPS[group]
    kw = dict(name="g", input_embed_dim=32, dim=48, depth=2, num_heads=4,
              use_rand_idx_pe_for_non_reference_views=False, **opts)
    jkw, tkw = dict(kw), dict(kw)
    if swiglu:
        jkw["mlp_layer"], tkw["mlp_layer"] = jblocks.SwiGLUFFNFused, blocks.SwiGLUFFNFused
    if relu:
        jkw["act_layer"], tkw["act_layer"] = jax.nn.relu, torch.relu
    jcls = (jglobal.MultiViewGlobalAttentionTransformer if kind == "global"
            else jalt.MultiViewAlternatingAttentionTransformer)
    tcls = glob.MultiViewGlobalAttentionTransformer if kind == "global" else alt.MultiViewAlternatingAttentionTransformer
    jmod, tmod = _carry(lambda: jcls(rngs=nnx.Rngs(0), **jkw), tcls(generator=torch.Generator().manual_seed(1), **tkw))
    jmod.eval()
    t_in, j_in = _view_inputs(np.random.RandomState(4))
    with torch.no_grad():
        out = tmod(t_in)
    _same_outputs(out, _jax_forward(jmod, j_in, None))


def test_info_sharing_registry_matches_jax():
    assert sorted(info_sharing.INFO_SHARING_CLASSES) == sorted(jinfo.INFO_SHARING_CLASSES)
    for name, (cls, ifr) in info_sharing.INFO_SHARING_CLASSES.items():
        jcls, jifr = jinfo.INFO_SHARING_CLASSES[name]
        if name == "diff_cross_attention":
            for c in (cls, ifr):
                with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
                    c(name="d", input_embed_dim=32)
            continue
        assert (cls.__name__, ifr.__name__) == (jcls.__name__, jifr.__name__)
        assert issubclass(ifr, cls)


def _dino_state(seed=0):
    "A seeded DINOv2-S-reg encoder state, 4 blocks, as numpy arrays under the encoder's ``model.*`` keys."
    return _randomize(dinov2.DINOv2Encoder(**ENCODER), seed)


@pytest.mark.parametrize("layout", ["uniception", "hub"])
def test_surgery_convert_matches_jax(layout):
    state = _dino_state()
    if layout == "hub":
        state = {k[len("model."):]: v for k, v in state.items()}
    ours, ref = surgery.convert(state, START, END), _jax_script().convert(state, START, END)
    assert list(ours) == list(ref)
    assert all(ours[k] is ref[k] for k in ref)  # the same arrays, under the same keys
    want = {"norm.weight", "norm.bias"}
    for i in range(END - START):
        prefix = f"model.blocks.{START + i}."
        want |= {f"self_attention_blocks.{i}.{k[len(prefix):]}" for k in _dino_state() if k.startswith(prefix)}
    assert set(ours) == want and len(want) == 2 + 2 * 14  # 14 tensors per block: norms, qkv, proj, ls, fc


def _surgery_file(tmp_path, capsys):
    "A DINOv2 .pth of the seeded state -> the port's surgery CLI -> (the .npz path, the encoder state)."
    state = {k: torch.from_numpy(v) for k, v in _dino_state().items()}
    pth, npz = str(tmp_path / "dinov2.pth"), str(tmp_path / "info_sharing.npz")
    torch.save({"model": state}, pth)
    surgery.main([pth, npz, "--start", str(START), "--end", str(END)])
    assert "verification: missing=0 unexpected=0" in capsys.readouterr().out
    return npz, state


def test_surgery_cli_writes_what_the_jax_script_writes(tmp_path, capsys, monkeypatch):
    "The port's file and the JAX script's, from one .pth: the same arrays and metadata, read by either package."
    npz, _ = _surgery_file(tmp_path, capsys)
    jnpz = str(tmp_path / "jax_info_sharing.npz")
    monkeypatch.setattr(sys, "argv", ["convert", str(tmp_path / "dinov2.pth"), jnpz, "--start", str(START), "--end",
                                      str(END), "--skip_verify"])
    _jax_script().main()
    ours, ref = load_checkpoint(npz), jax_load_checkpoint(jnpz)
    assert {k: v for k, v in ours.items() if k != "model"} == {k: v for k, v in ref.items() if k != "model"} == {
        "source": "dinov2_surgery", "start": START, "end": END}
    assert sorted(ours["model"]) == sorted(ref["model"])
    assert all(np.array_equal(ours["model"][k], ref["model"][k]) for k in ref["model"])


def test_surgery_check_reports_what_does_not_load():
    "A plain-MLP transformer's state checked as a DINOv2 one: the missing LayerScale keys are reported."
    state = {k: v.numpy() for k, v in glob.MultiViewGlobalAttentionTransformer(
        name="g", input_embed_dim=128, dim=128, depth=1, num_heads=2).state_dict().items()}
    assert surgery.verify(state, 1) == ([], [])
    state["self_attention_blocks.0.ls1.gamma"] = np.ones(128, np.float32)
    missing, unexpected = surgery.verify(state, 1)
    assert missing == ["self_attention_blocks.0.ls2.gamma"] and unexpected == []
    state["norm.weight"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="Shape mismatch for norm.weight"):
        surgery.verify(state, 1)


def test_dinov2_ifr_then_surgery_initialised_global_attention_matches_jax(tmp_path, capsys):
    """The slice as a whole: DINOv2-S-reg's pre-norm tokens after block 1 (its IFR) for two views of 56 x 70, then a
    2-deep global transformer (384 wide, LayerScale) initialised by the surgery from blocks 2-3, loaded strict from
    the file, in both packages."""
    npz, state = _surgery_file(tmp_path, capsys)
    ifr_kw = dict(ENCODER, indices=[START - 1], norm_intermediate=False)
    tenc = dinov2.DINOv2IntermediateFeatureReturner(**ifr_kw).eval()
    tenc.load_state_dict(state)
    jenc = jax_module(lambda: jdinov2.DINOv2IntermediateFeatureReturner(rngs=nnx.Rngs(0), **ifr_kw))
    load_torch_state_dict(jenc, {k: v.numpy() for k, v in state.items()}, verbose=False)
    gkw = dict(name="surgery", input_embed_dim=384, dim=384, depth=END - START, num_heads=6, init_values=1.0,
               use_rand_idx_pe_for_non_reference_views=False, pretrained_checkpoint_path=npz)
    tglob = glob.MultiViewGlobalAttentionTransformer(**gkw).eval()
    jglob = jglobal.MultiViewGlobalAttentionTransformer(rngs=nnx.Rngs(0), **gkw)

    rng = np.random.RandomState(5)
    views = [rng.randn(1, 3, 56, 70).astype(np.float32) for _ in range(2)]
    with torch.no_grad():
        tfeat = [tenc(ViTEncoderInput(image=torch.from_numpy(v), data_norm_type="dinov2"))[0].features for v in views]
        out = tglob(MultiViewTransformerInput(features=tfeat))
    jfeat = [_jax_forward(jenc, JaxInput(image=jnp.asarray(v), data_norm_type="dinov2"))[0].features for v in views]
    for t, j in zip(tfeat, jfeat):
        assert tuple(t.shape) == (1, 384, 4, 5)
        assert np.abs(t.numpy() - np.asarray(j)).max() <= TOL
    ref = _jax_forward(jglob, JaxViewInput(features=jfeat), None)
    _same_outputs(out, ref)
