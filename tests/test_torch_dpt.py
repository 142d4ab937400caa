"""
The port's DPT head path against the JAX package on the CPU: the plain
version of the 3x3 conv kernel (K7) against the Pallas kernel in interpret
mode, DPTFeature + DPTRegressionProcessor with weights carried across, a small
DUSt3R-DPT end to end (fp32, and int8-quantized on both sides), its state-dict
keys against the JAX export, and the int8 DPT serving model built by
serve.build_model on the CPU. Inputs come from numpy.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.prediction_heads.base import PredictionHeadLayeredInput as JaxLayeredInput
from uniception_tpu.nn.quant import quantize_trunk as jax_quantize_trunk
from uniception_tpu.ops.conv3x3 import conv3x3_nhwc as jax_conv3x3_nhwc
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch import serve
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.prediction_heads.base import PredictionHeadLayeredInput
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn.quant import Int8Linear, quantize_trunk
from uniception_tpu_torch.ops.conv3x3 import conv3x3_nhwc, conv3x3_reference
from uniception_tpu_torch.ops.flash_attention import flash_attention, flash_attention_int8
from uniception_tpu_torch.ops.int8_matmul import int8_matmul_dynamic
from uniception_tpu_torch.utils.weights import load_state_dict_numpy
from tests.test_torch_quant import jax_module

TOL = 5e-5  # fp32 max abs, the repo's parity bar
ENC = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4)
DEC = dict(info_sharing_dim=48, info_sharing_depth=2, info_sharing_num_heads=4)


def _composed_tol(ref):
    "exp adaptors scale errors with the output: 1e-4 * max(1, max|ref|) for composed models."
    return 1e-4 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _carry(jax_ctor, tmod, seed=0):
    """The JAX module of ``jax_ctor`` with the port module's weights: the
    port's seeded init, every bias (zero at init) given random values, loaded
    into the JAX module (built with zeros) through the JAX package's
    torch-layout loader. Returns (JAX module, port module)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in tmod.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    jmod = jax_module(jax_ctor)
    load_torch_state_dict(jmod, {k: v.float().numpy() for k, v in tmod.state_dict().items()}, verbose=False)
    return jmod, tmod.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_plain_version_matches_pallas_interpret(dtype, bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 10, 128).astype(np.float32)
    w = (rng.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    b = rng.randn(128).astype(np.float32) if bias else None
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    ref = np.asarray(jax_conv3x3_nhwc(jx, jw, None if b is None else jnp.asarray(b), block_h=4, interpret=True)
                     .astype(jnp.float32))
    tx, tw = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w).to(getattr(torch, dtype))
    tb = None if b is None else torch.from_numpy(b)
    out = conv3x3_reference(tx, tw, tb)
    assert out.dtype == tx.dtype and out.shape == (2, 6, 10, 128)
    got = out.float().numpy()
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-4  # fp32 sums of 1152 products in another order
    else:  # one bf16 rounding of fp32 sums: 1 ulp of max(|ref|, 1/16)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1 / 16))) - 7)
        assert (np.abs(got - ref) / ulp).max() <= 1
    before = conv3x3_nhwc.launches
    assert torch.equal(conv3x3_nhwc(tx, tw, tb), out)  # a CPU tensor: the plain version
    assert conv3x3_nhwc.launches == before


@pytest.fixture(scope="module")
def dust3r_pair():
    "A small DUSt3R-DPT in both packages with the same weights."
    kw = dict(name="dpt_small", img_size=(32, 48), pred_head_type="dpt", pred_head_feature_dim=32, **ENC, **DEC)
    return _carry(lambda: JaxDUSt3R(rngs=nnx.Rngs(0), **kw), DUSt3R(generator=torch.Generator().manual_seed(0), **kw),
                  seed=4)


def test_dpt_feature_and_regressor_match_jax(dust3r_pair):
    """The heads of the pair on four random hook features at a 2 x 3 token
    grid (refinenet4's 2 x 4 output is cropped to 2 x 3), regressed to 32 x 48."""
    jmod, tmod = dust3r_pair
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, c, 2, 3).astype(np.float32) for c in (64, 48, 48, 48)]

    @nnx.jit  # one compile: a tenth of the eager ops' compile time here
    def jax_head(feature_head, regressor, feats):
        out = feature_head(JaxLayeredInput(list_features=feats, target_output_shape=(32, 48)))
        return out.features_upsampled_8x, regressor(out).decoded_channels

    feat8, ref = jax_head(jmod.dpt_feature_head1, jmod.dpt_regressor_head1, [jnp.asarray(f) for f in feats])
    feat8, ref = np.asarray(feat8), np.asarray(ref)
    with torch.no_grad():
        tout = tmod.dpt_feature_head1(PredictionHeadLayeredInput(list_features=[torch.from_numpy(f) for f in feats],
                                                                 target_output_shape=(32, 48)))
        out = tmod.dpt_regressor_head1(tout).decoded_channels.numpy()
    assert tuple(tout.features_upsampled_8x.shape) == feat8.shape == (2, 32, 16, 24)
    assert np.abs(tout.features_upsampled_8x.numpy() - feat8).max() <= TOL
    assert out.shape == ref.shape == (2, 4, 32, 48)
    assert np.abs(out - ref).max() <= TOL


@pytest.mark.parametrize("trunk", ["fp32", "int8"])
def test_dust3r_dpt_forward_pair_matches_jax(dust3r_pair, trunk):
    jmod, tmod = dust3r_pair
    if trunk == "int8":  # every trunk linear, symmetric dynamic, on both sides
        jmod, tmod = nnx.clone(jmod), copy.deepcopy(tmod)
        n = jax_quantize_trunk(jmod, "all", min_params=1)
        assert quantize_trunk(tmod, "all", min_params=1) == n > 0
    rng = np.random.RandomState(5)
    img1, img2 = (rng.randn(2, 3, 32, 48).astype(np.float32) for _ in range(2))
    # jitted (one compile), the JAX int8 layers multiply by 1/127 where the port divides, as eager JAX
    # does: a scale one ulp apart moves no code at these inputs
    ref1, ref2 = nnx.jit(lambda m, a, b: m.forward_pair(a, b))(jmod, jnp.asarray(img1), jnp.asarray(img2))
    with torch.no_grad():
        out1, out2 = tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2))
    for out, ref in ((out1, ref1), (out2, ref2)):
        assert sorted(out) == sorted(ref)
        for key in ref:
            got, want = out[key].numpy(), np.asarray(ref[key])
            assert got.shape == want.shape and np.isfinite(got).all()
            assert np.abs(got - want).max() <= _composed_tol(want), key


def test_dpt_state_dict_keys_match_jax_export(dust3r_pair):
    jmod, tmod = dust3r_pair
    exported = state_dict_from_module(jmod)
    assert sorted(tmod.state_dict()) == sorted(exported)
    for key, value in tmod.state_dict().items():
        assert tuple(value.shape) == exported[key].shape, key
    assert tmod.checkpoint_alias_patterns() == jmod.checkpoint_alias_patterns()
    # and the JAX -> port route gives back the port's weights (convs OIHW, the transposed convs flipped twice)
    fresh = DUSt3R(name="dpt_small", img_size=(32, 48), pred_head_type="dpt", pred_head_feature_dim=32, **ENC, **DEC)
    load_state_dict_numpy(fresh, exported)
    own = tmod.state_dict()
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, own[key]), key


def test_int8_dpt_serving_model_runs_on_cpu():
    """The int8 DPT rung of serve.build_model (int8 trunk, int8 attention, bf16
    heads with the conv3x3 kernel selected) on the CPU: the plain versions,
    finite outputs, no kernel launched, bf16 head parameters."""
    dims = dict(enc_depth=1, enc_dim=64, enc_heads=4, dec_depth=2, dec_dim=48, dec_heads=4)
    model = serve.build_model(32, **dims, device="cpu", head="dpt", head_dtype=torch.bfloat16, int8=True)
    assert model.dpt_feature_head1.scratch.refinenet1.out_conv.weight.dtype == torch.bfloat16
    assert not any(isinstance(m, Int8Linear) for m in model.modules())  # every linear is below 2^16 weights here
    quantize_trunk(model, "all", min_params=1)
    kernels = (flash_attention, flash_attention_int8, int8_matmul_dynamic, conv3x3_nhwc)
    before = [k.launches for k in kernels]
    frames = np.random.RandomState(6).randint(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    config.set_attention_quant("int8")
    config.set_conv3x3_impl("kernel")
    try:
        outs = serve.make_serving_fn(model, "cpu")(frames[:1], frames[1:])
    finally:
        config.set_attention_quant("none")
        config.set_conv3x3_impl("torch")
    assert [tuple(o.shape) for o in outs] == [(1, 32, 32, 3), (1, 32, 32, 1)] * 2
    assert all(o.dtype == torch.float32 and torch.isfinite(o).all() for o in outs)
    assert [k.launches for k in kernels] == before
