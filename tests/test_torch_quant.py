"""
The port's int8 serving path (uniception_tpu_torch/nn/quant.py and the plain
version of the int8 matmul kernel, ops/int8_matmul.py) against the JAX
package on the CPU: the weight quantizer, Int8Linear in its three activation
modes, the fused-quant matmul against the Pallas kernel in interpret mode,
the trunk policies and their dotted paths, quantize_trunk on a small DUSt3R,
and quantized trunks carried from the JAX package into the port. Inputs come
from numpy.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.nn.blocks import SelfAttentionBlock as JaxSelfAttentionBlock
from uniception_tpu.nn.common import LinearX as JaxLinearX
from uniception_tpu.nn.quant import Int8Linear as JaxInt8Linear
from uniception_tpu.nn.quant import quantize_int8 as jax_quantize_int8
from uniception_tpu.nn.quant import quantize_linears as jax_quantize_linears
from uniception_tpu.nn.quant import quantize_trunk as jax_quantize_trunk
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.nn.blocks import SelfAttentionBlock
from uniception_tpu_torch.nn.common import LinearX
from uniception_tpu_torch.nn.quant import Int8Linear, quantize_int8, quantize_linears, quantize_trunk, trunk_policy
from uniception_tpu_torch.ops.int8_matmul import int8_matmul_dynamic, int8_matmul_dynamic_ref
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

TOL = 1e-5  # the JAX package's own bar between its int8 paths (tests/ops/test_int8_matmul_interpret.py)
SMALL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=64, info_sharing_depth=2,
             info_sharing_num_heads=4)


def jax_module(ctor):
    """The JAX module ``ctor()`` builds, with every array zero (random keys
    from 0): built from its abstract shapes, so no initializer is compiled,
    for tests that load or count weights rather than use the initial ones."""
    graphdef, state = nnx.split(nnx.eval_shape(ctor))

    def zeros(s):
        if jax.dtypes.issubdtype(s.dtype, jax.dtypes.prng_key):
            return jax.random.key(0)
        return jnp.asarray(np.zeros(s.shape, s.dtype))

    return nnx.merge(graphdef, jax.tree.map(zeros, state))


@pytest.fixture(autouse=True)
def _xla_int8(monkeypatch):
    "The JAX Int8Linear takes its XLA path unless a test asks for the Pallas kernel in interpret mode."
    monkeypatch.delenv("UNICEPTION_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("UNICEPTION_TPU_INT8_MATMUL", raising=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_codes_match_jax(dtype):
    w = np.random.RandomState(0).randn(96, 160).astype(np.float32)
    jw, tw = jnp.asarray(w).astype(dtype), torch.from_numpy(w).to(getattr(torch, dtype))
    for axis in (0, 1):
        jq, js = jax_quantize_int8(jw, axis=axis)
        tq, ts = quantize_int8(tw, axis=axis)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _linear_pair(k, n, seed=0):
    "A JAX LinearX and the port's LinearX holding the same weights."
    jlin = JaxLinearX(k, n, rngs=nnx.Rngs(seed))
    rng = np.random.RandomState(seed)
    jlin.bias[...] = jnp.asarray(rng.randn(n).astype(np.float32) * 0.1)  # a non-zero bias
    tlin = LinearX(k, n)
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(np.asarray(jlin.kernel[...]).T.copy()))
        tlin.bias.copy_(torch.from_numpy(np.array(jlin.bias[...])))
    return jlin, tlin


@pytest.mark.parametrize("mode", ["dynamic", "zero-point", "static"])
def test_int8_linear_matches_jax(mode):
    jlin, tlin = _linear_pair(256, 200)
    if mode == "static":
        jq0 = JaxInt8Linear.from_linear(jlin)
        jq = JaxInt8Linear(jq0.w_q[...], jq0.w_scale[...], jq0.bias[...], a_scale=0.031)
        tq0 = Int8Linear.from_linear(tlin)
        tq = Int8Linear(tq0.w_q.t(), tq0.w_scale, tq0.bias, a_scale=0.031)
    else:
        jq = JaxInt8Linear.from_linear(jlin, asym=mode == "zero-point")
        tq = Int8Linear.from_linear(tlin, asym=mode == "zero-point")
    rng = np.random.RandomState(1)
    x = rng.randn(2, 65, 256).astype(np.float32)
    x[..., :128] = np.maximum(x[..., :128], 0) * 1.5  # one-sided channels, where zero-point pays
    ref = np.asarray(jq(jnp.asarray(x)))
    out = tq(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    # the state dict is the JAX module's: keys, (in, out) codes, (1, out) scales
    exported, own = state_dict_from_module(jq), tq.state_dict()
    assert sorted(own) == sorted(exported)
    for key, value in exported.items():
        np.testing.assert_array_equal(own[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("m,n,bias", [(40, 200, True), (9, 136, False)])
def test_int8_matmul_plain_version_matches_pallas_interpret(monkeypatch, m, n, bias):
    "The kernel's plain version against the Pallas kernel in interpret mode at K = 4096, M and N off its tiles."
    from uniception_tpu.ops.int8_matmul import int8_matmul_dynamic as jax_int8_matmul_dynamic

    monkeypatch.setenv("UNICEPTION_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(2)
    x = rng.randn(m, 4096).astype(np.float32)
    w_q = rng.randint(-127, 128, size=(4096, n)).astype(np.int8)
    w_scale = (rng.rand(1, n) * 1e-3 + 1e-5).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if bias else None
    ref = np.asarray(jax_int8_matmul_dynamic(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
                                             None if b is None else jnp.asarray(b), block_m=32, block_n=128))
    args = tuple(None if a is None else torch.from_numpy(a) for a in (x, w_q, w_scale, b))
    out = int8_matmul_dynamic_ref(*args)
    # the Pallas kernel's jitted body multiplies by 1/127 where the port divides by 127; a scale one
    # ulp apart moves no code at these inputs, so the two agree to fp32 rounding
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    before = int8_matmul_dynamic.launches
    torch.testing.assert_close(int8_matmul_dynamic(*args), out, rtol=0, atol=0)  # a CPU tensor: the plain version
    assert int8_matmul_dynamic.launches == before


SPECS = ["all", "none", "enc.*", "dec.*", "*.mlp", "*.fc2", "enc.*,dec.mlp", "*.qkv,*.mlp", "dec.cross", "dec.proj"]


@pytest.fixture(scope="module")
def small_pair():
    "A small DUSt3R in both packages: the layer tree is what counts, not the weights."
    kw = dict(name="p", img_size=(32, 32), patch_embed_cls="ManyAR_PatchEmbed", **SMALL)
    return jax_module(lambda: JaxDUSt3R(rngs=nnx.Rngs(0), **kw)), DUSt3R(**kw)


@pytest.mark.parametrize("spec", SPECS)
def test_trunk_policy_counts_match_jax(small_pair, spec):
    jmod, tmod = nnx.clone(small_pair[0]), copy.deepcopy(small_pair[1])
    want = jax_quantize_trunk(jmod, spec, min_params=1)
    assert quantize_trunk(tmod, spec, min_params=1) == want
    assert sum(isinstance(m, Int8Linear) for m in tmod.modules()) == want


@pytest.mark.parametrize("spec", ["bogus", "enc.nosuchlayer", "xyz.fc1"])
def test_trunk_policy_rejects_bad_specs(spec):
    with pytest.raises(ValueError):
        trunk_policy(spec)


def test_quantize_linears_dotted_paths_match_jax():
    "The predicate sees the JAX package's dotted paths, and a path filter skips what it names."
    jseen, tseen = [], []
    jblk = jax_module(lambda: JaxSelfAttentionBlock(dim=128, num_heads=4, mlp_ratio=2.0, rngs=nnx.Rngs(0)))
    tblk = SelfAttentionBlock(dim=128, num_heads=4, mlp_ratio=2.0)
    n_j = jax_quantize_linears(jblk, min_params=1, predicate=lambda p, lin: jseen.append(p) or True)
    n_t = quantize_linears(tblk, min_params=1, predicate=lambda p, lin: tseen.append(p) or True)
    assert n_t == n_j == 4 and sorted(tseen) == sorted(jseen)
    tblk2 = SelfAttentionBlock(dim=128, num_heads=4, mlp_ratio=2.0)
    assert quantize_linears(tblk2, min_params=1, predicate=lambda p, lin: not p.endswith("qkv")) == 3
    assert isinstance(tblk2.attn.qkv, torch.nn.Linear) and isinstance(tblk2.attn.proj, Int8Linear)


def _wide_dust3r_pair():
    """A JAX and a port DUSt3R with the same weights (the port's seeded init,
    loaded into a JAX model built with zeros), wide enough that min_params =
    2^16 keeps some linears unquantized."""
    kw = dict(name="q", img_size=(32, 32), patch_embed_cls="ManyAR_PatchEmbed", enc_embed_dim=256, enc_depth=1,
              enc_num_heads=4, info_sharing_dim=128, info_sharing_depth=2, info_sharing_num_heads=4)
    tmod = DUSt3R(generator=torch.Generator().manual_seed(0), **kw).eval()
    jmod = jax_module(lambda: JaxDUSt3R(rngs=nnx.Rngs(0), **kw))
    load_torch_state_dict(jmod, {k: v.numpy() for k, v in tmod.state_dict().items()}, verbose=False)
    return jmod, tmod, kw


def test_quantized_trunk_carries_from_jax():
    """A trunk quantized in the JAX package, exported and loaded into the port,
    equals the port's own quantization of the same weights: the same codes
    and scales (w_q loads from the (in, out) export) and the same outputs."""
    jmod, tmod, kw = _wide_dust3r_pair()
    n = jax_quantize_trunk(jmod, "all", asym="dec.fc2")
    # at the default size threshold (2^16 weights): the encoder's qkv, proj, fc1, fc2 and the decoder's
    # fc1, fc2 (128 x 512) of 2 x 2 blocks; its qkv (128 x 384), other projections and proj_embed stay float
    assert n == 4 + 8
    assert quantize_trunk(tmod, "all", asym="dec.fc2") == n
    carried = DUSt3R(**kw).eval()
    quantize_trunk(carried, "all", asym="dec.fc2")  # the module tree the export fills
    exported = state_dict_from_module(jmod)
    assert sorted(carried.state_dict()) == sorted(exported)
    load_state_dict_numpy(carried, exported)
    own = tmod.state_dict()
    for key, value in carried.state_dict().items():
        assert torch.equal(value, own[key]), key
    img = torch.from_numpy(np.random.RandomState(3).randn(1, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        a, b = carried.forward_pair(img, img), tmod.forward_pair(img, img)
    for ra, rb in zip(a, b):
        for key in ra:
            assert torch.equal(ra[key], rb[key]), key
