"""
The port's int8 attention (the plain version of K6,
``flash_attention_int8_ref``, and the dispatch of ops/attention.py) against the
JAX package's Pallas int8 kernel in interpret mode on the CPU, both modes: at
N = 64, a ragged N = 36 and Nq != Nk; its invariance to shifting every key;
and the rule that decides between K6 and K1, against the JAX package's tile
plan. Inputs come from numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniception_tpu.models.utils.config import set_attention_quant as jax_set_attention_quant
from uniception_tpu.ops.flash_attention import _plan as jax_plan
from uniception_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention, single_key_block, uses_int8_attention
from uniception_tpu_torch.ops.flash_attention import (
    flash_attention_int8,
    flash_attention_int8_ref,
    flash_attention_ref,
)

# Against the Pallas kernel: the same bf16 inputs, the same quantization; the
# k mean is summed in another order and the jitted kernel multiplies by 1/127
# where the port divides, so a scale may differ in its last bit and move a
# code, and the output is rounded to bf16. So nearly every output is within
# one bf16 ulp of the kernel's (ulps of max(|ref|, 1/64)); a moved code moves a
# few rows further. Measured: at most 0.35% of outputs more than 1 ulp away,
# 0.26% more than 2, max abs 5.9e-3. Exact attention, or the other int8 mode,
# is more than 1 ulp away on over 50% of them (checked as a control).
ULP_FLOOR = 1 / 64
FAR_SHARE = {1: 1e-2, 2: 5e-3}  # ulps -> the largest share of outputs further than that
JAX_TOL = 8e-3  # max abs
EXACT_TOL = {"int8": 2e-2, "int8pv": 3e-2}  # relative to exact attention: the JAX package's bound


@pytest.fixture(autouse=True)
def _quant_mode(monkeypatch):
    monkeypatch.setenv("UNICEPTION_TPU_PALLAS_INTERPRET", "1")
    yield
    jax_set_attention_quant("none")
    config.set_attention_quant("none")


def _qkv(b, nq, nk, h, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, h, 64).astype(np.float32) for n in (nq, nk, nk)]


def _far_share(out, ref, ulps):
    "The share of outputs more than ``ulps`` bf16 ulps of max(|ref|, ULP_FLOOR) from ref."
    ref = torch.from_numpy(np.array(ref, dtype=np.float32))
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(ULP_FLOOR))) - 7)
    return ((out.float() - ref).abs() > ulps * ulp).float().mean().item()


def _agrees_with_pallas(out, ref):
    return all(_far_share(out, ref, n) <= share for n, share in FAR_SHARE.items())


def _bf16(arrays):
    "The same bf16 values for both packages."
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays], [torch.from_numpy(a).bfloat16() for a in arrays]


@pytest.mark.parametrize("mode", ["int8", "int8pv"])
@pytest.mark.parametrize("b,nq,nk,h", [(1, 64, 64, 2), (2, 36, 36, 2), (1, 20, 50, 3)])
def test_int8_plain_version_matches_pallas_interpret(b, nq, nk, h, mode):
    (jq, jk, jv), (q, k, v) = _bf16(_qkv(b, nq, nk, h, seed=nq))
    jax_set_attention_quant(mode)
    ref = np.asarray(jax_flash_attention(jq, jk, jv).astype(jnp.float32))
    out = flash_attention_int8_ref(q, k, v, mode=mode)
    assert out.dtype == torch.bfloat16 and out.shape == (b, nq, h, 64)
    assert _agrees_with_pallas(out, ref), [_far_share(out, ref, n) for n in FAR_SHARE]
    assert np.abs(out.float().numpy() - ref).max() <= JAX_TOL
    exact = flash_attention_ref(q.float(), k.float(), v.float())
    assert ((out.float() - exact).norm() / exact.norm()).item() < EXACT_TOL[mode]
    # controls: exact bf16 attention and the other int8 mode are told apart from the kernel's output
    other = flash_attention_int8_ref(q, k, v, mode="int8pv" if mode == "int8" else "int8")
    for control in (flash_attention_ref(q, k, v), other):
        assert not _agrees_with_pallas(control, ref)
    # a CPU tensor through the kernel's wrapper is the plain version
    before = flash_attention_int8.launches
    assert torch.equal(flash_attention_int8(q, k, v, mode=mode), out)
    assert flash_attention_int8.launches == before


@pytest.mark.parametrize("mode", ["int8", "int8pv"])
def test_int8_attention_is_invariant_to_shifting_the_keys(mode):
    "A constant added to every key shifts each row's logits by a constant: the mean smoothing removes it."
    _, (q, k, v) = _bf16(_qkv(1, 64, 64, 2, seed=1))
    base = flash_attention_int8_ref(q, k, v, mode=mode).float()
    shifted = flash_attention_int8_ref(q, k + 3.0, v, mode=mode).float()
    torch.testing.assert_close(shifted, base, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("nq,nk,d", [(64, 64, 64), (1024, 1024, 64), (1000, 1025, 64), (7, 1024, 64), (4096, 2048, 64),
                                     (100, 300, 512), (2048, 1024, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_single_key_block_matches_the_jax_plan(nq, nk, d, dtype):
    shape = (1, nq, 2, d)
    plan = jax_plan(jnp.zeros(shape, dtype), jnp.zeros((1, nk, 2, d), dtype), None, 1024, 1024)
    bk, nk_pad = plan[-3], plan[-1]
    assert single_key_block(shape, nk, getattr(torch, dtype)) == (nk_pad == bk)


def test_dispatch_takes_int8_only_where_the_jax_package_does():
    "int8 for single-block inference calls in bf16; fp32, a gradient, or Nk > 1024 keep the float path."
    _, (q, k, v) = _bf16(_qkv(1, 48, 48, 2, seed=2))
    long_k = torch.randn(1, 1030, 2, 64).bfloat16()
    config.set_attention_quant("int8pv")
    assert uses_int8_attention(q, k, v)
    torch.testing.assert_close(scaled_dot_product_attention(q, k, v), flash_attention_int8_ref(q, k, v, mode="int8pv"),
                               rtol=0, atol=0)
    assert not uses_int8_attention(q.float(), k.float(), v.float())
    assert not uses_int8_attention(q, long_k, long_k)
    qg = q.clone().requires_grad_()
    assert not uses_int8_attention(qg, k, v)
    with torch.no_grad():
        assert uses_int8_attention(qg, k, v)
    torch.testing.assert_close(scaled_dot_product_attention(q.float(), k.float(), v.float()),
                               flash_attention_ref(q.float(), k.float(), v.float()), rtol=0, atol=0)
    config.set_attention_quant("none")
    assert not uses_int8_attention(q, k, v)
