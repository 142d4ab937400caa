"""
The two shape routes of the port's attention dispatch against the JAX
package's ``scaled_dot_product_attention`` on the same numpy inputs, in
float32 on the CPU: Dv != Dq (the explicit einsum path, which the JAX package
takes on every implementation) and grouped-query shapes (key/value heads
shared by groups of query heads, ``jax.nn.dot_product_attention``'s grouping).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniception_tpu.ops.attention import scaled_dot_product_attention as jax_sdpa
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.ops.attention import expand_kv_heads, scaled_dot_product_attention
from uniception_tpu_torch.ops.flash_attention import flash_attention

TOL = 5e-5  # max abs, float32: the same products and softmax summed in another order


def _inputs(b, nq, nk, hq, hk, dq, dv, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, nq, hq, dq).astype(np.float32), rng.randn(b, nk, hk, dq).astype(np.float32),
            rng.randn(b, nk, hk, dv).astype(np.float32))


def _both(arrays, scale, impl):
    ref = np.asarray(jax_sdpa(*(jnp.asarray(a) for a in arrays), scale=scale))
    out = scaled_dot_product_attention(*(torch.from_numpy(a) for a in arrays), scale=scale, impl=impl)
    return out, ref


@pytest.mark.parametrize("impl", ["kernel", "fused", "naive"])
@pytest.mark.parametrize("b,nq,nk,h,dq,dv,scale", [(2, 9, 9, 2, 32, 64, None), (1, 7, 13, 3, 64, 128, 0.3)])
def test_value_head_dim_other_than_query_matches_jax(impl, b, nq, nk, h, dq, dv, scale):
    out, ref = _both(_inputs(b, nq, nk, h, h, dq, dv, seed=nq), scale, impl)
    assert out.shape == ref.shape == (b, nq, h, dv) and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= TOL


@pytest.mark.parametrize("impl", ["kernel", "naive"])
@pytest.mark.parametrize("b,nq,nk,hq,hk", [(2, 10, 10, 8, 2), (1, 5, 17, 6, 3), (1, 4, 4, 4, 1)])
def test_grouped_query_shapes_match_jax(impl, b, nq, nk, hq, hk):
    before = flash_attention.launches
    out, ref = _both(_inputs(b, nq, nk, hq, hk, 64, 64, seed=hq), None, impl)
    assert out.shape == ref.shape == (b, nq, hq, 64)
    assert np.abs(out.numpy() - ref).max() <= TOL
    assert flash_attention.launches == before  # the CPU takes the plain version


def test_grouped_query_grouping_and_refusal():
    "Query head h reads key head h // (H_q / H_k); a head count that does not divide raises."
    k = torch.arange(3.0).reshape(1, 1, 3, 1).expand(1, 2, 3, 4)
    assert expand_kv_heads(6, k)[0, 0, :, 0].tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
    with pytest.raises(ValueError, match="multiple"):
        expand_kv_heads(4, k)
    q = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="multiple"):
        scaled_dot_product_attention(q, k, k)


def test_grouped_query_route_keeps_the_int8_rule():
    "Under an int8 quant mode a grouped-query bf16 inference call goes to the int8 path on its expanded heads."
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 16, 16, 4, 2, 64, 64, seed=3))
    config.set_attention_quant("int8")
    try:
        out = scaled_dot_product_attention(q, k, v)
        want = scaled_dot_product_attention(q, expand_kv_heads(4, k), expand_kv_heads(4, v))
    finally:
        config.set_attention_quant("none")
    assert torch.equal(out, want)
