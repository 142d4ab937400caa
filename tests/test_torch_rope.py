"""
The port's 2D RoPE (uniception_tpu_torch/ops/rope.py) on the CPU: its plain
version against the JAX package's jnp ``rope_2d`` (the Pallas RoPE kernel has
no interpret mode), the -F0 inverse, the gradient (the rotation by -F0 of
``Rope2DFunction``) against ``jax.vjp`` of the jnp ``rope_2d`` that the JAX
models run, and the ``Rope2D`` API. The CUDA kernel is held against the same
plain version on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniception_tpu.ops.rope import rope_2d as jax_rope_2d
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.ops.rope import Rope2D, Rope2DFunction, rope_2d, rope_2d_kernel

TOL = 5e-5  # fp32 max abs, the repo's parity bar


def _inputs(seed, b, n, h, d, max_pos=32):
    rng = np.random.RandomState(seed)
    tokens = rng.randn(b, n, h, d).astype(np.float32)
    positions = rng.randint(0, max_pos, size=(b, n, 2)).astype(np.int32)
    return tokens, positions


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("h", [2, 3])
def test_plain_matches_jax(h, d):
    tokens, positions = _inputs(h * d, 2, 24, h, d)
    ref = np.asarray(jax_rope_2d(jnp.asarray(tokens), jnp.asarray(positions), base=100.0))
    out = rope_2d(torch.from_numpy(tokens), torch.from_numpy(positions), base=100.0).numpy()
    assert np.abs(out - ref).max() <= TOL


def test_plain_matches_jax_f0_and_base():
    tokens, positions = _inputs(5, 1, 30, 2, 32)
    ref = np.asarray(jax_rope_2d(jnp.asarray(tokens), jnp.asarray(positions), base=10000.0, f0=-0.5))
    out = rope_2d(torch.from_numpy(tokens), torch.from_numpy(positions), base=10000.0, f0=-0.5).numpy()
    assert np.abs(out - ref).max() <= TOL


def test_inverse_with_negative_f0():
    tokens, positions = _inputs(11, 2, 16, 3, 64)
    t, p = torch.from_numpy(tokens), torch.from_numpy(positions)
    back = rope_2d(rope_2d(t, p, f0=1.0), p, f0=-1.0)
    assert (back - t).abs().max().item() <= 1e-5


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_rope2d_api_on_cpu(impl):
    "Rope2D on a strided q view of a (B, N, 3, H, D) projection takes the plain version and launches nothing."
    qkv = torch.from_numpy(np.random.RandomState(3).randn(2, 12, 3, 2, 64).astype(np.float32))
    pos = make_patch_positions(2, 3, 4)
    before = rope_2d_kernel.launches
    prev = config.get_attention_impl()
    config.set_attention_impl(impl)
    try:
        out = Rope2D(freq=100.0)(qkv[:, :, 0], pos)
    finally:
        config.set_attention_impl(prev)
    ref = jax_rope_2d(jnp.asarray(qkv[:, :, 0].numpy()), jnp.asarray(pos.numpy()), base=100.0)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= TOL
    torch.testing.assert_close(rope_2d_kernel(qkv[:, :, 0], pos), out, rtol=0, atol=0)
    assert rope_2d_kernel.launches == before


def test_patch_positions_row_major():
    pos = make_patch_positions(2, 2, 3)
    assert pos.shape == (2, 6, 2) and pos.dtype == torch.int32
    assert pos[1].tolist() == [[0, 0], [0, 1], [0, 2], [1, 0], [1, 1], [1, 2]]


@pytest.mark.parametrize("f0", [1.0, -0.5])
@pytest.mark.parametrize("d", [16, 64])
def test_gradient_matches_jax_vjp(d, f0):
    "The -F0 backward of Rope2DFunction (the CPU route of the kernel's backward) against jax.vjp of jnp rope_2d."
    tokens, positions = _inputs(d, 2, 20, 3, d)
    g = np.random.RandomState(d + 1).randn(2, 20, 3, d).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_rope_2d(t, jnp.asarray(positions), base=100.0, f0=f0), jnp.asarray(tokens))
    (ref,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(tokens).requires_grad_()
    pos = torch.from_numpy(positions)
    before = (rope_2d_kernel.launches, rope_2d_kernel.backward_launches)
    out = rope_2d_kernel(t, pos, 100.0, f0)
    assert type(out.grad_fn).__name__ == "Rope2DFunctionBackward"
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    (direct,) = torch.autograd.grad(Rope2DFunction.apply(t, pos, 100.0, f0), t, torch.from_numpy(g))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL
    torch.testing.assert_close(direct, got, rtol=0, atol=0)
    assert (rope_2d_kernel.launches, rope_2d_kernel.backward_launches) == before  # CPU: nothing launched


def test_gradient_bf16_matches_plain_autograd():
    "bf16: the -F0 rotation and autograd through the plain version round the same fp32 products once."
    tokens, positions = _inputs(3, 1, 24, 2, 64)
    t = torch.from_numpy(tokens).to(torch.bfloat16).requires_grad_()
    pos = torch.from_numpy(positions)
    g = torch.from_numpy(np.random.RandomState(4).randn(1, 24, 2, 64).astype(np.float32)).to(torch.bfloat16)
    (got,) = torch.autograd.grad(rope_2d_kernel(t, pos), t, g)
    (ref,) = torch.autograd.grad(rope_2d(t, pos), t, g)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
