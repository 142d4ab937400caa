"""
Attention dispatch (counterpart of uniception_tpu/ops/attention.py).

Token layout is (B, N, H, D). A CUDA tensor goes to the flash-attention
kernels (through ``FlashAttentionFunction`` when a gradient is needed: the
forward with its logsumexp, then the backward kernel), or to the plain
version when the "naive" implementation is selected; a CPU tensor goes to the
plain versions.

With the attention quant mode "int8" or "int8pv" an inference call goes to the
int8 kernel (K6) under the Pallas package's own rule
(uniception_tpu/ops/flash_attention.py:254, :272-276): one key block covers
every key (:func:`single_key_block`), no logsumexp is wanted (no gradient),
and the dtype is not float32. Every other call stays on K1.

Under the "fused" implementation the attention layers inside the fused
contract never reach this function (nn/blocks.py sends them to K5); a call
that does reach it takes exact attention (K1), never K6, whatever the quant
mode, as the JAX package sends such a call to ``_xla_attention``.
"""

from typing import Optional

import torch

from uniception_tpu_torch.models.utils.config import get_attention_impl, get_attention_quant
from uniception_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_int8,
    flash_attention_int8_ref,
    flash_attention_ref,
)

__all__ = ["scaled_dot_product_attention", "single_key_block", "uses_int8_attention"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def single_key_block(q_shape, nk: int, dtype: torch.dtype, block_q: int = 1024, block_k: int = 1024) -> bool:
    """True when one key block covers all ``nk`` keys: the tile plan of the
    Pallas flash attention (uniception_tpu/ops/flash_attention.py ``_plan``,
    :209-234), shrinking the blocks until the working set fits 8 MiB."""
    _, nq, _, d = q_shape
    bq, bk = min(block_q, _round_up(nq, 8)), min(block_k, _round_up(nk, 8))
    itemsize = 4 if dtype == torch.float32 else 2

    def working_set(bq, bk):
        return 2 * (bq + 2 * bk) * d * itemsize + bq * bk * 4 + bq * d * 4

    while working_set(bq, bk) > 8 * 1024 * 1024 and (bq > 128 or bk > 128):
        if bq >= bk and bq > 128:
            bq = _round_up(bq // 2, 8)
        else:
            bk = _round_up(bk // 2, 8)
    return _round_up(nk, bk) == bk


def uses_int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    "Whether this call takes the int8 attention under the configured quant mode (the Pallas package's rule)."
    if get_attention_quant() == "none" or q.dtype == torch.float32:
        return False
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return False  # training saves the logsumexp: K1
    return single_key_block(q.shape, k.shape[1], q.dtype)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over (B, N, H, D) tensors.

    Args:
        q: queries (B, Nq, H, D)
        k: keys (B, Nk, H, D)
        v: values (B, Nk, H, D)
        scale: softmax scale; defaults to D**-0.5.
        impl: override the configured implementation ("kernel", "fused" or "naive").

    Returns:
        (B, Nq, H, D) attention output.
    """
    impl = impl or get_attention_impl()
    if impl not in ("kernel", "fused", "naive"):
        raise ValueError(f"Invalid attention impl {impl!r}")
    # "fused" outside the fused contract: exact attention, no int8 (uniception_tpu/ops/attention.py:190-200:
    # "fused" is neither "naive" nor "pallas", so the JAX call takes _xla_attention)
    if impl != "fused" and uses_int8_attention(q, k, v):
        mode = get_attention_quant()
        if impl == "naive":
            return flash_attention_int8_ref(q, k, v, scale, mode)
        return flash_attention_int8(q, k, v, scale, mode)  # a CPU tensor takes the plain version inside
    if impl == "naive":
        return flash_attention_ref(q, k, v, scale)
    return flash_attention(q, k, v, scale)
