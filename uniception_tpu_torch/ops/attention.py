"""
Attention dispatch (counterpart of uniception_tpu/ops/attention.py).

Token layout is (B, N, H, D). A CUDA tensor goes to the flash-attention
kernels (through ``FlashAttentionFunction`` when a gradient is needed: the
forward with its logsumexp, then the backward kernel), or to the plain
version when the "naive" implementation is selected; a CPU tensor goes to the
plain versions.
"""

from typing import Optional

import torch

from uniception_tpu_torch.models.utils.config import get_attention_impl
from uniception_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

__all__ = ["scaled_dot_product_attention"]


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
        impl: override the configured implementation ("kernel" or "naive").

    Returns:
        (B, Nq, H, D) attention output.
    """
    impl = impl or get_attention_impl()
    if impl == "naive":
        return flash_attention_ref(q, k, v, scale)
    if impl != "kernel":
        raise ValueError(f"Invalid attention impl {impl!r}")
    return flash_attention(q, k, v, scale)  # a CPU tensor takes the plain version inside
