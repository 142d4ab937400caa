"""
Attention dispatch (counterpart of uniception_tpu/ops/attention.py).

Token layout is (B, N, H, D). A CUDA tensor goes to the flash-attention
kernels (through ``FlashAttentionFunction`` when a gradient is needed: the
forward with its logsumexp, then the backward kernel), or to the plain
version when the "naive" implementation is selected; a CPU tensor goes to the
plain versions.

Two shapes route first, as in the JAX package: Dv != Dq takes the explicit
einsum path (:func:`einsum_attention`) on every implementation and device,
and grouped-query shapes (fewer key/value heads than query heads) have their
key/value heads repeated to the query heads (:func:`expand_kv_heads`) before
the usual route.

With the attention quant mode "int8" or "int8pv" an inference call goes to the
int8 kernel (K6) under the Pallas package's own rule
(uniception_tpu/ops/flash_attention.py:254, :272-276): one key block covers
every key (:func:`single_key_block`), no logsumexp is wanted (no gradient),
and the dtype is not float32. Every other call stays on K1.

Under the "fused" implementation the attention layers inside the fused
contract never reach this function (nn/blocks.py sends them to K5); a call
that does reach it takes exact attention (K1), never K6, whatever the quant
mode, as the JAX package sends such a call to ``_xla_attention``.

Sequence parallelism (:func:`set_sequence_parallel`, :func:`sequence_parallel`):
while a (mesh, axis) is set, a call whose Dv equals Dq and whose query and key
token counts the axis divides goes to the ring (parallel/ring_attention.py
``ring_attention_sharded``: each rank attends its share of the queries to every
key chunk as the chunks rotate, K1 with its logsumexp on each), exactly where
the JAX package routes it (its ops/attention.py:171-182); every other call takes
the usual route. When a gradient is needed the ring is differentiable (K3 on
each chunk from the global logsumexp), so a model under sequence parallelism
trains. The JAX package's activation-sharding constraints
(``set_activation_sharding``) pin GSPMD's layout; each rank here already holds
its rows and heads, so they have no counterpart.
"""

import contextlib
from typing import Optional

import torch

from uniception_tpu_torch.models.utils.config import get_attention_impl, get_attention_quant
from uniception_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_int8,
    flash_attention_int8_ref,
    flash_attention_ref,
)

__all__ = ["scaled_dot_product_attention", "single_key_block", "uses_int8_attention", "einsum_attention",
           "expand_kv_heads", "set_sequence_parallel", "get_sequence_parallel", "sequence_parallel"]

_SEQ_PARALLEL = None  # (mesh, axis_name) or None


def set_sequence_parallel(mesh=None, axis_name: str = "data"):
    "Enable (mesh, axis) or disable (mesh=None) ring-attention sequence parallelism."
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = None if mesh is None else (mesh, axis_name)


def get_sequence_parallel():
    return _SEQ_PARALLEL


@contextlib.contextmanager
def sequence_parallel(mesh, axis_name: str = "data"):
    "Context manager form of :func:`set_sequence_parallel`."
    global _SEQ_PARALLEL
    prev = _SEQ_PARALLEL
    _SEQ_PARALLEL = (mesh, axis_name)
    try:
        yield
    finally:
        _SEQ_PARALLEL = prev


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


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's explicit einsum path (``_naive_attention``, uniception_tpu/ops/attention.py:138-143), which
    also takes Dv != Dq: q scaled first, scores cast to fp32, softmax in fp32 cast to v's dtype, then P.V.
    q, k: (B, N, H, Dq); v: (B, Nk, H, Dv). Returns (B, Nq, H, Dv) in the dtype of the P.V product."""
    q = q * (q.shape[-1] ** -0.5 if scale is None else scale)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", weights, v)


def expand_kv_heads(h_q: int, t: torch.Tensor) -> torch.Tensor:
    """Key or value heads (B, N, H_k, D) repeated to ``h_q`` query heads with ``jax.nn.dot_product_attention``'s
    grouping: query head h reads key head h // (h_q / H_k). Raises unless h_q is a multiple of H_k."""
    h_k = t.shape[2]
    if h_q % h_k:
        raise ValueError(f"grouped-query attention: {h_q} query heads are not a multiple of {h_k} key/value heads")
    return t.repeat_interleave(h_q // h_k, dim=2)


def uses_int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    "Whether this call takes the int8 attention under the configured quant mode (the Pallas package's rule)."
    if get_attention_quant() == "none" or q.dtype == torch.float32:
        return False
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return False  # training saves the logsumexp: K1
    return single_key_block(q.shape, k.shape[1], q.dtype)


def _attn_out(x: torch.Tensor) -> torch.Tensor:
    "``x`` named for the \"attn_out\" remat policy (nn/common.py; imported at the call, as nn imports this module)."
    from uniception_tpu_torch.nn.common import checkpoint_name

    return checkpoint_name(x, "attn_out")


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
        k: keys (B, Nk, H_k, D), H_k dividing H
        v: values (B, Nk, H_k, Dv)
        scale: softmax scale; defaults to D**-0.5.
        impl: override the configured implementation ("kernel", "fused" or "naive").

    Returns:
        (B, Nq, H, Dv) attention output.
    """
    impl = impl or get_attention_impl()
    if impl not in ("kernel", "fused", "naive"):
        raise ValueError(f"Invalid attention impl {impl!r}")
    if _SEQ_PARALLEL is not None and v.shape[-1] == q.shape[-1]:
        mesh, axis = _SEQ_PARALLEL
        n = mesh.shape[axis]
        if q.shape[1] % n == 0 and k.shape[1] % n == 0:
            from uniception_tpu_torch.parallel.ring_attention import ring_attention_sharded

            if k.shape[2] != q.shape[2]:
                k, v = expand_kv_heads(q.shape[2], k), expand_kv_heads(q.shape[2], v)
            return ring_attention_sharded(q, k, v, mesh, axis, scale=scale, impl=impl)
    # Dv != Dq (differential attention's Dv = 2 Dq) takes the explicit einsum path on every impl and device, as
    # in the JAX package (uniception_tpu/ops/attention.py:190); no kernel takes it there either. The routes without a
    # kernel's op name their output for the "attn_out" remat policy (nn/common.py ATTN_OUT), which keeps the
    # kernels' ops by their names.
    if v.shape[-1] != q.shape[-1]:
        return _attn_out(einsum_attention(q, k, v, scale))
    if k.shape[2] != q.shape[2]:  # grouped-query shapes (JAX :198): key/value heads shared by query-head groups
        k, v = expand_kv_heads(q.shape[2], k), expand_kv_heads(q.shape[2], v)
    # "fused" outside the fused contract: exact attention, no int8 (uniception_tpu/ops/attention.py:190-200:
    # "fused" is neither "naive" nor "pallas", so the JAX call takes _xla_attention)
    if impl != "fused" and uses_int8_attention(q, k, v):
        mode = get_attention_quant()
        if impl == "naive":
            return _attn_out(flash_attention_int8_ref(q, k, v, scale, mode))
        return flash_attention_int8(q, k, v, scale, mode)  # a CPU tensor takes the plain version inside
    if impl == "naive":
        return _attn_out(flash_attention_ref(q, k, v, scale))
    return flash_attention(q, k, v, scale)
