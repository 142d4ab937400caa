"""
Transformer building blocks (counterpart of uniception_tpu/nn/blocks.py).

Parity with the reference's block library (transformer_blocks.py): Mlp,
Attention, CrossAttention, SelfAttentionBlock and CrossAttentionBlock,
including the scalable-softmax and entropy q-scalings
(transformer_blocks.py:231-241). No dropout, LayerScale or stochastic depth
(identities at the DUSt3R configuration), no qk-norm.

Under the "fused" implementation, :class:`Attention` and :class:`CrossAttention`
(when the caller passes the same tensor as key and value) run the fused
qkv-projection + RoPE + attention kernel (K5) where the JAX package's fused
contract covers them (:func:`_fused_attention_applicable`, JAX
nn/blocks.py:228-266), with SSMax / entropy scaling folded into the softmax
scale; the output projection stays a matmul.

Every module takes a compute ``dtype`` (None: the parameters' dtype); with
fp32 parameters and ``dtype=torch.bfloat16`` the residual stream, the norms'
outputs and the attention run in bf16, as in the JAX package.

Token layout inside attention is (B, N, H, D); a custom positional encoding
takes (tokens (B, N, H, D), positions (B, N, 2)). Submodule names are the
reference's state-dict keys (qkv, proj, fc1, fc2, norm1, norm_y, projq, ...).
"""

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.utils.config import get_attention_impl
from uniception_tpu_torch.nn.common import LinearX, gelu_exact
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention
from uniception_tpu_torch.ops.fused_attention import fused_cross_rope_attention, fused_qkv_rope_attention
from uniception_tpu_torch.ops.rope import Rope2D

__all__ = [
    "LayerNorm",
    "Mlp",
    "Attention",
    "CrossAttention",
    "SelfAttentionBlock",
    "CrossAttentionBlock",
    "make_norm_layer",
    "layer_norm_factory",
]


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with an optional compute dtype: input, weight and bias
    are cast to ``dtype`` at use (flax ``nnx.LayerNorm(dtype=...)``), so the
    output is in ``dtype``; None computes in the parameters' dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__(dim, eps=eps, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.layer_norm(x.to(dt), self.normalized_shape, self.weight.to(dt), self.bias.to(dt), self.eps)


def make_norm_layer(dim: int, *, eps: float = 1e-5, device=None, dtype=None) -> LayerNorm:
    "Default norm factory: LayerNorm with torch-default eps=1e-5 and compute dtype ``dtype``."
    return LayerNorm(dim, eps=eps, device=device, dtype=dtype)


def layer_norm_factory(eps: float = 1e-5) -> Callable:
    "Return a norm factory with a fixed eps (analogue of partial(nn.LayerNorm, eps=...))."
    return partial(make_norm_layer, eps=eps)


class Mlp(nn.Module):
    "ViT MLP (transformer_blocks.py:66-89): fc1 -> GELU -> fc2."

    def __init__(
        self, in_features: int, hidden_features: int, *, device=None, dtype=None, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        self.fc1 = LinearX(in_features, hidden_features, device=device, dtype=dtype, generator=generator)
        self.fc2 = LinearX(hidden_features, in_features, device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


def _token_count_scale_factor(n_tokens, use_scalable_softmax, use_entropy_scaling, base_count, growth_factor):
    "The scalar SSMax / entropy scaling multiply q by (transformer_blocks.py:231-241); folds into the softmax scale."
    f = 1.0
    if use_scalable_softmax:
        f *= math.log(n_tokens)
    if use_entropy_scaling:
        f *= math.sqrt(growth_factor * math.log(n_tokens) / math.log(base_count))
    return f


def _fused_attention_applicable(mod, n_kv: int) -> bool:
    """Whether the fused qkv + RoPE + attention kernel covers this module (JAX
    nn/blocks.py:238-266): the "fused" implementation, plain projections (an
    int8-quantized one has no float weight to fuse), a positional encoding that
    is absent or RoPE2D, a head dim that is a multiple of 4, and at most 2048
    keys. The port has no qk-norm, latent attention or sequence parallelism,
    so the JAX package's checks of those fall away."""
    if get_attention_impl() != "fused":
        return False
    pe = mod.custom_positional_encoding
    projs = [getattr(mod, a) for a in ("qkv", "projq", "projk", "projv") if hasattr(mod, a)]
    return (
        all(isinstance(p, nn.Linear) for p in projs)
        and (pe is None or isinstance(pe, Rope2D))
        and mod.head_dim % 4 == 0
        and n_kv <= 2048
    )


class _AttentionBase(nn.Module):
    "What self- and cross-attention share: head split, positional encoding, q-scalings, attention call."

    def __init__(
        self,
        dim: int,
        num_heads: int,
        custom_positional_encoding: Optional[Callable],
        use_scalable_softmax: bool,
        use_entropy_scaling: bool,
        base_token_count_for_entropy_scaling: int,
        entropy_scaling_growth_factor: float,
    ):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError("dim should be divisible by num_heads")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim**-0.5
        self.custom_positional_encoding = custom_positional_encoding
        self.use_scalable_softmax = use_scalable_softmax
        self.use_entropy_scaling = use_entropy_scaling
        self.base_token_count_for_entropy_scaling = base_token_count_for_entropy_scaling
        self.entropy_scaling_growth_factor = entropy_scaling_growth_factor

    def _fused_args(self, n_tokens, positions_given):
        "(scale with the q-scalings folded in, RoPE base, RoPE F0) for the fused kernel."
        pe = self.custom_positional_encoding
        if pe is not None and not positions_given:
            raise ValueError("positions are required when using custom positional encoding")
        scale = self.scale * _token_count_scale_factor(
            n_tokens, self.use_scalable_softmax, self.use_entropy_scaling,
            self.base_token_count_for_entropy_scaling, self.entropy_scaling_growth_factor,
        )
        return scale, (pe.base, pe.F0) if pe is not None else (100.0, 1.0)

    def _attend(self, q, k, v, qpos, kpos):
        "q: (B, Nq, H, D), k/v: (B, Nk, H, D) -> (B, Nq, H*D)."
        if self.custom_positional_encoding is not None:
            if qpos is None or kpos is None:
                raise ValueError("positions are required when using custom positional encoding")
            q = self.custom_positional_encoding(q, qpos)
            k = self.custom_positional_encoding(k, kpos)
        # SSMax / entropy scaling as q pre-scales (transformer_blocks.py:231-241)
        n_tokens = q.shape[1]
        if self.use_scalable_softmax:
            q = q * math.log(n_tokens)
        if self.use_entropy_scaling:
            q = q * math.sqrt(
                self.entropy_scaling_growth_factor * math.log(n_tokens) / math.log(self.base_token_count_for_entropy_scaling)
            )
        x = scaled_dot_product_attention(q, k, v, scale=self.scale)
        return x.reshape(x.shape[0], x.shape[1], self.num_heads * self.head_dim)


class Attention(_AttentionBase):
    "Self-attention layer (transformer_blocks.py:136-257; the unfused path of the JAX nn/blocks.py:343-368)."

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        qkv_bias: bool = False,
        custom_positional_encoding: Optional[Callable] = None,
        use_scalable_softmax: bool = False,
        use_entropy_scaling: bool = False,
        base_token_count_for_entropy_scaling: int = 444,
        entropy_scaling_growth_factor: float = 1.4,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(
            dim, num_heads, custom_positional_encoding, use_scalable_softmax, use_entropy_scaling,
            base_token_count_for_entropy_scaling, entropy_scaling_growth_factor,
        )
        lin = dict(device=device, dtype=dtype, generator=generator)
        self.qkv = LinearX(dim, dim * 3, bias=qkv_bias, **lin)
        self.proj = LinearX(dim, dim, **lin)

    def forward(self, x: torch.Tensor, xpos: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, _ = x.shape
        if _fused_attention_applicable(self, N):
            scale, (base, f0) = self._fused_args(N, xpos is not None)
            pos = xpos if self.custom_positional_encoding is not None else None
            out = fused_qkv_rope_attention(x, self.qkv.weight.to(x.dtype), self.qkv.bias, pos, self.num_heads, scale,
                                           base, f0)
            return self.proj(out)
        # q/k/v stay strided views of the projection: the kernels read them by stride
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim).unbind(2)
        return self.proj(self._attend(q, k, v, xpos, xpos))


class CrossAttention(_AttentionBase):
    "Cross-attention layer (transformer_blocks.py:260-386; JAX nn/blocks.py:461-486)."

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        qkv_bias: bool = False,
        custom_positional_encoding: Optional[Callable] = None,
        use_scalable_softmax: bool = False,
        use_entropy_scaling: bool = False,
        base_token_count_for_entropy_scaling: int = 444,
        entropy_scaling_growth_factor: float = 1.4,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(
            dim, num_heads, custom_positional_encoding, use_scalable_softmax, use_entropy_scaling,
            base_token_count_for_entropy_scaling, entropy_scaling_growth_factor,
        )
        lin = dict(device=device, dtype=dtype, generator=generator)
        self.projq = LinearX(dim, dim, bias=qkv_bias, **lin)
        self.projk = LinearX(dim, dim, bias=qkv_bias, **lin)
        self.projv = LinearX(dim, dim, bias=qkv_bias, **lin)
        self.proj = LinearX(dim, dim, **lin)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        qpos: Optional[torch.Tensor] = None,
        kpos: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        # the fused kernel projects k and v from one tensor: only when the caller passes the same one for both
        if key is value and _fused_attention_applicable(self, key.shape[1]):
            scale, (base, f0) = self._fused_args(query.shape[1], qpos is not None and kpos is not None)
            rope = self.custom_positional_encoding is not None
            dt = query.dtype
            out = fused_cross_rope_attention(
                query, key, self.projq.weight.to(dt), self.projk.weight.to(dt), self.projv.weight.to(dt),
                self.projq.bias, self.projk.bias, self.projv.bias, qpos if rope else None, kpos if rope else None,
                self.num_heads, scale, base, f0,
            )
            return self.proj(out)
        heads = (self.num_heads, self.head_dim)
        q = self.projq(query).reshape(*query.shape[:2], *heads)
        k = self.projk(key).reshape(*key.shape[:2], *heads)
        v = self.projv(value).reshape(*value.shape[:2], *heads)
        return self.proj(self._attend(q, k, v, qpos, kpos))


class SelfAttentionBlock(nn.Module):
    """Pre-norm self-attention block (transformer_blocks.py:415-514); also the
    CroCo encoder Block (libs/croco/blocks.py:133-161).

    ``attn_kwargs`` are :class:`Attention`'s options (qkv_bias,
    custom_positional_encoding, the q-scalings).
    """

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        norm_layer: Callable = make_norm_layer,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
        **attn_kwargs,
    ):
        super().__init__()
        norm = dict(device=device, dtype=dtype)
        sub = dict(device=device, dtype=dtype, generator=generator)
        self.norm1 = norm_layer(dim, **norm)
        self.attn = Attention(dim, num_heads=num_heads, **sub, **attn_kwargs)
        self.norm2 = norm_layer(dim, **norm)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **sub)

    def forward(self, x: torch.Tensor, xpos: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class CrossAttentionBlock(nn.Module):
    """Pre-norm self + cross attention block (transformer_blocks.py:517-647);
    also the CroCo DecoderBlock (libs/croco/blocks.py:214-249).

    ``attn_kwargs`` are the options of both attentions, as for
    :class:`SelfAttentionBlock`. The cross tokens are normalized (norm_y).
    """

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        norm_layer: Callable = make_norm_layer,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
        **attn_kwargs,
    ):
        super().__init__()
        norm = dict(device=device, dtype=dtype)
        sub = dict(device=device, dtype=dtype, generator=generator)
        self.norm1 = norm_layer(dim, **norm)
        self.attn = Attention(dim, num_heads=num_heads, **sub, **attn_kwargs)
        self.norm_y = norm_layer(dim, **norm)
        self.norm2 = norm_layer(dim, **norm)
        self.cross_attn = CrossAttention(dim, num_heads=num_heads, **sub, **attn_kwargs)
        self.norm3 = norm_layer(dim, **norm)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **sub)

    def forward(
        self,
        x: torch.Tensor,
        y: torch.Tensor,
        xpos: Optional[torch.Tensor] = None,
        ypos: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        return x + self.mlp(self.norm3(x))
