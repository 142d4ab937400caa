"""
The Llama-style transformer of Perception Encoder's vendored library (counterpart of
uniception_tpu/models/libs/perception_encoder/transformer.py; reference
uniception/models/libs/perception_encoder/transformer.py:16-649): rotary embedding with Llama-3's long-context
frequency scaling, grouped-query attention, the SwiGLU feed-forward with the 2/3 + ``multiple_of`` hidden sizing,
RMSNorm blocks and the BaseTransformer stack.

The rotation is plain torch on adjacent channel pairs, rounded once to the input's dtype (its products in fp32 when
the table is fp32, as in JAX); it is 1D and not K2's quarter layout. Attention without a mask goes through
:func:`~uniception_tpu_torch.ops.attention.scaled_dot_product_attention` after the key / value heads are repeated to
the query heads: K1 on the card. With ``mask="causal"`` or an additive (S, S) mask it is the JAX package's explicit
einsum with fp32 logits and softmax (transformer.py:176-186); no kernel takes a mask. State-dict keys are the torch
model's (``layers.N.attention.wq.weight``, ``feed_forward.w1``, ``attention_norm.weight``); the rotary table is
recomputed, not stored.
"""

import math
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.nn.common import flax_linear
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention

__all__ = [
    "InitStdFactor",
    "BaseTransformerArgs",
    "RotaryEmbedding",
    "LlamaRMSNorm",
    "Attention",
    "FeedForward",
    "TransformerBlock",
    "BaseTransformer",
    "repeat_kv",
    "apply_rotary_emb",
    "cross_entropy",
]


class InitStdFactor(Enum):
    DISABLED = "disabled"
    GLOBAL_DEPTH = "global_depth"
    CURRENT_DEPTH = "current_depth"
    DIM_RATIO = "dim_ratio"


@dataclass
class BaseTransformerArgs:
    "The reference's transformer.py:24-47."

    dim: int = 512
    n_layers: int = 8
    head_dim: Optional[int] = None
    n_heads: Optional[int] = None
    n_kv_heads: Optional[int] = None
    ffn_dim_multiplier: Optional[float] = None
    multiple_of: int = 256
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    old_context_len: int = 8192
    rope_scale_factor: int = 1
    low_freq_factor: int = 1
    high_freq_factor: int = 32
    init_base_std: Optional[float] = None
    init_std_factor: str = "disabled"
    max_seqlen: int = 1024


def cross_entropy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    "The mean token NLL over flattened logits, in fp32 (transformer.py:50-55)."
    logp = torch.log_softmax(pred.reshape(-1, pred.shape[-1]).float(), dim=-1)
    return -logp.gather(-1, target.reshape(-1, 1).long()).mean()


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    "(B, S, Hkv, D) -> (B, S, Hkv * n_rep, D): each key / value head serves n_rep query heads (transformer.py:58-69)."
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def apply_rotary_emb(xq: torch.Tensor, xk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate adjacent channel pairs by the position's angles. cos, sin: (S, D / 2); xq, xk: (B, S, H, D). The
    reference's (S, D / 2, 2, 2) rotation matrices (transformer.py:98-109), as elementwise products."""
    c, s = cos[None, :, None, :, None], sin[None, :, None, :, None]

    def rot(x):
        x2 = x.reshape(*x.shape[:-1], -1, 2)
        x0, x1 = x2[..., :1], x2[..., 1:]
        return torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape).to(x.dtype)

    return rot(xq), rot(xk)


class RotaryEmbedding(nn.Module):
    """The fp32 cos / sin tables (max_seqlen, head_dim / 2), with Llama-3's long-context frequency scaling when
    ``scale_factor != 1`` (transformer.py:191-291). Non-persistent buffers: the checkpoint holds no table."""

    def __init__(self, theta: float, head_dim: int, max_seqlen: int = 1024, scale_factor: int = 1,
                 low_freq_factor: int = 1, high_freq_factor: int = 32, old_context_len: int = 8192, *, device=None):
        super().__init__()
        freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device)[: head_dim // 2].float() / head_dim))
        if scale_factor != 1:
            low_wavelen = old_context_len / low_freq_factor
            high_wavelen = old_context_len / high_freq_factor
            wavelen = 2 * math.pi / freqs
            smooth = (old_context_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
            smoothed = (1 - smooth) * freqs / scale_factor + smooth * freqs
            freqs = torch.where(wavelen < high_wavelen, freqs,
                                torch.where(wavelen > low_wavelen, freqs / scale_factor, smoothed))
        angles = torch.outer(torch.arange(max_seqlen, dtype=torch.float32, device=device), freqs)
        self.register_buffer("cos", angles.cos(), persistent=False)
        self.register_buffer("sin", angles.sin(), persistent=False)

    def forward(self, seqlen: Optional[int] = None, tok_idx: Optional[torch.Tensor] = None):
        if tok_idx is not None:
            return self.cos[tok_idx], self.sin[tok_idx]
        return self.cos[:seqlen], self.sin[:seqlen]


class LlamaRMSNorm(nn.Module):
    "RMSNorm computed in fp32 and rounded once to the input's dtype (transformer.py:294-322). Key: ``weight``."

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (normed * self.weight.float()).to(x.dtype)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    "The additive (S, S) fp32 mask: -inf above the diagonal, 0 elsewhere."
    return torch.full((seq_len, seq_len), float("-inf"), device=device).triu(1)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mask: torch.Tensor):
    """The JAX package's masked path over (B, N, H, D): q scaled in its dtype, fp32 logits plus the additive mask, an
    fp32 softmax cast to v's dtype, then P.V (transformer.py:180-186, pe.py:180-184)."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q * scale, k).float() + mask.float()[None, None]
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1).to(v.dtype), v)


class Attention(nn.Module):
    "Grouped-query attention with rotary embedding (transformer.py:336-456); no biases."

    def __init__(self, dim: int, head_dim: int, n_heads: int, n_kv_heads: int, rope_theta: float, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype, generator=generator)
        self.dim, self.head_dim = dim, head_dim
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.heads_per_group = n_heads // n_kv_heads
        self.wq = flax_linear(dim, n_heads * head_dim, **kw)
        self.wk = flax_linear(dim, n_kv_heads * head_dim, **kw)
        self.wv = flax_linear(dim, n_kv_heads * head_dim, **kw)
        self.wo = flax_linear(n_heads * head_dim, dim, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: Optional[Union[str, torch.Tensor]] = None) -> torch.Tensor:
        "mask: None (K1 on the card), ``\"causal\"``, or an additive (S, S) tensor."
        B, S, _ = x.shape
        xq = self.wq(x).reshape(B, S, self.n_heads, self.head_dim)
        xk = self.wk(x).reshape(B, S, self.n_kv_heads, self.head_dim)
        xv = self.wv(x).reshape(B, S, self.n_kv_heads, self.head_dim)
        xq, xk = apply_rotary_emb(xq, xk, cos[:S], sin[:S])
        xk, xv = repeat_kv(xk, self.heads_per_group), repeat_kv(xv, self.heads_per_group)
        if mask is None:
            out = scaled_dot_product_attention(xq, xk, xv)
        else:
            if isinstance(mask, str):
                assert mask == "causal"
                mask = causal_mask(S, x.device)
            out = masked_attention(xq, xk, xv, self.head_dim**-0.5, mask)
        return self.wo(out.reshape(B, S, self.n_heads * self.head_dim))


class FeedForward(nn.Module):
    "The SwiGLU MLP with Llama's hidden sizing: 2/3 of ``hidden_dim``, times the multiplier, up to ``multiple_of``."

    def __init__(self, dim: int, hidden_dim: int, multiple_of: int, ffn_dim_multiplier: Optional[float], *,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden_dim = int(2 * hidden_dim / 3)
        if ffn_dim_multiplier is not None:
            hidden_dim = int(ffn_dim_multiplier * hidden_dim)
        hidden_dim = multiple_of * ((hidden_dim + multiple_of - 1) // multiple_of)
        self.dim, self.hidden_dim = dim, hidden_dim
        kw = dict(bias=False, device=device, dtype=dtype, generator=generator)
        self.w1 = flax_linear(dim, hidden_dim, **kw)
        self.w3 = flax_linear(dim, hidden_dim, **kw)
        self.w2 = flax_linear(hidden_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class TransformerBlock(nn.Module):
    "Pre-RMSNorm attention and SwiGLU feed-forward (transformer.py:524-576)."

    def __init__(self, args: BaseTransformerArgs, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.head_dim = args.head_dim or args.dim // args.n_heads
        self.n_heads = args.n_heads or args.dim // args.head_dim
        self.n_kv_heads = args.n_kv_heads or self.n_heads
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.attention = Attention(args.dim, self.head_dim, self.n_heads, self.n_kv_heads, args.rope_theta, **kw)
        self.feed_forward = FeedForward(args.dim, 4 * args.dim, args.multiple_of, args.ffn_dim_multiplier, **kw)
        self.attention_norm = LlamaRMSNorm(args.dim, eps=args.norm_eps, device=device)
        self.ffn_norm = LlamaRMSNorm(args.dim, eps=args.norm_eps, device=device)

    def forward(self, x, cos, sin, mask=None):
        h = x + self.attention(self.attention_norm(x), cos, sin, mask=mask)
        return h + self.feed_forward(self.ffn_norm(h))


class BaseTransformer(nn.Module):
    """The stack of Llama blocks over one rotary table (transformer.py:579-649). ``dtype`` is the compute dtype (None:
    the parameters'), ``generator`` draws the weights."""

    def __init__(self, args: BaseTransformerArgs, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = args.dim
        self.max_seqlen = args.max_seqlen
        self.rope_embeddings = RotaryEmbedding(
            theta=args.rope_theta, head_dim=args.head_dim or args.dim // args.n_heads, max_seqlen=args.max_seqlen,
            scale_factor=args.rope_scale_factor, low_freq_factor=args.low_freq_factor,
            high_freq_factor=args.high_freq_factor, old_context_len=args.old_context_len, device=device)
        self.layers = nn.ModuleList([TransformerBlock(args, device=device, dtype=dtype, generator=generator)
                                     for _ in range(args.n_layers)])

    def forward(self, h: torch.Tensor, tok_idx: Optional[torch.Tensor] = None,
                mask: Optional[Union[str, torch.Tensor]] = None) -> torch.Tensor:
        cos, sin = self.rope_embeddings(seqlen=self.max_seqlen, tok_idx=tok_idx)
        for layer in self.layers:
            h = layer(h, cos, sin, mask=mask)
        return h
