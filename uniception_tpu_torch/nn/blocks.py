"""
Transformer building blocks (counterpart of uniception_tpu/nn/blocks.py).

Parity with the reference's block library (transformer_blocks.py): Mlp,
SwiGLUFFN(Fused), LayerScale, DropPath, RMSNorm, Attention, CrossAttention,
SelfAttentionBlock and CrossAttentionBlock, including qk-norm, dropout,
stochastic depth and the scalable-softmax and entropy q-scalings
(transformer_blocks.py:231-241); and the differential attention family
(DiffAttention, DiffCrossAttention and their blocks, arXiv:2410.05258;
transformer_blocks.py:682-1045). As in the JAX package, ``attn_drop`` is
accepted and not applied (no attention kernel drops probabilities).

Dropout and stochastic depth draw their masks from the ``generator`` the
module was built with (the default RNG when None), in training mode only;
in eval mode, and at rate 0, they are identities.

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
reference's state-dict keys (qkv, proj, fc1, fc2, w12, w3, ls1.gamma,
q_norm, norm1, norm_y, projq, ...).
"""

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.utils.config import get_attention_impl
from uniception_tpu_torch.nn.common import LinearX, gelu_exact
from uniception_tpu_torch.ops.attention import get_sequence_parallel, scaled_dot_product_attention
from uniception_tpu_torch.ops.fused_attention import fused_cross_rope_attention, fused_qkv_rope_attention
from uniception_tpu_torch.ops.rope import Rope2D

__all__ = [
    "LayerNorm",
    "Mlp",
    "SwiGLUFFN",
    "SwiGLUFFNFused",
    "LayerScale",
    "DropPath",
    "Dropout",
    "RMSNorm",
    "Attention",
    "CrossAttention",
    "SelfAttentionBlock",
    "CrossAttentionBlock",
    "lambda_init_fn",
    "DiffAttention",
    "DiffCrossAttention",
    "DiffSelfAttentionBlock",
    "DiffCrossAttentionBlock",
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


def _activation(act_layer: Callable) -> Callable:
    "A function of the tensor: the JAX package passes functions, the reference module classes (instantiated here)."
    return act_layer() if isinstance(act_layer, type) else act_layer


def _keep_mask(shape, keep_prob: float, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    "A {0, 1} mask of ``shape`` in ``like``'s dtype and device, each entry 1 with probability ``keep_prob``."
    device = like.device if generator is None else generator.device
    draw = torch.rand(shape, generator=generator, device=device) < keep_prob
    return draw.to(like.device, like.dtype)


class Dropout(nn.Module):
    """Dropout (flax ``nnx.Dropout``): in training each element is kept with probability 1 - p and scaled by
    1 / (1 - p), zero at p = 1; an identity in eval mode and at p = 0. The mask comes from ``generator``."""

    def __init__(self, p: float = 0.0, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0 or not self.training:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        return x * _keep_mask(x.shape, keep, x, self.generator) / keep


class DropPath(nn.Module):
    """Stochastic depth per sample (transformer_blocks.py:38-63; JAX nn/blocks.py:175): in training each sample's
    residual branch is kept with probability 1 - drop_prob, scaled by 1 / (1 - drop_prob) with ``scale_by_keep``;
    an identity in eval mode and at drop_prob = 0. The mask comes from ``generator``."""

    def __init__(self, drop_prob: float = 0.0, scale_by_keep: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_prob = drop_prob
        self.scale_by_keep = scale_by_keep
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop_prob == 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_prob
        mask = _keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, x, self.generator)
        if keep > 0.0 and self.scale_by_keep:
            mask = mask / keep
        return x * mask


def _dropout(p: float, generator: Optional[torch.Generator]) -> nn.Module:
    return Dropout(p, generator=generator) if p > 0.0 else nn.Identity()


class Mlp(nn.Module):
    "ViT MLP (transformer_blocks.py:66-89): fc1 -> act -> drop -> fc2 -> drop."

    def __init__(
        self,
        in_features: int,
        hidden_features: Optional[int] = None,
        out_features: Optional[int] = None,
        act_layer: Callable = gelu_exact,
        bias: bool = True,
        drop: float = 0.0,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        lin = dict(bias=bias, device=device, dtype=dtype, generator=generator)
        self.fc1 = LinearX(in_features, hidden_features, **lin)
        self.act = _activation(act_layer)
        self.drop1 = _dropout(drop, generator)
        self.fc2 = LinearX(hidden_features, out_features, **lin)
        self.drop2 = _dropout(drop, generator)

    def forward(self, x):
        return self.drop2(self.fc2(self.drop1(self.act(self.fc1(x)))))


class SwiGLUFFN(nn.Module):
    """SwiGLU feed-forward (transformer_blocks.py:92-112; JAX nn/blocks.py:108): w12 -> split in halves x1, x2 ->
    w3(silu(x1) * x2). ``act_layer`` and ``drop`` are accepted and unused, as in the JAX package."""

    def __init__(
        self,
        in_features: int,
        hidden_features: Optional[int] = None,
        out_features: Optional[int] = None,
        act_layer: Optional[Callable] = None,
        drop: float = 0.0,
        bias: bool = True,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        lin = dict(bias=bias, device=device, dtype=dtype, generator=generator)
        self.w12 = LinearX(in_features, 2 * hidden_features, **lin)
        self.w3 = LinearX(hidden_features, out_features, **lin)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class SwiGLUFFNFused(SwiGLUFFN):
    """SwiGLU with DINOv2's hidden rounding (transformer_blocks.py:115-133; JAX nn/blocks.py:135): the hidden width
    is (int(h * 2 / 3) + 7) // 8 * 8, 4096 for ViT-g's h = 6144."""

    def __init__(
        self,
        in_features: int,
        hidden_features: Optional[int] = None,
        out_features: Optional[int] = None,
        act_layer: Optional[Callable] = None,
        drop: float = 0.0,
        bias: bool = True,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        hidden_features = hidden_features or in_features
        super().__init__(in_features, (int(hidden_features * 2 / 3) + 7) // 8 * 8, out_features, bias=bias,
                         device=device, dtype=dtype, generator=generator)


class LayerScale(nn.Module):
    "Per-channel learned scaling (transformer_blocks.py:389-412): x * gamma, gamma cast to x's dtype first (JAX :165)."

    def __init__(self, dim: int, init_values: float = 1e-5, *, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm (transformer_blocks.py:658-679; JAX nn/blocks.py:195): statistics in fp32, the normalized input cast
    back to the input's dtype, then times the weight in that dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, elementwise_affine: bool = True, *, device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device)) if elementwise_affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        out = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)).to(x.dtype)
        return out if self.weight is None else out * self.weight.to(x.dtype)


def _token_count_scale_factor(n_tokens, use_scalable_softmax, use_entropy_scaling, base_count, growth_factor):
    "The scalar SSMax / entropy scaling multiply q by (transformer_blocks.py:231-241); folds into the softmax scale."
    f = 1.0
    if use_scalable_softmax:
        f *= math.log(n_tokens)
    if use_entropy_scaling:
        f *= math.sqrt(growth_factor * math.log(n_tokens) / math.log(base_count))
    return f


def _enter(proj, x):
    "A projection's input as a kernel reading its weight takes it (parallel/mesh.py ``ColumnParallel.enter``)."
    return proj.enter(x) if hasattr(proj, "enter") else x


def _fused_attention_applicable(mod, n_kv: int) -> bool:
    """Whether the fused qkv + RoPE + attention kernel covers this module (JAX
    nn/blocks.py:238-266): the "fused" implementation, plain projections (an
    int8-quantized one has no float weight to fuse), no qk-norm (the kernel
    projects straight into RoPE and attention, with no norm between), a
    positional encoding that is absent or RoPE2D, a head dim that is a multiple
    of 4, and at most 2048 keys; and not while sequence parallelism is set
    (JAX nn/blocks.py:249: the ring takes the attention). The port has no latent
    attention, so the JAX package's check of that falls away. Under tensor
    parallelism the kernel runs on the rank's local heads."""
    if get_attention_impl() != "fused" or get_sequence_parallel() is not None:
        return False
    pe = mod.custom_positional_encoding
    projs = [getattr(mod, a) for a in ("qkv", "projq", "projk", "projv") if hasattr(mod, a)]
    return (
        all(isinstance(getattr(p, "inner", p), nn.Linear) for p in projs)
        and isinstance(mod.q_norm, nn.Identity)
        and isinstance(mod.k_norm, nn.Identity)
        and (pe is None or isinstance(pe, Rope2D))
        and mod.head_dim % 4 == 0
        and n_kv <= 2048
    )


class _AttentionBase(nn.Module):
    """What self- and cross-attention share: head split, qk-norm, output dropout, positional encoding, q-scalings,
    attention call."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        qk_norm: bool,
        attn_drop: float,
        proj_drop: float,
        norm_layer: Callable,
        custom_positional_encoding: Optional[Callable],
        use_scalable_softmax: bool,
        use_entropy_scaling: bool,
        base_token_count_for_entropy_scaling: int,
        entropy_scaling_growth_factor: float,
        device,
        dtype,
        generator: Optional[torch.Generator],
    ):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError("dim should be divisible by num_heads")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim**-0.5
        # qk-norm over each head's (B, N, H, D) channels, before any RoPE (JAX nn/blocks.py:345)
        self.q_norm = norm_layer(self.head_dim, device=device, dtype=dtype) if qk_norm else nn.Identity()
        self.k_norm = norm_layer(self.head_dim, device=device, dtype=dtype) if qk_norm else nn.Identity()
        self.attn_drop = attn_drop  # accepted and not applied, as in the JAX package
        self.proj_drop = _dropout(proj_drop, generator)
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
        "q: (B, Nq, H, D), k/v: (B, Nk, H, D) -> (B, Nq, H*D): qk-norm, RoPE, q-scalings, attention."
        q, k = self.q_norm(q), self.k_norm(k)
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
        qk_norm: bool = False,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
        norm_layer: Callable = make_norm_layer,
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
            dim, num_heads, qk_norm, attn_drop, proj_drop, norm_layer, custom_positional_encoding,
            use_scalable_softmax, use_entropy_scaling, base_token_count_for_entropy_scaling,
            entropy_scaling_growth_factor, device, dtype, generator,
        )
        lin = dict(device=device, dtype=dtype, generator=generator)
        self.qkv = LinearX(dim, dim * 3, bias=qkv_bias, **lin)
        self.proj = LinearX(dim, dim, **lin)

    def forward(self, x: torch.Tensor, xpos: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, _ = x.shape
        if _fused_attention_applicable(self, N):
            scale, (base, f0) = self._fused_args(N, xpos is not None)
            pos = xpos if self.custom_positional_encoding is not None else None
            out = fused_qkv_rope_attention(_enter(self.qkv, x), self.qkv.weight.to(x.dtype), self.qkv.bias, pos,
                                           self.num_heads, scale, base, f0)
            return self.proj_drop(self.proj(out))
        # q/k/v stay strided views of the projection: the kernels read them by stride
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim).unbind(2)
        return self.proj_drop(self.proj(self._attend(q, k, v, xpos, xpos)))


class CrossAttention(_AttentionBase):
    "Cross-attention layer (transformer_blocks.py:260-386; JAX nn/blocks.py:461-486)."

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        qkv_bias: bool = False,
        qk_norm: bool = False,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
        norm_layer: Callable = make_norm_layer,
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
            dim, num_heads, qk_norm, attn_drop, proj_drop, norm_layer, custom_positional_encoding,
            use_scalable_softmax, use_entropy_scaling, base_token_count_for_entropy_scaling,
            entropy_scaling_growth_factor, device, dtype, generator,
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
                _enter(self.projq, query), _enter(self.projk, key), self.projq.weight.to(dt),
                self.projk.weight.to(dt), self.projv.weight.to(dt),
                self.projq.bias, self.projk.bias, self.projv.bias, qpos if rope else None, kpos if rope else None,
                self.num_heads, scale, base, f0,
            )
            return self.proj_drop(self.proj(out))
        heads = (self.num_heads, self.head_dim)
        q = self.projq(query).reshape(*query.shape[:2], *heads)
        k = self.projk(key).reshape(*key.shape[:2], *heads)
        v = self.projv(value).reshape(*value.shape[:2], *heads)
        return self.proj_drop(self.proj(self._attend(q, k, v, qpos, kpos)))


def _residual_branch(dim, init_values, drop_path, device, generator):
    "(LayerScale or Identity, DropPath or Identity) of one residual branch (JAX nn/blocks.py:540-541)."
    ls = LayerScale(dim, init_values, device=device) if init_values else nn.Identity()
    return ls, DropPath(drop_path, generator=generator) if drop_path > 0.0 else nn.Identity()


class SelfAttentionBlock(nn.Module):
    """Pre-norm self-attention block (transformer_blocks.py:415-514; JAX nn/blocks.py:489-563); also the CroCo
    encoder Block (libs/croco/blocks.py:133-161) and the DINOv2 block (``init_values``: LayerScale ``ls1``/``ls2``;
    ``mlp_layer``: :class:`Mlp` or :class:`SwiGLUFFNFused`).

    ``attn_kwargs`` are :class:`Attention`'s further options (custom_positional_encoding, the q-scalings).
    """

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        qk_norm: bool = False,
        proj_drop: float = 0.0,
        attn_drop: float = 0.0,
        init_values: Optional[float] = None,
        drop_path: float = 0.0,
        act_layer: Callable = gelu_exact,
        norm_layer: Callable = make_norm_layer,
        mlp_layer: Callable = Mlp,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
        **attn_kwargs,
    ):
        super().__init__()
        norm = dict(device=device, dtype=dtype)
        sub = dict(device=device, dtype=dtype, generator=generator)
        attn = dict(qkv_bias=qkv_bias, qk_norm=qk_norm, attn_drop=attn_drop, proj_drop=proj_drop,
                    norm_layer=norm_layer, **attn_kwargs)
        self.norm1 = norm_layer(dim, **norm)
        self.attn = Attention(dim, num_heads=num_heads, **sub, **attn)
        self.ls1, self.drop_path1 = _residual_branch(dim, init_values, drop_path, device, generator)
        self.norm2 = norm_layer(dim, **norm)
        self.mlp = mlp_layer(in_features=dim, hidden_features=int(dim * mlp_ratio), act_layer=act_layer,
                             drop=proj_drop, **sub)
        self.ls2, self.drop_path2 = _residual_branch(dim, init_values, drop_path, device, generator)

    def forward(self, x: torch.Tensor, xpos: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x), xpos)))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))


class CrossAttentionBlock(nn.Module):
    """Pre-norm self + cross attention block (transformer_blocks.py:517-647; JAX nn/blocks.py:566-652); also the
    CroCo DecoderBlock (libs/croco/blocks.py:214-249).

    ``attn_kwargs`` are the further options of both attentions, as for :class:`SelfAttentionBlock`. The cross
    tokens are normalized (norm_y) unless ``norm_cross_tokens`` is False.
    """

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        qk_norm: bool = False,
        proj_drop: float = 0.0,
        attn_drop: float = 0.0,
        init_values: Optional[float] = None,
        drop_path: float = 0.0,
        act_layer: Callable = gelu_exact,
        norm_layer: Callable = make_norm_layer,
        mlp_layer: Callable = Mlp,
        norm_cross_tokens: bool = True,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
        **attn_kwargs,
    ):
        super().__init__()
        norm = dict(device=device, dtype=dtype)
        sub = dict(device=device, dtype=dtype, generator=generator)
        attn = dict(qkv_bias=qkv_bias, qk_norm=qk_norm, attn_drop=attn_drop, proj_drop=proj_drop,
                    norm_layer=norm_layer, **attn_kwargs)
        self.norm1 = norm_layer(dim, **norm)
        self.attn = Attention(dim, num_heads=num_heads, **sub, **attn)
        self.ls1, self.drop_path1 = _residual_branch(dim, init_values, drop_path, device, generator)
        self.norm_y = norm_layer(dim, **norm) if norm_cross_tokens else nn.Identity()
        self.norm2 = norm_layer(dim, **norm)
        self.cross_attn = CrossAttention(dim, num_heads=num_heads, **sub, **attn)
        self.ls2, self.drop_path2 = _residual_branch(dim, init_values, drop_path, device, generator)
        self.norm3 = norm_layer(dim, **norm)
        self.mlp = mlp_layer(in_features=dim, hidden_features=int(dim * mlp_ratio), act_layer=act_layer,
                             drop=proj_drop, **sub)
        self.ls3, self.drop_path3 = _residual_branch(dim, init_values, drop_path, device, generator)

    def forward(
        self,
        x: torch.Tensor,
        y: torch.Tensor,
        xpos: Optional[torch.Tensor] = None,
        ypos: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x), xpos)))
        y_ = self.norm_y(y)
        x = x + self.drop_path2(self.ls2(self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)))
        return x + self.drop_path3(self.ls3(self.mlp(self.norm3(x))))


def lambda_init_fn(depth: int) -> float:
    "DiffTransformer's lambda schedule over the block depth (transformer_blocks.py:682-683)."
    return 0.8 - 0.6 * math.exp(-0.3 * depth)


class _DiffAttentionBase(nn.Module):
    """What both differential attentions share (JAX nn/blocks.py:660-835): each of the ``num_heads`` heads splits
    its q and k into two sub-heads of ``head_dim = dim // num_heads // 2``, the (B, N, 2H, Dh) split taken as the
    first and second halves of the 2H axis (the reference's ``chunk(2)`` after its view), while v keeps (B, N, H,
    2 Dh). The two softmaxes share v: a1 - lambda a2 with lambda = exp(lambda_q1 . lambda_k1) - exp(lambda_q2 .
    lambda_k2) + lambda_init, then RMSNorm over 2 Dh (eps 1e-5) and the (1 - lambda_init) scale. The positional
    encoding (RoPE) rotates the Dh sub-heads. The four lambda vectors are fp32 parameters; lambda is cast to the
    compute dtype after its exponentials. The attentions (Dv = 2 Dq) take the einsum path of ops/attention.py, as
    in the JAX package, which routes Dv != Dq to XLA's einsum."""

    def __init__(self, dim, depth, num_heads, qk_norm, attn_drop, proj_drop, norm_layer, custom_positional_encoding,
                 device, dtype, generator):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError("dim should be divisible by num_heads")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads // 2
        self.scale = self.head_dim**-0.5
        self.q_norm = norm_layer(self.head_dim, device=device, dtype=dtype) if qk_norm else nn.Identity()
        self.k_norm = norm_layer(self.head_dim, device=device, dtype=dtype) if qk_norm else nn.Identity()
        self.attn_drop = attn_drop  # accepted and not applied, as in the JAX package
        self.proj = LinearX(dim, dim, device=device, dtype=dtype, generator=generator)
        self.proj_drop = _dropout(proj_drop, generator)
        self.custom_positional_encoding = custom_positional_encoding
        self.lambda_init = lambda_init_fn(depth)
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            param = torch.empty(self.head_dim, device=device)
            nn.init.normal_(param, 0.0, 0.1, generator=generator)
            setattr(self, name, nn.Parameter(param))
        self.subln = RMSNorm(2 * self.head_dim, eps=1e-5, elementwise_affine=True, device=device)

    def _lambda_full(self, dt: torch.dtype) -> torch.Tensor:
        l1 = torch.exp((self.lambda_q1.float() * self.lambda_k1.float()).sum()).to(dt)
        l2 = torch.exp((self.lambda_q2.float() * self.lambda_k2.float()).sum()).to(dt)
        return l1 - l2 + self.lambda_init

    def _attend(self, q, k, v, qpos, kpos):
        "q, k: (B, N, 2H, Dh); v: (B, Nk, H, 2 Dh) -> (B, Nq, H * 2 Dh) after the projection."
        q, k = self.q_norm(q), self.k_norm(k)
        if self.custom_positional_encoding is not None:
            if qpos is None or kpos is None:
                raise ValueError("positions are required when using custom positional encoding")
            q = self.custom_positional_encoding(q, qpos)
            k = self.custom_positional_encoding(k, kpos)
        H = self.num_heads
        a1 = scaled_dot_product_attention(q[:, :, :H], k[:, :, :H], v, scale=self.scale)
        a2 = scaled_dot_product_attention(q[:, :, H:], k[:, :, H:], v, scale=self.scale)
        attn = self.subln(a1 - self._lambda_full(q.dtype) * a2) * (1 - self.lambda_init)
        B, N = attn.shape[:2]
        return self.proj_drop(self.proj(attn.reshape(B, N, H * 2 * self.head_dim)))


class DiffAttention(_DiffAttentionBase):
    """Differential self-attention (arXiv:2410.05258; transformer_blocks.py:686-804). As in the JAX package, the
    output is transposed heads-last before the merge (the reference reshapes (B, H, N, 2 Dh) straight to (B, N, C),
    which scrambles tokens across heads for more than one head; its cross variant transposes)."""

    def __init__(
        self,
        dim: int,
        depth: int,
        num_heads: int = 8,
        qkv_bias: bool = False,
        qk_norm: bool = False,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
        norm_layer: Callable = make_norm_layer,
        custom_positional_encoding: Optional[Callable] = None,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dim, depth, num_heads, qk_norm, attn_drop, proj_drop, norm_layer, custom_positional_encoding,
                         device, dtype, generator)
        self.qkv = LinearX(dim, dim * 3, bias=qkv_bias, device=device, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, xpos: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, _ = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, 2 * self.head_dim).unbind(2)
        sub = (B, N, 2 * self.num_heads, self.head_dim)
        return self._attend(q.reshape(sub), k.reshape(sub), v, xpos, xpos)


class DiffCrossAttention(_DiffAttentionBase):
    "Differential cross-attention (transformer_blocks.py:807-945)."

    def __init__(
        self,
        dim: int,
        depth: int,
        num_heads: int = 8,
        qkv_bias: bool = False,
        qk_norm: bool = False,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
        norm_layer: Callable = make_norm_layer,
        custom_positional_encoding: Optional[Callable] = None,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dim, depth, num_heads, qk_norm, attn_drop, proj_drop, norm_layer, custom_positional_encoding,
                         device, dtype, generator)
        lin = dict(bias=qkv_bias, device=device, dtype=dtype, generator=generator)
        self.projq = LinearX(dim, dim, **lin)
        self.projk = LinearX(dim, dim, **lin)
        self.projv = LinearX(dim, dim, **lin)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        qpos: Optional[torch.Tensor] = None,
        kpos: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        H, Dh = self.num_heads, self.head_dim
        q = self.projq(query).reshape(*query.shape[:2], 2 * H, Dh)
        k = self.projk(key).reshape(*key.shape[:2], 2 * H, Dh)
        v = self.projv(value).reshape(*value.shape[:2], H, 2 * Dh)
        return self._attend(q, k, v, qpos, kpos)


_DIFF_KEYS = ("qkv_bias", "qk_norm", "attn_drop", "proj_drop", "norm_layer", "custom_positional_encoding")


class DiffSelfAttentionBlock(SelfAttentionBlock):
    "Self-attention block with differential attention (transformer_blocks.py:948-994); ``depth`` sets its lambda."

    def __init__(self, dim, depth, num_heads, *, device=None, dtype=None, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(dim=dim, num_heads=num_heads, device=device, dtype=dtype, generator=generator, **kw)
        self.attn = DiffAttention(dim, depth, num_heads=num_heads, device=device, dtype=dtype, generator=generator,
                                  **{k: kw[k] for k in _DIFF_KEYS if k in kw})


class DiffCrossAttentionBlock(CrossAttentionBlock):
    """Cross-attention block whose cross-attention is differential (transformer_blocks.py:997-1045); the
    self-attention stays :class:`Attention`. ``depth`` sets the lambda."""

    def __init__(self, dim, depth, num_heads, *, device=None, dtype=None, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(dim=dim, num_heads=num_heads, device=device, dtype=dtype, generator=generator, **kw)
        self.cross_attn = DiffCrossAttention(dim, depth, num_heads=num_heads, device=device, dtype=dtype,
                                             generator=generator, **{k: kw[k] for k in _DIFF_KEYS if k in kw})
