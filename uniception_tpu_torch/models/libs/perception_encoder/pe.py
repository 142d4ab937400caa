"""
Meta Perception Encoder (PE): the vision transformer, the text transformer and CLIP (counterpart of
uniception_tpu/models/libs/perception_encoder/pe.py; reference
uniception/models/libs/perception_encoder/vision_encoder/pe.py:33-752 and rope.py:36-322).

A CLIP-style ViT: an optional cls token, an absolute PE table interpolated bilinearly off its grid, axial 2-D RoPE
with interleaved pairs (lucidrains' convention: per-axis frequencies repeated over adjacent channel pairs, the x
axis first, the cls token unrotated), LayerScale, attention pooling. The RoPE stays plain torch with its rotation in
fp32, as in JAX: its interleaved layout is not K2's quarter layout. The attention is K1 on the card: heads of 64
(B16, L14) and 96 (G14, 1536 / 16).

State-dict keys are the torch model's (transformer.resblocks.N.attn.in_proj_weight / out_proj, mlp.c_fc / c_proj,
ln_1 / ln_2, ls_1.gamma, class_embedding, positional_embedding, conv1, proj); the packed in_proj weight is torch's
(3E, E) layout.

The text tower (``TextTransformer``) is a causal-masked CLIP transformer over token ids with EOT (argmax) pooling and a
projection; its keys are the torch model's (token_embedding.weight, positional_embedding, transformer.resblocks.*,
ln_final, text_projection). A masked attention (``attn_mask``, an additive (L, L) fp32 mask) is the JAX package's
explicit einsum with fp32 logits and softmax (pe.py:180-184), so the text tower launches no kernel of ours. ``CLIP``
joins the two towers with a logit scale.
"""

import math
from dataclasses import asdict, dataclass, replace
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from uniception_tpu_torch.nn.blocks import LayerNorm
from uniception_tpu_torch.nn.common import ChannelsLastConv, flax_linear, gelu_exact
from uniception_tpu_torch.models.libs.perception_encoder.transformer import causal_mask, masked_attention
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention

__all__ = [
    "PEConfig",
    "PETextConfig",
    "PE_VISION_CONFIG",
    "PE_TEXT_CONFIG",
    "VisionTransformer",
    "TextTransformer",
    "CLIP",
    "PERope2D",
]


@dataclass
class PEConfig:
    "Vision tower config (reference config.py:29-52)."

    patch_size: int
    width: int
    layers: int
    heads: int
    mlp_ratio: float
    output_dim: Optional[int]
    ls_init_value: Optional[float] = None
    drop_path: float = 0.0
    image_size: int = 224
    use_abs_posemb: bool = True
    use_cls_token: bool = False
    use_rope2d: bool = True
    pool_type: str = "attn"
    attn_pooler_heads: int = 8
    use_ln_pre: bool = True
    use_ln_post: bool = True


PE_VISION_CONFIG = {}
PE_VISION_CONFIG["PE-Core-G14-448"] = PEConfig(
    image_size=448, patch_size=14, width=1536, layers=50, heads=16, mlp_ratio=8960 / 1536,
    pool_type="attn", output_dim=1280, use_cls_token=False,
)
PE_VISION_CONFIG["PE-Core-L14-336"] = PEConfig(
    image_size=336, patch_size=14, width=1024, layers=24, heads=16, mlp_ratio=4.0,
    pool_type="attn", output_dim=1024, use_cls_token=True,
)
PE_VISION_CONFIG["PE-Core-B16-224"] = PEConfig(
    image_size=224, patch_size=16, width=768, layers=12, heads=12, mlp_ratio=4.0,
    pool_type="attn", output_dim=1024, use_cls_token=True,
)
PE_VISION_CONFIG["PE-Lang-G14-448"] = replace(
    PE_VISION_CONFIG["PE-Core-G14-448"], image_size=448, pool_type="none", use_ln_post=False,
    output_dim=None, ls_init_value=0.1, layers=47,
)
PE_VISION_CONFIG["PE-Lang-L14-448"] = replace(
    PE_VISION_CONFIG["PE-Core-L14-336"], image_size=448, pool_type="none", use_ln_post=False,
    output_dim=None, ls_init_value=0.1, layers=23,
)
PE_VISION_CONFIG["PE-Spatial-G14-448"] = replace(
    PE_VISION_CONFIG["PE-Core-G14-448"], image_size=448, pool_type="none", use_ln_post=False, output_dim=None,
)


@dataclass
class PETextConfig:
    "Text tower config (reference config.py:56-67)."

    context_length: int
    width: int
    heads: int
    layers: int
    output_dim: int
    mlp_ratio: float = 4.0
    vocab_size: int = 49408


PE_TEXT_CONFIG = {}
PE_TEXT_CONFIG["PE-Core-G14-448"] = PETextConfig(context_length=72, width=1280, heads=20, layers=24, output_dim=1280)
PE_TEXT_CONFIG["PE-Core-L14-336"] = PETextConfig(context_length=32, width=1024, heads=16, layers=24, output_dim=1024)
PE_TEXT_CONFIG["PE-Core-B16-224"] = PE_TEXT_CONFIG["PE-Core-L14-336"]


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    "lucidrains' rotate_half on adjacent channel pairs (rope.py:36-41): (x0, x1) -> (-x1, x0)."
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def _apply_rotary_emb(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    "t * cos + rotate_half(t) * sin in fp32 (rope.py:44-63), rounded once to t's dtype."
    tf = t.float()
    return (tf * freqs.cos() + _rotate_half_interleaved(tf) * freqs.sin()).to(t.dtype)


class PERope2D:
    """Axial 2-D RoPE with interleaved pairs (reference rope.py:281-322), shared by every block. Its angle table is
    built once for each grid and device and kept: building it copies it from the host, which waits for the card."""

    def __init__(self, dim: int, use_cls_token: bool = False, theta: float = 10000.0):
        self.dim = dim  # head dim
        self.use_cls_token = use_cls_token
        self.theta = theta
        self._tables = {}  # (grid_h, grid_w, device) -> (1, N, 1, dim) angle table

    def freqs_for_grid(self, grid_h: int, grid_w: int, device=None) -> torch.Tensor:
        """(N, dim) fp32 angle table for a grid_h x grid_w patch grid, row-major: the x axis's frequencies, then the
        y axis's, each repeated over a channel pair; positions start at 1 behind a cls token, whose row is zeros.
        Computed in float64 and rounded once, as the JAX table is."""
        d_axis = self.dim // 2  # per-axis rot dim
        inv = 1.0 / self.theta ** (np.arange(0, d_axis, 2)[: d_axis // 2] / d_axis)
        offset = 1 if self.use_cls_token else 0
        fy = np.repeat((np.arange(grid_h) + offset)[:, None] * inv[None, :], 2, axis=-1)  # (H, d_axis)
        fx = np.repeat((np.arange(grid_w) + offset)[:, None] * inv[None, :], 2, axis=-1)  # (W, d_axis)
        freq = np.concatenate([np.broadcast_to(fx[None, :, :], (grid_h, grid_w, d_axis)),
                               np.broadcast_to(fy[:, None, :], (grid_h, grid_w, d_axis))], axis=-1)
        freq = freq.reshape(grid_h * grid_w, self.dim)
        if self.use_cls_token:
            freq = np.concatenate([np.zeros((1, self.dim)), freq], axis=0)
        return torch.tensor(freq, dtype=torch.float32, device=device)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, grid_hw):
        "q, k: (B, N, H, D) -> the rotated pair."
        key = (*grid_hw, q.device)
        if key not in self._tables:
            self._tables[key] = self.freqs_for_grid(*grid_hw, device=q.device)[None, :, None, :]  # (1, N, 1, D)
        freqs = self._tables[key]
        return _apply_rotary_emb(freqs, q), _apply_rotary_emb(freqs, k)


class SelfAttention(nn.Module):
    "Packed-qkv attention with PE's RoPE (pe.py:89-140), torch's (3E, E) in_proj layout."

    def __init__(self, embed_dim: int, num_heads: int, rope: Optional[PERope2D] = None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scale = self.head_dim**-0.5
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        nn.init.xavier_uniform_(self.in_proj_weight, generator=generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, device=device))
        self.out_proj = flax_linear(embed_dim, embed_dim, device=device, dtype=dtype, generator=generator)
        self.rope = rope

    def forward(self, x: torch.Tensor, grid_hw=None, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        "attn_mask: an optional additive (N, N) mask (torch's convention), computed as JAX does (no kernel)."
        B, N, E = x.shape
        proj = torch.nn.functional.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        # q/k/v stay strided views of the projection: K1 reads them by stride
        q, k, v = proj.reshape(B, N, 3, self.num_heads, self.head_dim).unbind(2)
        if self.rope is not None:
            q, k = self.rope(q, k, grid_hw)
        if attn_mask is not None:
            attn = masked_attention(q, k, v, self.scale, attn_mask)
        else:
            attn = scaled_dot_product_attention(q, k, v, scale=self.scale)
        return self.out_proj(attn.reshape(B, N, E))


class PELayerScale(nn.Module):
    "LayerScale with PE's parameter name (pe.py:33-44): x * gamma, gamma cast to x's dtype."

    def __init__(self, dim: int, init_values: float = 1e-5, *, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values), device=device))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class _PEMlp(nn.Module):
    "MLP with c_fc / c_proj key names and exact GELU (pe.py:172-181)."

    def __init__(self, d_model, mlp_width, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.c_fc = flax_linear(d_model, mlp_width, device=device, dtype=dtype, generator=generator)
        self.c_proj = flax_linear(mlp_width, d_model, device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.c_proj(gelu_exact(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    "PE transformer block (pe.py:142-204): pre-LN (eps 1e-5) attention and MLP, each with an optional LayerScale."

    def __init__(self, d_model, n_head, mlp_ratio=4.0, ls_init_value=None, rope=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.attn = SelfAttention(d_model, n_head, rope=rope, **kw)
        ls = (lambda: PELayerScale(d_model, ls_init_value, device=device)) if ls_init_value is not None else nn.Identity
        self.ls_1, self.ls_2 = ls(), ls()
        self.ln_1 = LayerNorm(d_model, eps=1e-5, device=device, dtype=dtype)
        self.ln_2 = LayerNorm(d_model, eps=1e-5, device=device, dtype=dtype)
        self.mlp = _PEMlp(d_model, int(d_model * mlp_ratio), **kw)

    def forward(self, x, grid_hw=None, attn_mask=None):
        x = x + self.ls_1(self.attn(self.ln_1(x), grid_hw=grid_hw, attn_mask=attn_mask))
        return x + self.ls_2(self.mlp(self.ln_2(x)))


class Transformer(nn.Module):
    "Stack of PE blocks (pe.py:207-301)."

    def __init__(self, width, layers, heads, mlp_ratio=4.0, ls_init_value=None, rope=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.width = width
        self.layers = layers
        self.resblocks = nn.ModuleList([
            ResidualAttentionBlock(width, heads, mlp_ratio, ls_init_value=ls_init_value, rope=rope, device=device,
                                   dtype=dtype, generator=generator)
            for _ in range(layers)
        ])

    def truncate(self, layer_idx: int):
        "Keep the blocks up to and including block ``layer_idx`` (negative counts from the end), as the reference."
        self.layers = ((self.layers + layer_idx) % self.layers) + 1
        self.resblocks = self.resblocks[: self.layers]

    def forward(self, x, grid_hw=None, layer_idx: int = -1, attn_mask=None):
        "Run the blocks up to and including block ``layer_idx``."
        stop_idx = (self.layers + layer_idx) % self.layers
        for i, blk in enumerate(self.resblocks):
            x = blk(x, grid_hw=grid_hw, attn_mask=attn_mask)
            if i == stop_idx:
                break
        return x

    def forward_intermediate(self, x, grid_hw=None, intermediate_layers: Union[int, List[int]] = 1, attn_mask=None):
        "The outputs of the blocks in ``intermediate_layers`` (an int n: the one block n from the end)."
        if isinstance(intermediate_layers, int):
            intermediate_layers = [len(self.resblocks) - intermediate_layers]
        outs = []
        for i, blk in enumerate(self.resblocks):
            x = blk(x, grid_hw=grid_hw, attn_mask=attn_mask)
            if i in intermediate_layers:
                outs.append(x)
        return outs


class _TorchMHA(nn.Module):
    "nn.MultiheadAttention-compatible cross attention (packed in_proj; JAX pe.py:270-297)."

    def __init__(self, embed_dim, num_heads, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        nn.init.xavier_uniform_(self.in_proj_weight, generator=generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, device=device))
        self.out_proj = flax_linear(embed_dim, embed_dim, device=device, dtype=dtype, generator=generator)

    def forward(self, q, k, v):
        E = self.embed_dim
        w, b = self.in_proj_weight.to(q.dtype), self.in_proj_bias.to(q.dtype)
        heads = lambda t: t.reshape(t.shape[0], t.shape[1], self.num_heads, self.head_dim)  # noqa: E731
        qp = heads(torch.nn.functional.linear(q, w[:E], b[:E]))
        kp = heads(torch.nn.functional.linear(k, w[E : 2 * E], b[E : 2 * E]))
        vp = heads(torch.nn.functional.linear(v, w[2 * E :], b[2 * E :]))
        out = scaled_dot_product_attention(qp, kp, vp)
        return self.out_proj(out.reshape(qp.shape[0], qp.shape[1], E))


class AttentionPooling(nn.Module):
    "Probe-token attention pool (pe.py:47-88)."

    def __init__(self, embed_dim, num_heads, num_probe=1, mlp_ratio=4, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.probe = nn.Parameter(torch.randn(1, num_probe, embed_dim, device=device, generator=generator))
        self.attn = _TorchMHA(embed_dim, num_heads, device=device, dtype=dtype, generator=generator)
        self.layernorm = LayerNorm(embed_dim, eps=1e-5, device=device, dtype=dtype)
        self.mlp = _PEMlp(embed_dim, int(embed_dim * mlp_ratio), device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        q = self.probe.to(x.dtype).expand(x.shape[0], *self.probe.shape[1:])
        x = self.attn(q, x, x)
        return x + self.mlp(self.layernorm(x))


class VisionTransformer(nn.Module):
    """PE vision transformer (pe.py:304-563). ``dtype`` is the compute dtype (None: the parameters'); the JAX module
    computes in its parameters' dtype."""

    def __init__(
        self,
        patch_size: int,
        width: int,
        layers: int,
        heads: int,
        mlp_ratio: float,
        use_ln_pre: bool = True,
        use_ln_post: bool = True,
        ls_init_value: Optional[float] = None,
        drop_path: float = 0.0,
        image_size: int = 448,
        use_abs_posemb: bool = True,
        use_rope2d: bool = True,
        use_cls_token: bool = False,
        output_dim: Optional[int] = 1280,
        attn_pooler_heads: int = 8,
        pool_type: str = "attn",
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if pool_type not in ("attn", "tok", "avg", "none"):
            raise ValueError(f"Unknown pool_type {pool_type!r}")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.pool_type = pool_type
        self.patch_size = patch_size
        self.output_dim = output_dim or width
        self.proj_dim = output_dim
        self.heads = heads
        self.width = width
        self.layers = layers
        self.use_abs_posemb = use_abs_posemb
        self.use_cls_token = use_cls_token
        self.use_rope2d = use_rope2d
        self.image_size = image_size

        self.conv1 = ChannelsLastConv(3, width, patch_size, stride=patch_size, bias=False, **kw)
        self.rope = PERope2D(dim=width // heads, use_cls_token=use_cls_token) if use_rope2d else None
        self.ln_pre = LayerNorm(width, eps=1e-5, device=device, dtype=dtype) if use_ln_pre else nn.Identity()
        self.ln_post = LayerNorm(width, eps=1e-5, device=device, dtype=dtype) if use_ln_post else nn.Identity()
        self.transformer = Transformer(width, layers, heads, mlp_ratio, ls_init_value=ls_init_value, rope=self.rope,
                                       **kw)
        self.attn_pool = AttentionPooling(width, attn_pooler_heads, **kw) if pool_type == "attn" else None

        init_scale = width**-0.5
        normal = lambda *shape: init_scale * torch.randn(*shape, device=device, generator=generator)  # noqa: E731
        if use_cls_token:
            self.class_embedding = nn.Parameter(normal(width))
        if use_abs_posemb:
            self.posemb_grid_size = image_size // patch_size
            self.positional_embedding = nn.Parameter(normal(int(use_cls_token) + self.posemb_grid_size**2, width))
        if self.proj_dim is not None:
            self.proj = nn.Parameter(normal(width, self.proj_dim))

    @classmethod
    def from_config(cls, name: str, pretrained: bool = False, checkpoint_path: Optional[str] = None, **kwargs):
        "Build a PE_VISION_CONFIG entry (``kwargs`` override it); ``pretrained`` loads ``checkpoint_path``, strictly."
        if name not in PE_VISION_CONFIG:
            raise RuntimeError(f"{name} not found in configs.")
        args = asdict(PE_VISION_CONFIG[name])
        args.update(kwargs)
        model = cls(**args)
        if pretrained:
            if checkpoint_path is None:
                raise ValueError("offline build: pass checkpoint_path explicitly")
            from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

            load_encoder_checkpoint(model, checkpoint_path, kept_blocks={"transformer.resblocks.": model.layers})
        return model

    def truncate(self, layer_idx: int):
        self.transformer.truncate(layer_idx)
        self.layers = self.transformer.layers

    def _sample_abs_posemb(self, grid_h: int, grid_w: int, dtype) -> torch.Tensor:
        """The (1, N, width) PE for a grid_h x grid_w grid: the table as it is on its own grid, else its patch part
        resized bilinearly (align_corners False, in fp32; pe.py:458-479), the cls row kept."""
        pe = self.positional_embedding.float()
        if self.posemb_grid_size == grid_h and self.posemb_grid_size == grid_w:
            return pe[None].to(dtype)
        cls_pe = None
        if self.use_cls_token:
            cls_pe, pe = pe[:1], pe[1:]
        g = self.posemb_grid_size
        grid = pe.reshape(1, g, g, -1).permute(0, 3, 1, 2)
        grid = torch.nn.functional.interpolate(grid, size=(grid_h, grid_w), mode="bilinear", align_corners=False)
        pe = grid.permute(0, 2, 3, 1).reshape(-1, self.width)
        if cls_pe is not None:
            pe = torch.cat([cls_pe, pe], dim=0)
        return pe[None].to(dtype)

    def _embed(self, x: torch.Tensor):
        B, _, h, w = x.shape
        grid_h, grid_w = h // self.patch_size, w // self.patch_size
        x = self.conv1(x.permute(0, 2, 3, 1)).reshape(B, grid_h * grid_w, self.width)
        if self.use_cls_token:
            x = torch.cat([self.class_embedding.to(x.dtype).reshape(1, 1, -1).expand(B, 1, self.width), x], dim=1)
        if self.use_abs_posemb:
            x = x + self._sample_abs_posemb(grid_h, grid_w, x.dtype)
        return self.ln_pre(x), (grid_h, grid_w)

    def forward_features(self, x: torch.Tensor, norm: bool = False, layer_idx: int = -1,
                         strip_cls_token: bool = False) -> torch.Tensor:
        x, grid_hw = self._embed(x)
        x = self.transformer(x, grid_hw=grid_hw, layer_idx=layer_idx)
        if norm:
            x = self.ln_post(x)
        if strip_cls_token and self.use_cls_token:
            x = x[:, 1:]
        return x

    def get_intermediate_layers(self, x: torch.Tensor, n: Union[int, List[int]] = 1, norm: bool = True,
                                strip_cls_token: bool = False) -> list:
        x, grid_hw = self._embed(x)
        outs = self.transformer.forward_intermediate(x, grid_hw=grid_hw, intermediate_layers=n)
        if norm:
            outs = [self.ln_post(o) for o in outs]
        if strip_cls_token and self.use_cls_token:
            outs = [o[:, 1:] for o in outs]
        return outs

    def _pool(self, x):
        if self.pool_type == "tok":
            return x[:, 0]
        if self.pool_type == "avg":
            return x.mean(dim=1)
        if self.pool_type == "attn":
            return self.attn_pool(x)[:, 0]
        return x

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        "The pooled (and projected) image embedding."
        x = self._pool(self.forward_features(x, norm=True, **kwargs))
        return x @ self.proj.to(x.dtype) if self.proj_dim is not None else x


class TextTransformer(nn.Module):
    """The CLIP text tower (pe.py:463-556): token and position embeddings, causal-masked PE blocks (no RoPE), the final
    LayerNorm, a pool (``argmax``: each row's EOT, its highest id; ``first``, ``last`` or ``none``) and the projection
    (a (width, output_dim) matrix, or a linear layer with ``proj_bias``). ``dtype`` is the compute dtype (None: the
    parameters'); the JAX module computes in its parameters' dtype."""

    def __init__(self, context_length: int = 72, vocab_size: int = 49408, width: int = 512, heads: int = 8,
                 layers: int = 12, mlp_ratio: float = 4.0, ls_init_value: Optional[float] = None,
                 output_dim: int = 1280, no_causal_mask: bool = False, pad_id: int = 0, pool_type: str = "argmax", proj_bias: bool = False,
                 output_tokens: bool = False, use_ln_post: bool = True, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, **_ignore):
        super().__init__()
        assert pool_type in ("first", "last", "argmax", "none")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.pool_type = pool_type
        self.output_tokens = output_tokens
        self.num_pos = self.context_length = context_length
        self.vocab_size = vocab_size
        self.width = width
        self.output_dim = output_dim
        self.heads = heads
        self.pad_id = pad_id
        self.layers = layers
        self.causal = not no_causal_mask
        self.compute_dtype = dtype

        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        with torch.no_grad():  # flax's Embed init: variance 1 / width
            self.token_embedding.weight.normal_(0.0, width**-0.5, generator=generator)
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(self.num_pos, width, device=device,
                                                                    generator=generator))
        self.transformer = Transformer(width, layers, heads, mlp_ratio, ls_init_value=ls_init_value, **kw)
        self.ln_final = LayerNorm(width, eps=1e-5, device=device, dtype=dtype) if use_ln_post else nn.Identity()
        if proj_bias:
            self.text_projection = flax_linear(width, output_dim, **kw)
        else:
            self.text_projection = nn.Parameter(width**-0.5 * torch.randn(width, output_dim, device=device,
                                                                          generator=generator))

    def text_global_pool(self, x: torch.Tensor, text: Optional[torch.Tensor] = None, pool_type: str = "argmax"):
        "(pooled, tokens) by ``pool_type`` (pe.py:516-528); ``argmax`` takes each row's highest id, the EOT token."
        if pool_type == "first":
            return x[:, 0], x[:, 1:]
        if pool_type == "last":
            return x[:, -1], x[:, :-1]
        if pool_type == "argmax":
            assert text is not None
            return x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)], x
        return x, x

    def forward(self, text: torch.Tensor):
        "text: (B, L) token ids -> the (B, output_dim) pooled embedding (and the tokens with ``output_tokens``)."
        seq_len = text.shape[1]
        x = self.token_embedding(text)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        attn_mask = causal_mask(seq_len, x.device) if self.causal else None
        x = x + self.positional_embedding[:seq_len].to(x.dtype)
        x = self.ln_final(self.transformer(x, attn_mask=attn_mask))
        pooled, tokens = self.text_global_pool(x, text, pool_type=self.pool_type)
        if isinstance(self.text_projection, nn.Module):
            pooled = self.text_projection(pooled)
        else:
            pooled = pooled @ self.text_projection.to(pooled.dtype)
        return (pooled, tokens) if self.output_tokens else pooled


def _l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=axis, keepdim=True).clamp_min(eps)


class CLIP(TextTransformer):
    """The joint image-text model (pe.py:563-608): the text tower itself, ``visual`` (the vision tower) and the logit
    scale. ``dtype`` is the compute dtype of both towers (None: the parameters'), ``generator`` draws the weights."""

    def __init__(self, vision_cfg: PEConfig, text_cfg: PETextConfig, init_logit_scale: float = math.log(1 / 0.07), *,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        kw = dict(device=device, dtype=dtype, generator=generator)
        super().__init__(**text_cfg.__dict__, **kw)
        self.visual = VisionTransformer(**vision_cfg.__dict__, **kw)
        self.image_size = self.visual.image_size
        self.logit_scale = nn.Parameter(torch.tensor(init_logit_scale, device=device))

    def encode_image(self, image: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        x = self.visual(image)
        return _l2_normalize(x) if normalize else x

    def encode_video(self, video: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        "video: (B, N, C, H, W) -> the mean of the frames' embeddings."
        b, n, c, h, w = video.shape
        feats = self.encode_image(video.reshape(b * n, c, h, w), normalize=normalize)
        return feats.reshape(b, n, -1).mean(dim=1)

    def encode_text(self, text: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        x = TextTransformer.forward(self, text)
        return _l2_normalize(x) if normalize else x

    def forward(self, image: Optional[torch.Tensor] = None, text: Optional[torch.Tensor] = None):
        "(normalized image features or None, normalized text features or None, exp(logit_scale))."
        image_features = self.encode_image(image, normalize=True) if image is not None else None
        text_features = self.encode_text(text, normalize=True) if text is not None else None
        return image_features, text_features, self.logit_scale.exp()

    @classmethod
    def from_config(cls, name: str, pretrained: bool = False, checkpoint_path: Optional[str] = None, **kwargs):
        """Build the CLIP of a name in both PE_VISION_CONFIG and PE_TEXT_CONFIG; ``kwargs`` are the constructor's
        (device, dtype, generator). ``pretrained`` loads ``checkpoint_path`` strictly (its ``state_dict`` or
        ``weights`` entry where it has one, "module." prefixes dropped); without a file it raises."""
        if name not in PE_VISION_CONFIG or name not in PE_TEXT_CONFIG:
            raise RuntimeError(f"{name} not found in configs.")
        if pretrained and checkpoint_path is None:
            raise ValueError(f"offline build: the {name} CLIP checkpoint is not in the repository; pass "
                             "checkpoint_path explicitly")
        model = cls(PE_VISION_CONFIG[name], PE_TEXT_CONFIG[name], **kwargs)
        if pretrained:
            from uniception_tpu_torch.utils.checkpoint import load_checkpoint
            from uniception_tpu_torch.utils.weights import load_state_dict_numpy

            sd = load_checkpoint(checkpoint_path)
            sd = next(sd[k] for k in ("state_dict", "weights", "model") if k in sd)
            load_state_dict_numpy(model, {k.replace("module.", ""): v for k, v in sd.items()})
        return model

    @classmethod
    def available_configs(cls):
        return [k for k in PE_VISION_CONFIG if k in PE_TEXT_CONFIG]
