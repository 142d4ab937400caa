"""
DINOv3 encoders, the ViT and the ConvNeXt (counterpart of uniception_tpu/models/encoders/dinov3.py; reference
uniception/models/encoders/dinov3.py:20-574).

The ViT trunk, as the JAX package builds it: patch 16, a cls token and 4 storage tokens, no PE table, 2-D RoPE
(base 100, the quarter layout of ops/rope.py) on the patch tokens only, LayerScale (init 1), qkv bias, the MLP
(``small``, ``base``, ``large``) or the SwiGLU-fused FFN (``small+``, ``huge+``, ``7b``), LayerNorm eps 1e-5. On the
card the RoPE is K2 on the view ``q[:, 5:]`` (K2 reads it through its strides; no copy) and the attention K1: heads
of 64, and of 128 at ``7b`` (4096 / 32).

The ConvNeXt trunk (tiny / small / base / large) keeps JAX's channels-last activations: a depthwise 7x7 conv, a
LayerNorm over the channels (the last dim), the pointwise linears and the LayerScale ``gamma``; features at stride
32. State-dict keys are the JAX modules' (``model.patch_embed.weight``, ``model.storage_tokens``,
``model.downsample_layers.0.0.weight``, ``model.stages.0.0.gamma``, ...).
"""

from typing import List, Optional, Union

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import UniCeptionViTEncoderBase, ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.models.utils.intermediate_feature_return import (
    IntermediateFeatureReturner,
    feature_take_indices,
)
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.nn.blocks import LayerNorm, Mlp, SelfAttentionBlock, SwiGLUFFNFused, layer_norm_factory
from uniception_tpu_torch.nn.common import ChannelsLastConv, flax_linear, gelu_exact, remat_call
from uniception_tpu_torch.ops.rope import Rope2D
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = [
    "DINOv3Encoder",
    "DINOv3IntermediateFeatureReturner",
    "DINOv3ConvNextEncoder",
    "DINOv3ConvNextIntermediateFeatureReturner",
    "DINOV3_VIT_CONFIGS",
    "CONVNEXT_CONFIGS",
]

DINOV3_VIT_CONFIGS = {
    "small": dict(embed_dim=384, depth=12, num_heads=6, ffn="mlp"),
    "small+": dict(embed_dim=384, depth=12, num_heads=6, ffn="swiglu"),
    "base": dict(embed_dim=768, depth=12, num_heads=12, ffn="mlp"),
    "large": dict(embed_dim=1024, depth=24, num_heads=16, ffn="mlp"),
    "huge+": dict(embed_dim=1280, depth=32, num_heads=20, ffn="swiglu"),
    "7b": dict(embed_dim=4096, depth=40, num_heads=32, ffn="swiglu"),
}

CONVNEXT_CONFIGS = {
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}


class PrefixedRope2D:
    """RoPE2D on the tokens after the first ``n_prefix`` (cls and storage), which stay unrotated (JAX
    dinov3.py:81-87): tokens (B, N, H, D), positions (B, N - n_prefix, 2). The rotation is :class:`Rope2D`'s (K2 on
    a CUDA tensor, the plain version on the CPU or under "naive"), applied to the strided view of the patch tokens.
    Not a :class:`Rope2D`, so the fused contract does not take these layers, as in JAX."""

    def __init__(self, n_prefix: int, freq: float = 100.0):
        self.n_prefix = n_prefix
        self.rope = Rope2D(freq=freq)

    def __call__(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        n = self.n_prefix
        return torch.cat([tokens[:, :n], self.rope(tokens[:, n:], positions)], dim=1)


class _DINOv3ViT(nn.Module):
    "DINOv3-style ViT trunk: RoPE attention, cls + storage tokens, no patch PE (JAX dinov3.py:60-133)."

    def __init__(self, patch_size, embed_dim, depth, num_heads, ffn, n_storage_tokens=4, gradient_checkpointing=False,
                 *, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = layer_norm_factory(eps=1e-5)
        self.embed_dim = embed_dim
        self.depth = depth
        self.patch_size = patch_size
        self.n_storage_tokens = n_storage_tokens
        self.gradient_checkpointing = gradient_checkpointing
        self.patch_embed = ChannelsLastConv(3, embed_dim, patch_size, stride=patch_size, device=device, dtype=dtype,
                                            generator=generator)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.storage_tokens = nn.Parameter(torch.zeros(1, n_storage_tokens, embed_dim, device=device))
        rope = PrefixedRope2D(1 + n_storage_tokens, freq=100.0)
        mlp_layer = Mlp if ffn == "mlp" else SwiGLUFFNFused
        self.blocks = nn.ModuleList([
            SelfAttentionBlock(embed_dim, num_heads, qkv_bias=True, init_values=1.0, norm_layer=norm_layer,
                               mlp_layer=mlp_layer, custom_positional_encoding=rope, device=device, dtype=dtype,
                               generator=generator)
            for _ in range(depth)
        ])
        self.norm = norm_layer(embed_dim, device=device, dtype=dtype)

    def forward_tokens(self, image_bchw: torch.Tensor, n_blocks: Optional[int] = None, collect_indices=()):
        "Run the first ``n_blocks`` blocks (all: None); returns (tokens, {i: pre-norm tokens after block i}, (hp, wp))."
        B = image_bchw.shape[0]
        x = self.patch_embed(image_bchw.permute(0, 2, 3, 1))  # (B, hp, wp, C)
        hp, wp = x.shape[1:3]
        x = x.reshape(B, hp * wp, self.embed_dim)
        prefix = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim),
                            self.storage_tokens.to(x.dtype).expand(B, self.n_storage_tokens, self.embed_dim)], dim=1)
        x = torch.cat([prefix, x], dim=1)
        pos = make_patch_positions(B, hp, wp, device=x.device)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        collected = {}
        for i, blk in enumerate(self.blocks[: self.depth if n_blocks is None else n_blocks]):
            x = remat_call(blk, x, pos) if remat else blk(x, pos)
            if i in collect_indices:
                collected[i] = x
        return x, collected, (hp, wp)

    def split_tokens(self, x: torch.Tensor):
        "tokens -> (cls, storage, patches)."
        r = self.n_storage_tokens
        return x[:, 0], x[:, 1 : 1 + r], x[:, 1 + r :]

    def forward_features(self, image_bchw: torch.Tensor) -> dict:
        x, _, grid = self.forward_tokens(image_bchw)
        cls_tok, reg_tok, patch_tok = self.split_tokens(self.norm(x))
        return {"x_norm_clstoken": cls_tok, "x_norm_regtokens": reg_tok, "x_norm_patchtokens": patch_tok,
                "grid_hw": grid}


class DINOv3Encoder(UniCeptionViTEncoderBase):
    "UniCeption DINOv3 ViT encoder: BCHW patch features at stride 16."

    def __init__(
        self,
        name: str,
        dinov3_repo_dir: Optional[str] = None,  # accepted for API parity; unused (self-contained)
        data_norm_type: str = "dinov3",
        patch_size: int = 16,
        size: str = "large",
        weights: Optional[str] = None,
        pretrained_checkpoint_path: Optional[str] = None,
        gradient_checkpointing: bool = False,
        keep_first_n_layers: Optional[int] = None,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        **_compat_kwargs,
    ):
        super().__init__(name=name, data_norm_type=data_norm_type, patch_size=patch_size,
                         gradient_checkpointing=gradient_checkpointing)
        if size not in DINOV3_VIT_CONFIGS:
            raise ValueError(f"Unknown DINOv3 size {size!r}: one of {sorted(DINOV3_VIT_CONFIGS)}")
        self.version = size
        cfg = DINOV3_VIT_CONFIGS[size]
        self.enc_embed_dim = cfg["embed_dim"]
        # keep_first_n_layers builds only those blocks: the first blocks of the full trunk, as JAX's slice
        depth = cfg["depth"] if keep_first_n_layers is None else min(keep_first_n_layers, cfg["depth"])
        self.model = _DINOv3ViT(patch_size, cfg["embed_dim"], depth, cfg["num_heads"], cfg["ffn"],
                                gradient_checkpointing=gradient_checkpointing, device=device, dtype=dtype,
                                generator=generator)
        self.to(param_dtype)
        for path in (weights, pretrained_checkpoint_path):
            if path:
                print(f"Loading DINOv3 checkpoint from {path}")
                load_encoder_checkpoint(self, path, kept_blocks={"model.blocks.": depth})

    def _check_image(self, image: torch.Tensor):
        if image.dim() != 4 or image.shape[1] != 3:
            raise ValueError(f"Input must be of shape (B, 3, H, W), got {tuple(image.shape)}")
        height, width = image.shape[-2:]
        if height % self.patch_size or width % self.patch_size:
            raise ValueError(f"Input shape must be divisible by patch size: {self.patch_size}")
        return height, width

    def _to_bchw(self, tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
        B = tokens.shape[0]
        hp, wp = height // self.patch_size, width // self.patch_size
        return tokens.reshape(B, hp, wp, self.enc_embed_dim).permute(0, 3, 1, 2)

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        height, width = self._check_image(encoder_input.image)
        feats = self.model.forward_features(encoder_input.image)["x_norm_patchtokens"]
        return ViTEncoderOutput(features=self._to_bchw(feats, height, width))


class DINOv3IntermediateFeatureReturner(DINOv3Encoder, IntermediateFeatureReturner):
    "DINOv3 ViT encoder returning the patch features after the blocks in ``indices`` (reference dinov3.py:157-...)."

    def __init__(self, *args, indices: Optional[Union[int, List[int]]] = 1, norm_intermediate: bool = True,
                 **kwargs):
        DINOv3Encoder.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(self, indices=indices, norm_intermediate=norm_intermediate)

    def forward(self, encoder_input: ViTEncoderInput) -> List[ViTEncoderOutput]:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        height, width = self._check_image(encoder_input.image)
        take_indices, max_index = feature_take_indices(self.model.depth, self.indices)
        _, collected, _ = self.model.forward_tokens(encoder_input.image, n_blocks=max_index + 1,
                                                    collect_indices=set(take_indices))
        outs = []
        for i in take_indices:
            tokens = self.model.norm(collected[i]) if self.norm_intermediate else collected[i]
            outs.append(ViTEncoderOutput(features=self._to_bchw(self.model.split_tokens(tokens)[2], height, width)))
        return outs


# ---------------------------------------------------------------------------
# ConvNeXt
# ---------------------------------------------------------------------------


class _ConvNextBlock(nn.Module):
    "ConvNeXt block on channels-last activations: dw7x7 -> LN -> pw 4x -> exact GELU -> pw -> gamma, residual."

    def __init__(self, dim, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dwconv = ChannelsLastConv(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = LayerNorm(dim, eps=1e-6, device=device, dtype=dtype)
        self.pwconv1 = flax_linear(dim, 4 * dim, **kw)
        self.pwconv2 = flax_linear(4 * dim, dim, **kw)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6, device=device))

    def forward(self, x):
        y = self.pwconv2(gelu_exact(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + y * self.gamma.to(y.dtype)


class _ConvNext(nn.Module):
    "ConvNeXt trunk with its four stage outputs (final stride 32; JAX dinov3.py:227-269)."

    def __init__(self, depths, dims, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        ln = dict(eps=1e-6, device=device, dtype=dtype)
        self.dims = dims
        self.downsample_layers = nn.ModuleList([
            nn.ModuleList([ChannelsLastConv(3, dims[0], 4, stride=4, **kw), LayerNorm(dims[0], **ln)])
        ])
        for i in range(3):
            self.downsample_layers.append(nn.ModuleList([LayerNorm(dims[i], **ln),
                                                         ChannelsLastConv(dims[i], dims[i + 1], 2, stride=2, **kw)]))
        self.stages = nn.ModuleList([nn.ModuleList([_ConvNextBlock(dims[i], **kw) for _ in range(depths[i])])
                                     for i in range(4)])
        self.norm = LayerNorm(dims[-1], **ln)

    def stage_outputs(self, image_bchw: torch.Tensor) -> list:
        "The four stages' channels-last outputs (B, H / 4s, W / 4s, C_s), s = 1, 2, 4, 8."
        x = image_bchw.permute(0, 2, 3, 1)
        outs = []
        for i in range(4):
            for layer in self.downsample_layers[i]:
                x = layer(x)
            for blk in self.stages[i]:
                x = blk(x)
            outs.append(x)
        return outs

    def forward_features(self, image_bchw: torch.Tensor) -> dict:
        out = self.stage_outputs(image_bchw)[-1]  # (B, H/32, W/32, C)
        B, h, w, C = out.shape
        return {"x_norm_patchtokens": self.norm(out.reshape(B, h * w, C)), "grid_hw": (h, w)}


class DINOv3ConvNextEncoder(UniCeptionViTEncoderBase):
    "UniCeption DINOv3 ConvNeXt encoder: BCHW features on the stride-32 grid (final_layer_patch_size = 32)."

    def __init__(
        self,
        name: str,
        dinov3_repo_dir: Optional[str] = None,
        data_norm_type: str = "dinov3",
        patch_size: int = 16,
        size: str = "large",
        weights: Optional[str] = None,
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        **_compat_kwargs,
    ):
        super().__init__(name=name, data_norm_type=data_norm_type, patch_size=patch_size)
        if size not in CONVNEXT_CONFIGS:
            raise ValueError(f"Unknown DINOv3 ConvNeXt size {size!r}: one of {sorted(CONVNEXT_CONFIGS)}")
        self.version = size
        self.final_layer_patch_size = 32
        cfg = CONVNEXT_CONFIGS[size]
        self.enc_embed_dim = cfg["dims"][-1]
        self.model = _ConvNext(cfg["depths"], cfg["dims"], device=device, dtype=dtype, generator=generator)
        self.to(param_dtype)
        for path in (weights, pretrained_checkpoint_path):
            if path:
                print(f"Loading DINOv3 ConvNeXt checkpoint from {path}")
                load_encoder_checkpoint(self, path)

    def _check_image(self, image: torch.Tensor):
        if image.dim() != 4 or image.shape[1] != 3:
            raise ValueError(f"Input must be of shape (B, 3, H, W), got {tuple(image.shape)}")
        if image.shape[2] % self.patch_size or image.shape[3] % self.patch_size:
            raise ValueError(f"Input shape must be divisible by patch size: {self.patch_size}")

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        image = encoder_input.image
        self._check_image(image)
        B, _, height, width = image.shape
        tokens = self.model.forward_features(image)["x_norm_patchtokens"]
        hp, wp = height // self.final_layer_patch_size, width // self.final_layer_patch_size
        return ViTEncoderOutput(features=tokens.reshape(B, hp, wp, -1).permute(0, 3, 1, 2))


class DINOv3ConvNextIntermediateFeatureReturner(DINOv3ConvNextEncoder, IntermediateFeatureReturner):
    """DINOv3 ConvNeXt returning the stage outputs in ``indices`` (all four by default), BCHW, unnormalized as in
    JAX (reference dinov3.py:371-...)."""

    def __init__(self, *args, indices: Optional[Union[int, List[int]]] = None, norm_intermediate: bool = True,
                 **kwargs):
        DINOv3ConvNextEncoder.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(self, indices=indices, norm_intermediate=norm_intermediate)

    def forward(self, encoder_input: ViTEncoderInput) -> List[ViTEncoderOutput]:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        self._check_image(encoder_input.image)
        take_indices, _ = feature_take_indices(4, self.indices)
        outs = self.model.stage_outputs(encoder_input.image)
        return [ViTEncoderOutput(features=outs[i].permute(0, 3, 1, 2)) for i in take_indices]
