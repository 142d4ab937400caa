"""
Global-attention info-sharing transformers (counterpart of
uniception_tpu/models/info_sharing/global_attention_transformer.py; reference
global_attention_transformer.py:25-1205).

* :class:`MultiViewGlobalAttentionTransformer` (+IFR): one token stream, the
  concatenation of every view's tokens (+ optional per-view and global extra
  tokens), run through self-attention blocks; the reference view and the
  other views get sinusoid view-index encodings.
* :class:`GlobalAttentionTransformer`: the multi-set variant, where each set
  may have its own token count, with set-index encodings.

Random view or set indices take an explicit ``torch.Generator`` (the JAX
package's ``rng_key``); without one the indices are sequential. The sinusoid
tables are non-persistent buffers: computed at construction, never loaded.
Loop layout only. ``dtype`` is the compute dtype; ``gradient_checkpointing``
recomputes each block's activations in the backward.

The blocks take the JAX package's options: qk-norm, LayerScale
(``init_values``), stochastic depth, dropout and ``mlp_layer`` (Mlp or
SwiGLUFFNFused), so a transformer initialised from DINOv2 blocks
(``convert_dino_to_info_sharing``) loads strict. As in the JAX package,
``act_layer`` is accepted and not passed to the blocks (they use GELU).

Global attention over V*T tokens is K1's longest sequence: 4 views of
512x512 are 4096 tokens in one attention call per layer.
"""

from typing import Callable, List, Optional, Tuple, Union

import torch

from uniception_tpu_torch.models.encoders.pe_utils import sinusoid_encoding_table
from uniception_tpu_torch.models.info_sharing.base import (
    MultiSetTransformerInput,
    MultiSetTransformerOutput,
    MultiViewTransformerInput,
    MultiViewTransformerOutput,
    UniCeptionInfoSharingBase,
)
from uniception_tpu_torch.models.utils.intermediate_feature_return import (
    IntermediateFeatureReturner,
    feature_take_indices,
)
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.nn.blocks import Mlp, SelfAttentionBlock, layer_norm_factory
from uniception_tpu_torch.nn.common import Identity, LinearX, remat_call
from uniception_tpu_torch.ops.rope import Rope2D
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

__all__ = [
    "MultiViewGlobalAttentionTransformer",
    "MultiViewGlobalAttentionTransformerIFR",
    "GlobalAttentionTransformer",
]


def _pe_table(n: int, dim: int, device) -> torch.Tensor:
    "The (n, dim) fp32 sinusoid index table (base 10000), on ``device`` (host memory, whatever the default device)."
    table = torch.from_numpy(sinusoid_encoding_table(n, dim, 10000.0))
    return table if device is None else table.to(device)


def _random_indices(n: int, high: int, generator: torch.Generator, device) -> torch.Tensor:
    "n indices drawn uniformly from [1, high) by ``generator``, on ``device``."
    return torch.randint(1, high, (n,), generator=generator, device=generator.device).to(device)


class _GlobalAttentionBase(UniCeptionInfoSharingBase):
    "Shared constructor of the global-attention transformers."

    def __init__(
        self,
        name: str,
        input_embed_dim: int,
        size: Optional[str] = None,
        depth: int = 12,
        dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_norm: bool = False,
        proj_drop: float = 0.0,
        attn_drop: float = 0.0,
        init_values: Optional[float] = None,
        drop_path: float = 0.0,
        act_layer: Optional[Callable] = None,
        norm_layer: Optional[Callable] = None,
        mlp_layer=Mlp,
        custom_positional_encoding: Optional[Union[str, Callable]] = None,
        use_scalable_softmax: bool = False,
        use_entropy_scaling: bool = False,
        base_token_count_for_entropy_scaling: int = 444,
        entropy_scaling_growth_factor: float = 1.4,
        pretrained_checkpoint_path: Optional[str] = None,
        gradient_checkpointing: bool = False,
        scan_blocks: bool = False,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(name=name)
        if scan_blocks:
            raise NotImplementedError("scan_blocks is XLA-only (nn/scan.py); the port runs the loop layout")
        norm_layer = norm_layer or layer_norm_factory(eps=1e-6)

        self.size = size
        self.input_embed_dim = input_embed_dim
        self.depth = depth
        self.dim = dim
        self.num_heads = num_heads
        self.gradient_checkpointing = gradient_checkpointing
        self.pretrained_checkpoint_path = pretrained_checkpoint_path

        if input_embed_dim != dim:
            self.proj_embed = LinearX(input_embed_dim, dim, device=device, dtype=dtype, generator=generator)
        else:
            self.proj_embed = Identity()

        # string-configured "rope" (reference global_attention_transformer.py:129-134)
        if isinstance(custom_positional_encoding, str):
            if custom_positional_encoding != "rope":
                raise ValueError(f"Unknown custom positional encoding: {custom_positional_encoding}")
            custom_positional_encoding = self.rope = Rope2D(freq=100.0, F0=1.0)
        self.custom_positional_encoding = custom_positional_encoding

        self.self_attention_blocks = torch.nn.ModuleList([
            SelfAttentionBlock(
                dim,
                num_heads,
                mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias,
                qk_norm=qk_norm,
                proj_drop=proj_drop,
                attn_drop=attn_drop,
                init_values=init_values,
                drop_path=drop_path,
                norm_layer=norm_layer,
                mlp_layer=mlp_layer,
                device=device,
                dtype=dtype,
                generator=generator,
                custom_positional_encoding=custom_positional_encoding,
                use_scalable_softmax=use_scalable_softmax,
                use_entropy_scaling=use_entropy_scaling,
                base_token_count_for_entropy_scaling=base_token_count_for_entropy_scaling,
                entropy_scaling_growth_factor=entropy_scaling_growth_factor,
            )
            for _ in range(depth)
        ])
        self.norm = norm_layer(dim, device=device, dtype=dtype)

    def _load_pretrained(self):
        "The pretrained weights; the load skips the sinusoid tables (non-persistent buffers, recomputed; JAX :146-151)."
        if self.pretrained_checkpoint_path is not None:
            print(f"Loading pretrained global-attention transformer weights from {self.pretrained_checkpoint_path} ...")
            ckpt = load_checkpoint(self.pretrained_checkpoint_path)
            load_state_dict_numpy(self, ckpt["model"])

    def _block_apply(self, blk, x, pos):
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return remat_call(blk, x, pos)
        return blk(x, pos)

    def _depth(self, depth_idx, blk, tokens, pos, meta):
        "One depth over the whole stream (the alternating transformer runs frame attention at odd depths)."
        return self._block_apply(blk, tokens, pos)

    def _run_blocks(self, tokens, pos, meta=None, collect: bool = False, take_indices=None):
        """Every depth in order. With ``collect`` also returns {depth: tokens} for the depths in ``take_indices``
        (all when None), so intermediate returns keep only the depths asked for."""
        keep = range(self.depth) if take_indices is None else set(take_indices)
        ys = {}
        for depth_idx, blk in enumerate(self.self_attention_blocks):
            tokens = self._depth(depth_idx, blk, tokens, pos, meta)
            if collect and depth_idx in keep:
                ys[depth_idx] = tokens
        return (tokens, ys) if collect else tokens


class MultiViewGlobalAttentionTransformer(_GlobalAttentionBase):
    "Multi-view global-attention transformer (VGGT-style single stream)."

    def __init__(
        self,
        name: str,
        input_embed_dim: int,
        distinguish_ref_and_non_ref_views: bool = True,
        use_pe_for_non_reference_views: bool = True,
        max_num_views_for_pe: int = 1000,
        use_rand_idx_pe_for_non_reference_views: bool = True,
        **kwargs,
    ):
        super().__init__(name=name, input_embed_dim=input_embed_dim, **kwargs)
        self.distinguish_ref_and_non_ref_views = distinguish_ref_and_non_ref_views
        self.use_pe_for_non_reference_views = use_pe_for_non_reference_views
        self.max_num_views_for_pe = max_num_views_for_pe
        self.use_rand_idx_pe_for_non_reference_views = use_rand_idx_pe_for_non_reference_views
        if distinguish_ref_and_non_ref_views:
            n = max_num_views_for_pe if use_pe_for_non_reference_views else 1
            self.register_buffer("view_pos_table", _pe_table(n, self.dim, kwargs.get("device")), persistent=False)
        self._load_pretrained()

    def _nonref_pe_indices(self, num_views: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        "The view-index rows of views 1..V-1: random in [1, max_num_views_for_pe) with a generator, else 1..V-1."
        device = self.view_pos_table.device
        if self.use_rand_idx_pe_for_non_reference_views and generator is not None:
            return _random_indices(num_views - 1, self.max_num_views_for_pe, generator, device)
        return torch.arange(1, num_views, device=device)

    def _prepare_tokens(self, model_input: MultiViewTransformerInput, generator):
        "One (B, V*T + G, dim) stream with the view-index encodings added, its positions, and its layout."
        feats = model_input.features
        num_views = len(feats)
        if num_views > self.max_num_views_for_pe:
            raise ValueError(f"{num_views} views; the view-index encoding covers {self.max_num_views_for_pe}")
        if not all(f.dim() == 4 and f.shape[1] == self.input_embed_dim for f in feats):
            raise ValueError(f"All views must be (N, {self.input_embed_dim}, H, W)")

        B, _, H, W = feats[0].shape
        view_tokens = [f.permute(0, 2, 3, 1).reshape(B, H * W, self.input_embed_dim) for f in feats]
        n_extra_per_view = 0
        if model_input.additional_input_tokens_per_view is not None:
            extra_pv = model_input.additional_input_tokens_per_view
            if len(extra_pv) != num_views:
                raise ValueError(f"{len(extra_pv)} per-view extra token sets for {num_views} views")
            n_extra_per_view = extra_pv[0].shape[2]
            view_tokens = [torch.cat([vt, t.transpose(1, 2)], dim=1) for vt, t in zip(view_tokens, extra_pv)]
        tokens = torch.cat(view_tokens, dim=1)  # (B, V * (HW + T_extra), C)
        n_tok_per_view = H * W + n_extra_per_view

        n_global = 0
        if model_input.additional_input_tokens is not None:
            extra = model_input.additional_input_tokens.transpose(1, 2)
            n_global = extra.shape[1]
            tokens = torch.cat([tokens, extra], dim=1)

        tokens = self.proj_embed(tokens)

        pos = None
        if self.custom_positional_encoding is not None:
            if n_extra_per_view or n_global:
                raise ValueError("Custom positional encoding is not supported when additional tokens are provided.")
            if model_input.positions is not None:  # the caller's true per-view positions (ManyAR)
                pos = torch.cat(list(model_input.positions), dim=1)
            else:
                pos = torch.cat([make_patch_positions(B, H, W, device=tokens.device)] * num_views, dim=1)

        if self.distinguish_ref_and_non_ref_views:
            # each table row is cast to the tokens' dtype before the add (JAX :265-268)
            n_view_tokens = num_views * n_tok_per_view
            ref = tokens[:, :n_tok_per_view] + self.view_pos_table[0].to(tokens.dtype)
            nonref = tokens[:, n_tok_per_view:n_view_tokens]
            if self.use_pe_for_non_reference_views and num_views > 1:
                pe = self.view_pos_table[self._nonref_pe_indices(num_views, generator)].to(tokens.dtype)
                nonref = nonref + pe.repeat_interleave(n_tok_per_view, dim=0)[None]
            tokens = torch.cat([ref, nonref, tokens[:, n_view_tokens:]], dim=1)

        return tokens, pos, (B, H, W, num_views, n_tok_per_view, n_extra_per_view, n_global)

    def _split_output(self, tokens, meta) -> MultiViewTransformerOutput:
        "The stream back to per-view BCHW features and the extra tokens' (B, dim, n) features."
        B, H, W, num_views, n_tok_per_view, n_extra_per_view, n_global = meta
        n_view_tokens = num_views * n_tok_per_view
        view_tokens = tokens[:, :n_view_tokens].reshape(B, num_views, n_tok_per_view, self.dim)
        features = [view_tokens[:, v, : H * W].reshape(B, H, W, self.dim).permute(0, 3, 1, 2) for v in range(num_views)]
        extra_per_view = None
        if n_extra_per_view:
            extra_per_view = [view_tokens[:, v, H * W :].transpose(1, 2) for v in range(num_views)]
        extra_global = tokens[:, n_view_tokens:].transpose(1, 2) if n_global else None
        return MultiViewTransformerOutput(
            features=features, additional_token_features=extra_global, additional_token_features_per_view=extra_per_view
        )

    def forward(self, model_input: MultiViewTransformerInput,
                generator: Optional[torch.Generator] = None) -> MultiViewTransformerOutput:
        """Per-view BCHW features after the blocks and the final norm. ``generator`` draws the non-reference
        views' index encodings when ``use_rand_idx_pe_for_non_reference_views`` (None: views 1..V-1)."""
        tokens, pos, meta = self._prepare_tokens(model_input, generator)
        return self._split_output(self.norm(self._run_blocks(tokens, pos, meta)), meta)


class MultiViewGlobalAttentionTransformerIFR(MultiViewGlobalAttentionTransformer, IntermediateFeatureReturner):
    "Global-attention transformer that also returns the features after the depths in ``indices`` (JAX :311-344)."

    def __init__(
        self,
        *args,
        indices: Optional[Union[int, List[int]]] = None,
        norm_intermediate: bool = True,
        intermediates_only: bool = False,
        **kwargs,
    ):
        MultiViewGlobalAttentionTransformer.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(
            self, indices=indices, norm_intermediate=norm_intermediate, intermediates_only=intermediates_only
        )

    def forward(
        self, model_input: MultiViewTransformerInput, generator: Optional[torch.Generator] = None
    ) -> Union[List[MultiViewTransformerOutput], Tuple[MultiViewTransformerOutput, List[MultiViewTransformerOutput]]]:
        "(final output, [output after each index]), or only the list with ``intermediates_only``."
        take_indices, _ = feature_take_indices(self.depth, self.indices)
        tokens, pos, meta = self._prepare_tokens(model_input, generator)
        tokens, per_depth = self._run_blocks(tokens, pos, meta, collect=True, take_indices=take_indices)
        intermediates = [
            self._split_output(self.norm(per_depth[i]) if self.norm_intermediate else per_depth[i], meta)
            for i in take_indices
        ]
        if self.intermediates_only:
            return intermediates
        return self._split_output(self.norm(tokens), meta), intermediates


class GlobalAttentionTransformer(_GlobalAttentionBase):
    "Multi-set global-attention transformer: each set may have its own token count (JAX :347-410)."

    def __init__(
        self,
        name: str,
        input_embed_dim: int,
        max_num_sets: int,
        use_rand_idx_pe_for_non_reference_sets: bool,
        **kwargs,
    ):
        super().__init__(name=name, input_embed_dim=input_embed_dim, **kwargs)
        self.max_num_sets = max_num_sets
        self.use_rand_idx_pe_for_non_reference_sets = use_rand_idx_pe_for_non_reference_sets
        self.register_buffer("set_pos_table", _pe_table(max_num_sets, self.dim, kwargs.get("device")),
                             persistent=False)
        self._load_pretrained()

    def _nonref_pe_indices(self, num_sets: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        "The set-index rows of sets 1..S-1: random in [1, max_num_sets) with a generator, else 1..S-1."
        device = self.set_pos_table.device
        if self.use_rand_idx_pe_for_non_reference_sets and generator is not None:
            return _random_indices(num_sets - 1, self.max_num_sets, generator, device)
        return torch.arange(1, num_sets, device=device)

    def forward(self, model_input: MultiSetTransformerInput,
                generator: Optional[torch.Generator] = None) -> MultiSetTransformerOutput:
        "Per-set (B, dim, n) features after the blocks and the final norm; ``generator`` as for the multi-view one."
        feats = model_input.features
        num_sets = len(feats)
        if num_sets > self.max_num_sets:
            raise ValueError(f"{num_sets} sets; the set-index encoding covers {self.max_num_sets}")
        if not all(f.dim() == 3 and f.shape[1] == self.input_embed_dim for f in feats):
            raise ValueError(f"All sets must be (N, {self.input_embed_dim}, T)")

        tokens_per_set = [f.shape[2] for f in feats]
        n_set_tokens = sum(tokens_per_set)
        tokens = torch.cat([f.transpose(1, 2) for f in feats], dim=1)
        n_global = 0
        if model_input.additional_input_tokens is not None:
            extra = model_input.additional_input_tokens.transpose(1, 2)
            n_global = extra.shape[1]
            tokens = torch.cat([tokens, extra], dim=1)
        tokens = self.proj_embed(tokens)

        # set-index PE: row 0 for the reference set, sequential or random rows for the rest (cast before the add)
        table, idx = self.set_pos_table, self._nonref_pe_indices(num_sets, generator)
        pe = torch.cat([table[0].expand(tokens_per_set[0], -1)]
                       + [table[idx[s - 1]].expand(n, -1) for s, n in enumerate(tokens_per_set[1:], 1)])
        tokens = torch.cat([tokens[:, :n_set_tokens] + pe[None].to(tokens.dtype), tokens[:, n_set_tokens:]], dim=1)

        tokens = self.norm(self._run_blocks(tokens, None))
        extra_out = tokens[:, n_set_tokens:].transpose(1, 2) if n_global else None
        out = tokens[:, :n_set_tokens].transpose(1, 2)  # (B, C, T)
        return MultiSetTransformerOutput(features=list(out.split(tokens_per_set, dim=2)),
                                         additional_token_features=extra_out)
