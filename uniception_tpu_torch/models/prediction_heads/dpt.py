"""
DPT prediction head (counterpart of uniception_tpu/models/prediction_heads/dpt.py;
reference uniception/models/prediction_heads/dpt.py): 4-hook feature pyramid
-> fusion stages -> 8x-upsampled features -> regression or segmentation processor.

    * :class:`DPTFeature` (:32-232): per-hook resize convs (4x deconv / 2x
      deconv / identity / stride-2 conv) -> scratch 3x3 projections -> four
      fusion stages with align_corners=True 2x upsampling;
    * :class:`DPTRegressionProcessor` (:238-311): conv -> exact-size bilinear
      interpolation (align_corners=True) -> conv-act-conv;
    * :class:`DPTSegmentationProcessor` (:314-379): conv(-bn)-ReLU-conv ->
      exact-size bilinear interpolation (align_corners=True);
    * :class:`DPTFeatureDoubleUpsampling` (:383-560): the 2-hook variant.

State-dict keys are the JAX export's (input_process.{i}.{j}, scratch.refinenet*):
the scratch projection convs are registered once, under input_process, where
the reference also aliases them as scratch.layer{i}_rn and scratch.layer_rn.*
(:data:`DPT_CHECKPOINT_ALIASES` names those keys). The API keeps the
reference's BCHW; activations run ``channels_last`` (nn/dpt_parts.py).
"""

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.prediction_heads.base import PixelTaskOutput, PredictionHeadLayeredInput
from uniception_tpu_torch.nn.common import remat_call
from uniception_tpu_torch.nn.dpt_parts import (
    Conv2dTorch,
    ConvTranspose2dTorch,
    Seq,
    BatchNorm,
    make_fusion_block,
    make_nonlinearity,
)

__all__ = ["DPTFeature", "DPTFeatureInput", "DPTRegressionProcessor", "DPTSegmentationProcessor",
           "DPTFeatureDoubleUpsampling", "DPT_CHECKPOINT_ALIASES"]

# The reference DPT registers the scratch convs under three spellings
# (input_process.{i}.1, scratch.layer{i}_rn, scratch.layer_rn.{i-1}); the
# canonical keys are input_process.*, and these patterns name the aliases.
DPT_CHECKPOINT_ALIASES = (r"scratch\.layer[1-4]_rn\.", r"scratch\.layer_rn\.")


@dataclass
class DPTFeatureInput:
    features_upsampled_8x: torch.Tensor  # BCHW
    target_output_shape: Tuple[int, int]


def _call(remat: bool, module, *args):
    return remat_call(module, *args) if remat else module(*args)


class DPTFeature(nn.Module):
    "DPT 4-hook fusion head producing 8x-upsampled features."

    def __init__(
        self,
        patch_size: Union[int, Tuple[int, int]] = 16,
        main_tasks: Iterable[str] = ("rgb",),
        hooks: List[int] = (2, 5, 8, 11),
        input_feature_dims: Union[int, List[int]] = 768,
        layer_dims: List[int] = (96, 192, 384, 768),
        feature_dim: int = 256,
        use_bn: bool = False,
        output_width_ratio=1,
        checkpoint_gradient: bool = False,
        nonlinearity: str = "relu",
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.patch_size = patch_size if isinstance(patch_size, tuple) else (patch_size, patch_size)
        self.main_tasks = tuple(main_tasks)
        self.hooks = list(hooks)
        self.layer_dims = list(layer_dims)
        self.feature_dim = feature_dim
        self.checkpoint_gradient = checkpoint_gradient
        if isinstance(input_feature_dims, int):
            input_feature_dims = 4 * [input_feature_dims]
        if len(input_feature_dims) != 4:
            raise ValueError("DPTFeature takes four input feature dims")
        self.input_feature_dims = [d * len(self.main_tasks) for d in input_feature_dims]

        kw = dict(dtype=dtype, device=device, generator=generator)
        ld, d = self.layer_dims, self.input_feature_dims
        self.scratch = nn.Module()
        self.scratch.refinenet1 = make_fusion_block(feature_dim, use_bn, output_width_ratio, nonlinearity, **kw)
        self.scratch.refinenet2 = make_fusion_block(feature_dim, use_bn, output_width_ratio, nonlinearity, **kw)
        self.scratch.refinenet3 = make_fusion_block(feature_dim, use_bn, output_width_ratio, nonlinearity, **kw)
        # refinenet4's resConfUnit1 is unused and deleted in the reference (dpt.py:82-83)
        self.scratch.refinenet4 = make_fusion_block(
            feature_dim, use_bn, output_width_ratio, nonlinearity, has_res1=False, **kw
        )
        acts = [
            Seq(Conv2dTorch(d[0], ld[0], 1, 1, 0, **kw), ConvTranspose2dTorch(ld[0], ld[0], 4, 4, **kw)),
            Seq(Conv2dTorch(d[1], ld[1], 1, 1, 0, **kw), ConvTranspose2dTorch(ld[1], ld[1], 2, 2, **kw)),
            Seq(Conv2dTorch(d[2], ld[2], 1, 1, 0, **kw)),
            Seq(Conv2dTorch(d[3], ld[3], 1, 1, 0, **kw), Conv2dTorch(ld[3], ld[3], 3, 2, 1, **kw)),
        ]
        self.input_process = nn.ModuleList(
            [Seq(act, Conv2dTorch(ld[i], feature_dim, 3, 1, 1, bias=False, **kw)) for i, act in enumerate(acts)]
        )

    def forward(self, dpt_input: PredictionHeadLayeredInput) -> DPTFeatureInput:
        feats = dpt_input.list_features
        for idx, hook in enumerate(self.hooks):
            if feats[hook].shape[1] != self.input_feature_dims[idx]:
                raise ValueError(f"Input feature dimension mismatch at hook {hook}. Expected BCHW")
        layers = [feats[hook].contiguous(memory_format=torch.channels_last) for hook in self.hooks]
        layers = [self.input_process[idx](layer) for idx, layer in enumerate(layers)]

        # fuse coarse to fine; refinenet4's 2x output is cropped to layer 3's size (dpt.py:158);
        # with checkpoint_gradient each stage is recomputed in the backward (dpt.py:203-228)
        remat = self.checkpoint_gradient and torch.is_grad_enabled()
        s = self.scratch
        path_4 = _call(remat, s.refinenet4, layers[3])[:, :, : layers[2].shape[2], : layers[2].shape[3]]
        path_3 = _call(remat, s.refinenet3, path_4, layers[2])
        path_2 = _call(remat, s.refinenet2, path_3, layers[1])
        feature_upsampled_8x = _call(remat, s.refinenet1, path_2, layers[0])
        return DPTFeatureInput(features_upsampled_8x=feature_upsampled_8x,
                               target_output_shape=dpt_input.target_output_shape)


class DPTRegressionProcessor(nn.Module):
    "conv -> exact-size bilinear (align_corners=True) -> conv-act-conv (dpt.py:238-311)."

    def __init__(
        self,
        input_feature_dim: int,
        output_dim: int,
        hidden_dims: Optional[List[int]] = None,
        checkpoint_gradient: bool = False,
        nonlinearity: str = "relu",
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if hidden_dims is None:
            hidden_dims = [input_feature_dim // 2] * 2
        if len(hidden_dims) != 2:
            raise ValueError("DPTRegressionProcessor takes two hidden dims")
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.checkpoint_gradient = checkpoint_gradient
        self.conv1 = Conv2dTorch(input_feature_dim, hidden_dims[0], 3, 1, 1, **kw)
        self.conv2 = Seq(
            Conv2dTorch(hidden_dims[0], hidden_dims[1], 3, 1, 1, **kw),
            make_nonlinearity(nonlinearity),
            Conv2dTorch(hidden_dims[1], output_dim, 1, 1, 0, **kw),
        )

    def _body(self, x: torch.Tensor, output_shape) -> torch.Tensor:
        x = F.interpolate(self.conv1(x), size=tuple(output_shape), mode="bilinear", align_corners=True)
        return self.conv2(x)

    def forward(self, dpt_processor_input: DPTFeatureInput) -> PixelTaskOutput:
        x, shape = dpt_processor_input.features_upsampled_8x, dpt_processor_input.target_output_shape
        # the full-resolution conv activations are the head's largest buffers (dpt.py:269-311)
        remat = self.checkpoint_gradient and torch.is_grad_enabled()
        out = remat_call(self._body, x, shape) if remat else self._body(x, shape)
        return PixelTaskOutput(decoded_channels=out)


class DPTSegmentationProcessor(nn.Module):
    """conv(-bn)-ReLU-conv -> exact-size bilinear (align_corners=True) (dpt.py:314-379). The Sequential keeps the
    reference's numbering [conv, bn or Identity, ReLU, Dropout (eval: Identity), conv]."""

    def __init__(
        self,
        input_feature_dim: int,
        output_dim: int,
        hidden_dim: Optional[int] = None,
        use_bn: bool = False,
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        hidden_dim = input_feature_dim if hidden_dim is None else hidden_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv = Seq(
            Conv2dTorch(input_feature_dim, hidden_dim, 3, 1, 1, bias=False, **kw),
            BatchNorm(hidden_dim, dtype=dtype, device=device) if use_bn else nn.Identity(),
            make_nonlinearity("relu"),
            nn.Identity(),
            Conv2dTorch(hidden_dim, output_dim, 1, 1, 0, **kw),
        )

    def forward(self, dpt_processor_input: DPTFeatureInput) -> PixelTaskOutput:
        x = self.conv(dpt_processor_input.features_upsampled_8x)
        x = F.interpolate(x, size=tuple(dpt_processor_input.target_output_shape), mode="bilinear", align_corners=True)
        return PixelTaskOutput(decoded_channels=x)


class DPTFeatureDoubleUpsampling(nn.Module):
    """The 2-hook DPT variant (dpt.py:383-560): hooks at the token grid and a stride-2 level, fused by refinenets 4
    and 3 into features at twice the token grid (returned as ``features_upsampled_8x``, the reference's name).
    ``checkpoint_gradient`` is kept and unused, as in the JAX package."""

    def __init__(
        self,
        patch_size: Union[int, Tuple[int, int]] = 16,
        main_tasks: Iterable[str] = ("rgb",),
        hooks: List[int] = (0, 1),
        input_feature_dims: Union[int, List[int]] = 768,
        layer_dims: List[int] = (384, 768),
        feature_dim: int = 256,
        use_bn: bool = False,
        output_width_ratio=1,
        checkpoint_gradient: bool = False,
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.patch_size = patch_size if isinstance(patch_size, tuple) else (patch_size, patch_size)
        self.main_tasks = tuple(main_tasks)
        self.hooks = list(hooks)
        self.layer_dims = list(layer_dims)
        self.feature_dim = feature_dim
        self.checkpoint_gradient = checkpoint_gradient
        if isinstance(input_feature_dims, int):
            input_feature_dims = 2 * [input_feature_dims]
        if len(input_feature_dims) != 2:
            raise ValueError("DPTFeatureDoubleUpsampling takes two input feature dims")
        self.input_feature_dims = [d * len(self.main_tasks) for d in input_feature_dims]

        kw = dict(dtype=dtype, device=device, generator=generator)
        ld, d = self.layer_dims, self.input_feature_dims
        self.scratch = nn.Module()
        self.scratch.refinenet3 = make_fusion_block(feature_dim, use_bn, output_width_ratio, **kw)
        self.scratch.refinenet4 = make_fusion_block(feature_dim, use_bn, output_width_ratio, has_res1=False, **kw)
        acts = [
            Seq(Conv2dTorch(d[0], ld[0], 1, 1, 0, **kw)),
            Seq(Conv2dTorch(d[1], ld[1], 1, 1, 0, **kw), Conv2dTorch(ld[1], ld[1], 3, 2, 1, **kw)),
        ]
        self.input_process = nn.ModuleList(
            [Seq(act, Conv2dTorch(ld[i], feature_dim, 3, 1, 1, bias=False, **kw)) for i, act in enumerate(acts)]
        )

    def forward(self, dpt_input: PredictionHeadLayeredInput) -> DPTFeatureInput:
        feats = dpt_input.list_features
        for idx, hook in enumerate(self.hooks):
            if feats[hook].shape[1] != self.input_feature_dims[idx]:
                raise ValueError(f"Input feature dimension mismatch at hook {hook}. Expected BCHW")
        layers = [self.input_process[idx](feats[hook].contiguous(memory_format=torch.channels_last))
                  for idx, hook in enumerate(self.hooks)]
        path_4 = self.scratch.refinenet4(layers[1])[:, :, : layers[0].shape[2], : layers[0].shape[3]]
        return DPTFeatureInput(features_upsampled_8x=self.scratch.refinenet3(path_4, layers[0]),
                               target_output_shape=dpt_input.target_output_shape)
