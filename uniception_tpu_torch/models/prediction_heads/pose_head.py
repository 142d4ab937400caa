"""
Pose and global-quantity regression heads, Reloc3r / MaRePo style (counterpart of
uniception_tpu/models/prediction_heads/pose_head.py; reference prediction_heads/pose_head.py:18-158 and
global_head.py:16-121): a 1x1-conv projection, 1x1-conv residual blocks, a mean over H and W, two Linear + ReLU, then
``fc_t`` (3) and ``fc_rot`` (the rotation representation) concatenated, or ``fc_output``. The output is (B, C).

The 1x1 convs are :class:`~uniception_tpu_torch.nn.dpt_parts.Conv2dTorch`, which never takes the 3x3 conv kernel.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.prediction_heads.base import PredictionHeadInput, SummaryTaskOutput
from uniception_tpu_torch.nn.common import Identity, LinearX
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["PoseHead", "GlobalHead", "ResConvBlock"]


class ResConvBlock(nn.Module):
    "1x1-conv residual block (pose_head.py:18-47): three conv + ReLU, plus the input (a 1x1 conv if the widths differ)."

    def __init__(self, in_channels: int, out_channels: int, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.head_skip = Identity() if in_channels == out_channels else Conv2dTorch(in_channels, out_channels, 1, 1, 0,
                                                                                    **kw)
        self.res_conv1 = Conv2dTorch(in_channels, out_channels, 1, 1, 0, **kw)
        self.res_conv2 = Conv2dTorch(out_channels, out_channels, 1, 1, 0, **kw)
        self.res_conv3 = Conv2dTorch(out_channels, out_channels, 1, 1, 0, **kw)

    def forward(self, res: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.res_conv3(F.relu(self.res_conv2(F.relu(self.res_conv1(res))))))
        return self.head_skip(res) + x


class _SummaryTrunk(nn.Module):
    "The proj -> residual convs -> mean over H, W -> MLP trunk of the pose and global heads; 4 P^2 channels wide."

    def __init__(self, patch_size, input_feature_dim, num_resconv_block, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.patch_size = patch_size
        self.input_feature_dim = input_feature_dim
        self.num_resconv_block = num_resconv_block
        self.output_dim = 4 * patch_size**2
        self.proj = Conv2dTorch(input_feature_dim, self.output_dim, 1, 1, 0, **kw)
        self.res_conv = nn.ModuleList([ResConvBlock(self.output_dim, self.output_dim, **kw)
                                       for _ in range(num_resconv_block)])
        self.more_mlps = nn.Sequential(LinearX(self.output_dim, self.output_dim, **kw), nn.ReLU(),
                                       LinearX(self.output_dim, self.output_dim, **kw), nn.ReLU())

    def _trunk(self, feat: torch.Tensor) -> torch.Tensor:
        if feat.shape[1] != self.input_feature_dim:
            raise ValueError(f"Input feature dimension {feat.shape[1]} does not match expected "
                             f"{self.input_feature_dim}")
        x = self.proj(feat)
        for blk in self.res_conv:
            x = blk(x)
        return self.more_mlps(x.mean(dim=(2, 3)))  # adaptive average pool to 1 x 1, flattened: (B, 4 P^2)


class PoseHead(_SummaryTrunk):
    "Pose regression head: the trunk, then fc_t (3) and fc_rot (``rot_representation_dim``), concatenated."

    def __init__(
        self,
        patch_size: int,
        input_feature_dim: int,
        num_resconv_block: int = 2,
        rot_representation_dim: int = 4,
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        kw = dict(dtype=dtype, device=device, generator=generator)
        super().__init__(patch_size, input_feature_dim, num_resconv_block, **kw)
        self.rot_representation_dim = rot_representation_dim
        self.fc_t = LinearX(self.output_dim, 3, **kw)
        self.fc_rot = LinearX(self.output_dim, rot_representation_dim, **kw)
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained pose head from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def forward(self, feature_input: PredictionHeadInput) -> SummaryTaskOutput:
        feat = self._trunk(feature_input.last_feature)
        return SummaryTaskOutput(decoded_channels=torch.cat([self.fc_t(feat), self.fc_rot(feat)], dim=1))


class GlobalHead(_SummaryTrunk):
    "Global-quantity regression head (global_head.py:16-121): the trunk, then fc_output."

    def __init__(
        self,
        patch_size: int,
        input_feature_dim: int,
        num_resconv_block: int = 2,
        output_representation_dim: int = 1,
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        kw = dict(dtype=dtype, device=device, generator=generator)
        super().__init__(patch_size, input_feature_dim, num_resconv_block, **kw)
        self.output_representation_dim = output_representation_dim
        self.fc_output = LinearX(self.output_dim, output_representation_dim, **kw)
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained global head from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def forward(self, feature_input: PredictionHeadInput) -> SummaryTaskOutput:
        return SummaryTaskOutput(decoded_channels=self.fc_output(self._trunk(feature_input.last_feature)))
