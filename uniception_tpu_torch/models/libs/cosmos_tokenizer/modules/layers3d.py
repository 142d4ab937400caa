"""
The Cosmos causal video tokenizer's 3D layers (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/modules/layers3d.py; reference
uniception/models/libs/cosmos_tokenizer/modules/layers3d.py:48-965): CausalConv3d (the first frame replicated in time,
zeros in space), the causal up- and downsamplers, plain and factorized causal resnet blocks, the per-frame spatial
attention and the causal temporal attention, and both encoder / decoder variants: FACTORIZED (the published CV and
DV configs) and the non-factorized BASE.

Tensors are (B, C, T, H, W) at module boundaries, as in the JAX package. The convs are ``F.conv3d`` in torch's
layout (the JAX modules leave theirs to ``nnx.Conv``, channels-last); no 3D conv takes K7. The state-dict keys are the
reference's (``conv_in.0.conv3d.weight``, ``mid.attn_1.0.q.conv3d.*``, ``down.{i}.block.{j}.norm1.norm.*``, ...).
``CausalAttnBlock`` attends over each frame's H * W grid through
:func:`~uniception_tpu_torch.ops.attention.scaled_dot_product_attention` with one head of D = C: K1 on the card (D =
512 at the mid blocks). The published configs' ``attn_resolutions`` ([32] at ``resolution`` 1024, patch 4) match
none of the pyramid's levels (256, 128, 64 in the encoder; 64, 128, 256 in the decoder), so only the two mid blocks
attend: K1 twice per autoencode. ``CausalTemporalAttnBlock``'s causal attention over T stays an explicit einsum
softmax in the activation dtype, as in the JAX package; K1 takes no mask.
"""

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.patching import (Patcher, Patcher3D, UnPatcher,
                                                                               UnPatcher3D)
from uniception_tpu_torch.nn.common import GroupNorm, Identity, lecun_normal
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention

__all__ = [
    "CausalConv3d",
    "CausalNormalize",
    "CausalUpsample3d",
    "CausalDownsample3d",
    "CausalHybridUpsample3d",
    "CausalHybridDownsample3d",
    "CausalResnetBlock3d",
    "CausalResnetBlockFactorized3d",
    "CausalAttnBlock",
    "CausalTemporalAttnBlock",
    "EncoderBase",
    "DecoderBase",
    "EncoderFactorized",
    "DecoderFactorized",
]

_LEGACY_NUM_GROUPS = 32  # GroupNorm's groups in the BASE variant (layers3d.py:45)


def nonlinearity(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _cast3(k) -> Tuple[int, int, int]:
    return k if isinstance(k, tuple) else (k, k, k)


class _Conv3d(nn.Conv3d):
    "``nnx.Conv`` over (T, H, W), torch's layout: lecun-normal weight, zero bias, compute ``dtype`` (None: the weight's)."

    def __init__(self, cin, cout, kernel_size, stride, dilation, padding, *, dtype=None, device=None, generator=None):
        super().__init__(cin, cout, kernel_size, stride=stride, dilation=dilation, padding=padding, device=device)
        self.compute_dtype = dtype
        lecun_normal(self.weight, cin * math.prod(kernel_size), generator=generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class CausalConv3d(nn.Module):
    """A 3D conv with causal time padding (layers3d.py:55-98): the first frame repeated ``time_pad`` times, zeros of
    ``padding`` on each side in space (the conv's own padding: the same sums), then strides ``(time_stride, stride,
    stride)``."""

    def __init__(self, chan_in: int = 1, chan_out: int = 1, kernel_size: Union[int, Tuple[int, int, int]] = 3,
                 stride: int = 1, time_stride: int = 1, padding: int = 1, dilation: int = 1, time_dilation: int = 1, *,
                 dtype=None, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kt, kh, kw = _cast3(kernel_size)
        self.time_pad = time_dilation * (kt - 1) + (1 - time_stride)
        self.spatial_pad = padding
        self.conv3d = _Conv3d(chan_in, chan_out, (kt, kh, kw), (time_stride, stride, stride),
                              (time_dilation, dilation, dilation), (0, padding, padding), dtype=dtype, device=device,
                              generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.time_pad:
            x = torch.cat([x[:, :, :1].expand(-1, -1, self.time_pad, -1, -1), x], dim=2)
        return self.conv3d(x)


class CausalNormalize(nn.Module):
    """GroupNorm (epsilon 1e-6) with statistics per frame when ``num_groups == 1`` (causal), else over the whole clip
    (the BASE variant's 32 groups; layers3d.py:101-119). Keys: ``norm.weight``, ``norm.bias``."""

    def __init__(self, in_channels: int, num_groups: int = 1, *, dtype=None, device=None):
        super().__init__()
        self.norm = GroupNorm(in_channels, num_groups, dtype=dtype, device=device)
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x, frames=self.num_groups == 1)


def _replication_pad_time(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:, :, :1], x], dim=2)


def _repeat_time(x: torch.Tensor, factor: int) -> torch.Tensor:
    "Each frame ``factor`` times, then the ``factor - 1`` leading frames dropped (the causal temporal upsample)."
    return x.repeat_interleave(factor, dim=2)[:, :, factor - 1:] if factor > 1 else x


def _time_factor(x: torch.Tensor) -> int:
    return 2 if x.shape[2] > 1 else 1  # one frame stays one


class CausalUpsample3d(nn.Module):
    "Nearest 2x in space, each frame twice in time, a 3x3x3 conv, the first frame's copy dropped (layers3d.py:122-136)."

    def __init__(self, in_channels: int, *, dtype=None, device=None, generator=None):
        super().__init__()
        self.conv = CausalConv3d(in_channels, in_channels, 3, stride=1, padding=1, dtype=dtype, device=device,
                                 generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        tf = _time_factor(x)
        x = x.repeat_interleave(tf, dim=2)
        return self.conv(x)[:, :, tf - 1:]


class CausalDownsample3d(nn.Module):
    "Zeros below and right, the first frame once more, then a stride-2 3x3x3 conv (layers3d.py:139-151)."

    def __init__(self, in_channels: int, *, dtype=None, device=None, generator=None):
        super().__init__()
        self.conv = CausalConv3d(in_channels, in_channels, 3, stride=2, time_stride=2, padding=0, dtype=dtype,
                                 device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_replication_pad_time(F.pad(x, (0, 1, 0, 1))))


class CausalHybridUpsample3d(nn.Module):
    """The factorized upsample (layers3d.py:154-180): a causal time repeat with a (3, 1, 1) residual conv, nearest 2x
    in space with a (1, 3, 3) residual conv, then a 1x1x1 conv; nothing when neither is asked for (the convs stay in
    the state dict, as in the reference). The time factor is chosen from T at run time."""

    def __init__(self, in_channels: int, spatial_up: bool = True, temporal_up: bool = True, *, dtype=None,
                 device=None, generator=None, **ignore_kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = CausalConv3d(in_channels, in_channels, (3, 1, 1), stride=1, time_stride=1, padding=0, **kw)
        self.conv2 = CausalConv3d(in_channels, in_channels, (1, 3, 3), stride=1, time_stride=1, padding=1, **kw)
        self.conv3 = CausalConv3d(in_channels, in_channels, 1, stride=1, time_stride=1, padding=0, **kw)
        self.spatial_up = spatial_up
        self.temporal_up = temporal_up

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.spatial_up and not self.temporal_up:
            return x
        if self.temporal_up:
            x = _repeat_time(x, _time_factor(x))
            x = self.conv1(x) + x
        if self.spatial_up:
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            x = self.conv2(x) + x
        return self.conv3(x)


class CausalHybridDownsample3d(nn.Module):
    """The factorized downsample (layers3d.py:183-206): in space a stride-2 (1, 3, 3) conv plus a 2x2 average, in
    time a stride-2 (3, 1, 1) conv plus a 2-frame average (after the first frame once more), then a 1x1x1 conv."""

    def __init__(self, in_channels: int, spatial_down: bool = True, temporal_down: bool = True, *, dtype=None,
                 device=None, generator=None, **ignore_kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = CausalConv3d(in_channels, in_channels, (1, 3, 3), stride=2, time_stride=1, padding=0, **kw)
        self.conv2 = CausalConv3d(in_channels, in_channels, (3, 1, 1), stride=1, time_stride=2, padding=0, **kw)
        self.conv3 = CausalConv3d(in_channels, in_channels, 1, stride=1, time_stride=1, padding=0, **kw)
        self.spatial_down = spatial_down
        self.temporal_down = temporal_down

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.spatial_down and not self.temporal_down:
            return x
        if self.spatial_down:
            x = F.pad(x, (0, 1, 0, 1))
            x = self.conv1(x) + F.avg_pool3d(x, (1, 2, 2), (1, 2, 2))
        if self.temporal_down:
            x = _replication_pad_time(x)
            x = self.conv2(x) + F.avg_pool3d(x, (2, 1, 1), (2, 1, 1))
        return self.conv3(x)


Seq3d = nn.Sequential  # the JAX package's Seq3d: its state-dict keys are torch's integer ones (``conv_in.0.*``)


class CausalResnetBlock3d(nn.Module):
    "The non-factorized causal resnet block, 3x3x3 convs (layers3d.py:223-242)."

    def __init__(self, *, in_channels: int, out_channels: Optional[int] = None, dropout: float = 0.0,
                 num_groups: int = 1, dtype=None, device=None, generator=None):
        super().__init__()
        out_channels = in_channels if out_channels is None else out_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm1 = CausalNormalize(in_channels, num_groups, dtype=dtype, device=device)
        self.conv1 = CausalConv3d(in_channels, out_channels, 3, stride=1, padding=1, **kw)
        self.norm2 = CausalNormalize(out_channels, num_groups, dtype=dtype, device=device)
        self.conv2 = CausalConv3d(out_channels, out_channels, 3, stride=1, padding=1, **kw)
        self.nin_shortcut = (CausalConv3d(in_channels, out_channels, 1, stride=1, padding=0, **kw)
                             if in_channels != out_channels else Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(nonlinearity(self.norm2(h)))
        return self.nin_shortcut(x) + h


class CausalResnetBlockFactorized3d(nn.Module):
    "The factorized causal resnet block: each conv a (1, 3, 3) then a (3, 1, 1) one (layers3d.py:245-270)."

    def __init__(self, *, in_channels: int, out_channels: Optional[int] = None, dropout: float = 0.0,
                 num_groups: int = 1, dtype=None, device=None, generator=None):
        super().__init__()
        out_channels = in_channels if out_channels is None else out_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm1 = CausalNormalize(in_channels, 1, dtype=dtype, device=device)
        self.conv1 = Seq3d(CausalConv3d(in_channels, out_channels, (1, 3, 3), stride=1, padding=1, **kw),
                           CausalConv3d(out_channels, out_channels, (3, 1, 1), stride=1, padding=0, **kw))
        self.norm2 = CausalNormalize(out_channels, num_groups, dtype=dtype, device=device)
        self.conv2 = Seq3d(CausalConv3d(out_channels, out_channels, (1, 3, 3), stride=1, padding=1, **kw),
                           CausalConv3d(out_channels, out_channels, (3, 1, 1), stride=1, padding=0, **kw))
        self.nin_shortcut = (CausalConv3d(in_channels, out_channels, 1, stride=1, padding=0, **kw)
                             if in_channels != out_channels else Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(nonlinearity(self.norm2(h)))
        return self.nin_shortcut(x) + h


class _QKVBlock(nn.Module):
    "The norm and the q, k, v and proj_out 1x1x1 convs both attention blocks share."

    def __init__(self, in_channels: int, num_groups: int = 1, *, dtype=None, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm = CausalNormalize(in_channels, num_groups, dtype=dtype, device=device)
        self.q = CausalConv3d(in_channels, in_channels, 1, stride=1, padding=0, **kw)
        self.k = CausalConv3d(in_channels, in_channels, 1, stride=1, padding=0, **kw)
        self.v = CausalConv3d(in_channels, in_channels, 1, stride=1, padding=0, **kw)
        self.proj_out = CausalConv3d(in_channels, in_channels, 1, stride=1, padding=0, **kw)

    def qkv(self, x: torch.Tensor):
        h_ = self.norm(x)
        return self.q(h_), self.k(h_), self.v(h_)


class CausalAttnBlock(_QKVBlock):
    """Per-frame spatial attention (layers3d.py:273-294): the frames folded into the batch, one head of D = C over
    the H * W grid, scale C^-0.5; K1 on the card."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape

        def fold(t):  # (B, C, T, H, W) -> (B * T, H * W, 1, C), C contiguous (at B = 1 the reshape is a view)
            return t.permute(0, 2, 3, 4, 1).reshape(B * T, H * W, 1, C).contiguous()

        out = scaled_dot_product_attention(*(fold(t) for t in self.qkv(x)), scale=C**-0.5)
        return x + self.proj_out(out.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3))


class CausalTemporalAttnBlock(_QKVBlock):
    """Causal attention over time at each spatial location (layers3d.py:297-324): (B * H * W, T, C), a lower-
    triangular mask, an explicit einsum and softmax in the activation dtype, as in the JAX package (no kernel)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape

        def fold(t):  # (B, C, T, H, W) -> (B * H * W, T, C)
            return t.permute(0, 3, 4, 2, 1).reshape(B * H * W, T, C)

        qf, kf, vf = (fold(t) for t in self.qkv(x))
        logits = torch.einsum("btc,bsc->bts", qf, kf) * (C**-0.5)
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        weights = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
        out = torch.einsum("bts,bsc->btc", weights, vf)
        return x + self.proj_out(out.reshape(B, H, W, T, C).permute(0, 4, 3, 1, 2))


def _per_frame(fn, x: torch.Tensor) -> torch.Tensor:
    "A 2D (B, C, H, W) function applied to each frame of a (B, C, T, H, W) video (utils.py:23-33 time2batch)."
    B, C, T, H, W = x.shape
    y = fn(x.transpose(1, 2).reshape(B * T, C, H, W))
    return y.reshape(B, T, *y.shape[1:]).transpose(1, 2)


def _level(blocks, attn) -> nn.Module:
    level = nn.Module()
    level.block, level.attn = nn.ModuleList(blocks), nn.ModuleList(attn)
    return level


def _mid(block, attn) -> nn.Module:
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = block(), attn(), block()
    return mid


def _run_level(level, h: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        h = level.block[i](h)
        if len(level.attn) > 0:
            h = level.attn[i](h)
    return h


def _run_mid(mid, h: torch.Tensor) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h)))


class EncoderBase(nn.Module):
    """The non-factorized causal video encoder (layers3d.py:338-428): per-frame 2D patching, 3x3x3 convs, spatial
    attention only, CausalDownsample3d at every level but the last, where a replication-padded 2-frame average
    halves time. (B, C, T, H, W) -> (B, z_channels, T', H', W')."""

    def __init__(self, in_channels: int, channels: int, channels_mult: List[int], num_res_blocks: int,
                 attn_resolutions: List[int], dropout: float, resolution: int, z_channels: int, *, dtype=None,
                 device=None, generator: Optional[torch.Generator] = None, **ignore_kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_resolutions = len(channels_mult)
        self.num_res_blocks = num_res_blocks

        patch_size = ignore_kwargs.get("patch_size", 1)
        self.patcher = Patcher(patch_size, ignore_kwargs.get("patch_method", "rearrange"))
        in_channels = in_channels * patch_size * patch_size

        self.conv_in = CausalConv3d(in_channels, channels, 3, stride=1, padding=1, **kw)

        num_groups = ignore_kwargs.get("num_groups", _LEGACY_NUM_GROUPS)
        curr_res = resolution // patch_size
        in_ch_mult = (1,) + tuple(channels_mult)
        self.down = nn.ModuleList()
        block_in = channels
        for i_level in range(self.num_resolutions):
            block, attn = [], []
            block_in = channels * in_ch_mult[i_level]
            block_out = channels * channels_mult[i_level]
            for _ in range(num_res_blocks):
                block.append(CausalResnetBlock3d(in_channels=block_in, out_channels=block_out, dropout=dropout,
                                                 num_groups=num_groups, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attn.append(CausalAttnBlock(block_in, num_groups, **kw))
            down = _level(block, attn)
            if i_level != self.num_resolutions - 1:
                down.downsample = CausalDownsample3d(block_in, **kw)
                curr_res = curr_res // 2
            self.down.append(down)

        self.mid = _mid(lambda: CausalResnetBlock3d(in_channels=block_in, out_channels=block_in, dropout=dropout,
                                                    num_groups=num_groups, **kw),
                        lambda: CausalAttnBlock(block_in, num_groups, **kw))
        self.norm_out = CausalNormalize(block_in, num_groups, dtype=dtype, device=device)
        self.conv_out = CausalConv3d(block_in, z_channels, 3, stride=1, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(_per_frame(self.patcher, x))
        for i_level in range(self.num_resolutions):
            h = _run_level(self.down[i_level], h, self.num_res_blocks)
            if i_level != self.num_resolutions - 1:
                h = self.down[i_level].downsample(h)
            else:  # the causal temporal downsample: the first frame once more, then 2-frame averages (:405-414)
                tf = _time_factor(h)
                h = F.avg_pool3d(_replication_pad_time(h), (tf, 1, 1), (2, 1, 1))
        return self.conv_out(nonlinearity(self.norm_out(_run_mid(self.mid, h))))


class DecoderBase(nn.Module):
    """The non-factorized causal video decoder (layers3d.py:431-513), EncoderBase's mirror: a causal repeat-and-drop
    doubles time at the last level, and each frame is 2D-unpatched."""

    def __init__(self, out_channels: int, channels: int, channels_mult: List[int], num_res_blocks: int,
                 attn_resolutions: List[int], dropout: float, resolution: int, z_channels: int, *, dtype=None,
                 device=None, generator: Optional[torch.Generator] = None, **ignore_kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_resolutions = len(channels_mult)
        self.num_res_blocks = num_res_blocks

        patch_size = ignore_kwargs.get("patch_size", 1)
        self.unpatcher = UnPatcher(patch_size, ignore_kwargs.get("patch_method", "rearrange"))
        out_ch = out_channels * patch_size * patch_size

        block_in = channels * channels_mult[self.num_resolutions - 1]
        curr_res = (resolution // patch_size) // 2 ** (self.num_resolutions - 1)
        self.conv_in = CausalConv3d(z_channels, block_in, 3, stride=1, padding=1, **kw)

        num_groups = ignore_kwargs.get("num_groups", _LEGACY_NUM_GROUPS)
        self.mid = _mid(lambda: CausalResnetBlock3d(in_channels=block_in, out_channels=block_in, dropout=dropout,
                                                    num_groups=num_groups, **kw),
                        lambda: CausalAttnBlock(block_in, num_groups, **kw))

        ups = []
        for i_level in reversed(range(self.num_resolutions)):
            block, attn = [], []
            block_out = channels * channels_mult[i_level]
            for _ in range(num_res_blocks + 1):
                block.append(CausalResnetBlock3d(in_channels=block_in, out_channels=block_out, dropout=dropout,
                                                 num_groups=num_groups, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attn.append(CausalAttnBlock(block_in, num_groups, **kw))
            up = _level(block, attn)
            if i_level != 0:
                up.upsample = CausalUpsample3d(block_in, **kw)
                curr_res = curr_res * 2
            ups.insert(0, up)
        self.up = nn.ModuleList(ups)

        self.norm_out = CausalNormalize(block_in, num_groups, dtype=dtype, device=device)
        self.conv_out = CausalConv3d(block_in, out_ch, 3, stride=1, padding=1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid, self.conv_in(z))
        for i_level in reversed(range(self.num_resolutions)):
            h = _run_level(self.up[i_level], h, self.num_res_blocks + 1)
            if i_level != 0:
                h = self.up[i_level].upsample(h)
            else:  # the causal temporal upsample: each frame twice, the first frame's copy dropped
                h = _repeat_time(h, _time_factor(h))
        return _per_frame(self.unpatcher, self.conv_out(nonlinearity(self.norm_out(h))))


def _factorized_attn(block_in: int, kw: dict) -> Seq3d:
    return Seq3d(CausalAttnBlock(block_in, 1, **kw), CausalTemporalAttnBlock(block_in, 1, **kw))


class EncoderFactorized(nn.Module):
    """The factorized causal video encoder (layers3d.py:516-594), the published CV and DV one: 3D patching, (1, 3, 3)
    + (3, 1, 1) convs, spatial then causal temporal attention, hybrid downsamples for the first
    ``num_spatial_downs`` / ``num_temporal_downs`` levels. (B, C, T, H, W) -> (B, z_channels, T', H', W')."""

    def __init__(self, in_channels: int, channels: int, channels_mult: List[int], num_res_blocks: int,
                 attn_resolutions: List[int], dropout: float, resolution: int, z_channels: int,
                 spatial_compression: int = 16, temporal_compression: int = 8, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None, **ignore_kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_resolutions = len(channels_mult)
        self.num_res_blocks = num_res_blocks

        patch_size = ignore_kwargs.get("patch_size", 1)
        self.patcher3d = Patcher3D(patch_size, ignore_kwargs.get("patch_method", "rearrange"))
        in_channels = in_channels * patch_size**3

        self.num_spatial_downs = int(math.log2(spatial_compression)) - int(math.log2(patch_size))
        self.num_temporal_downs = int(math.log2(temporal_compression)) - int(math.log2(patch_size))

        self.conv_in = Seq3d(CausalConv3d(in_channels, channels, (1, 3, 3), stride=1, padding=1, **kw),
                             CausalConv3d(channels, channels, (3, 1, 1), stride=1, padding=0, **kw))

        curr_res = resolution // patch_size
        in_ch_mult = (1,) + tuple(channels_mult)
        self.down = nn.ModuleList()
        block_in = channels
        for i_level in range(self.num_resolutions):
            block, attn = [], []
            block_in = channels * in_ch_mult[i_level]
            block_out = channels * channels_mult[i_level]
            for _ in range(num_res_blocks):
                block.append(CausalResnetBlockFactorized3d(in_channels=block_in, out_channels=block_out,
                                                           dropout=dropout, num_groups=1, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attn.append(_factorized_attn(block_in, kw))
            down = _level(block, attn)
            if i_level != self.num_resolutions - 1:
                down.downsample = CausalHybridDownsample3d(block_in, spatial_down=i_level < self.num_spatial_downs,
                                                           temporal_down=i_level < self.num_temporal_downs, **kw)
                curr_res = curr_res // 2
            self.down.append(down)

        self.mid = _mid(lambda: CausalResnetBlockFactorized3d(in_channels=block_in, out_channels=block_in,
                                                              dropout=dropout, num_groups=1, **kw),
                        lambda: _factorized_attn(block_in, kw))
        self.norm_out = CausalNormalize(block_in, 1, dtype=dtype, device=device)
        self.conv_out = Seq3d(CausalConv3d(block_in, z_channels, (1, 3, 3), stride=1, padding=1, **kw),
                              CausalConv3d(z_channels, z_channels, (3, 1, 1), stride=1, padding=0, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(self.patcher3d(x))
        for i_level in range(self.num_resolutions):
            h = _run_level(self.down[i_level], h, self.num_res_blocks)
            if i_level != self.num_resolutions - 1:
                h = self.down[i_level].downsample(h)
        return self.conv_out(nonlinearity(self.norm_out(_run_mid(self.mid, h))))


class DecoderFactorized(nn.Module):
    """The factorized causal video decoder (layers3d.py:597-698). Which levels upsample follows the reference
    (:665-672): in time the levels 1..num_temporal_ups from the bottom (0..num_temporal_ups - 1 with ``legacy_mode``),
    in space those and, where the spatial compression is the larger, the first ``num_spatial_ups``."""

    def __init__(self, out_channels: int, channels: int, channels_mult: List[int], num_res_blocks: int,
                 attn_resolutions: List[int], dropout: float, resolution: int, z_channels: int,
                 spatial_compression: int = 16, temporal_compression: int = 8, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None, **ignore_kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_resolutions = len(channels_mult)
        self.num_res_blocks = num_res_blocks

        patch_size = ignore_kwargs.get("patch_size", 1)
        self.unpatcher3d = UnPatcher3D(patch_size, ignore_kwargs.get("patch_method", "rearrange"))
        out_ch = out_channels * patch_size**3

        self.num_spatial_ups = int(math.log2(spatial_compression)) - int(math.log2(patch_size))
        self.num_temporal_ups = int(math.log2(temporal_compression)) - int(math.log2(patch_size))

        block_in = channels * channels_mult[self.num_resolutions - 1]
        curr_res = (resolution // patch_size) // 2 ** (self.num_resolutions - 1)
        self.conv_in = Seq3d(CausalConv3d(z_channels, block_in, (1, 3, 3), stride=1, padding=1, **kw),
                             CausalConv3d(block_in, block_in, (3, 1, 1), stride=1, padding=0, **kw))
        self.mid = _mid(lambda: CausalResnetBlockFactorized3d(in_channels=block_in, out_channels=block_in,
                                                              dropout=dropout, num_groups=1, **kw),
                        lambda: _factorized_attn(block_in, kw))

        legacy_mode = ignore_kwargs.get("legacy_mode", False)
        ups = []
        for i_level in reversed(range(self.num_resolutions)):
            block, attn = [], []
            block_out = channels * channels_mult[i_level]
            for _ in range(num_res_blocks + 1):
                block.append(CausalResnetBlockFactorized3d(in_channels=block_in, out_channels=block_out,
                                                           dropout=dropout, num_groups=1, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attn.append(_factorized_attn(block_in, kw))
            up = _level(block, attn)
            if i_level != 0:
                i_level_reverse = self.num_resolutions - i_level - 1
                if legacy_mode:
                    temporal_up = i_level_reverse < self.num_temporal_ups
                else:
                    temporal_up = 0 < i_level_reverse < self.num_temporal_ups + 1
                spatial_up = temporal_up or (i_level_reverse < self.num_spatial_ups
                                             and self.num_spatial_ups > self.num_temporal_ups)
                up.upsample = CausalHybridUpsample3d(block_in, spatial_up=spatial_up, temporal_up=temporal_up, **kw)
                curr_res = curr_res * 2
            ups.insert(0, up)
        self.up = nn.ModuleList(ups)

        self.norm_out = CausalNormalize(block_in, 1, dtype=dtype, device=device)
        self.conv_out = Seq3d(CausalConv3d(block_in, out_ch, (1, 3, 3), stride=1, padding=1, **kw),
                              CausalConv3d(out_ch, out_ch, (3, 1, 1), stride=1, padding=0, **kw))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid, self.conv_in(z))
        for i_level in reversed(range(self.num_resolutions)):
            h = _run_level(self.up[i_level], h, self.num_res_blocks + 1)
            if i_level != 0:
                h = self.up[i_level].upsample(h)
        return self.unpatcher3d(self.conv_out(nonlinearity(self.norm_out(h))))
