"""
E-RADIO: the hybrid conv + windowed-attention trunk (counterpart of uniception_tpu/models/encoders/eradio.py, the
JAX package's capability-equivalent of the reference's torch.hub "e-radio_v2").

Layout, as in JAX: stem /4 -> ConvNeXt-style stage /8 -> stage /16 -> windowed-attention stage /16 -> downsample
/32 -> windowed-attention stage /32 -> transposed conv back to /16, concatenated with the /16 features, LayerNorm
and a linear projection to ``out_dim``. ``model(x) -> (summary (B, out_dim), tokens (B, N, out_dim))`` with N =
(H / 16) * (W / 16).

The port keeps JAX's channels-last (B, H, W, C) activations between the modules, so every norm and linear acts
on the last dim as there; the convs see an NCHW view. The window is fixed by :meth:`ERadio.set_optimal_window_size`
before the forward. Windows are partitioned into (B * windows, win * win, C) token blocks whose attention is one
K1 call with heads of 32 (384 / 12 and 768 / 24 at "e-radio_v2"). State-dict keys are the JAX module's (stem1,
stage1.0.dwconv, stage3.0.qkv, up4, fuse_norm, head, summary_norm, ...).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.nn.blocks import LayerNorm
from uniception_tpu_torch.nn.common import ChannelsLastConv
from uniception_tpu_torch.nn.common import flax_linear as linear
from uniception_tpu_torch.nn.dpt_parts import ConvTranspose2dTorch
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention

__all__ = ["ERadio", "ERADIO_CONFIGS", "window_partition", "window_merge"]

ERADIO_CONFIGS = {
    # channels per stage, conv blocks, attn blocks, heads, output dim
    "e-radio_v2": dict(channels=(96, 192, 384, 768), conv_depths=(3, 3), attn_depths=(5, 5), num_heads=(12, 24),
                       out_dim=1536),
    "e-radio_v2-test": dict(channels=(8, 16, 32, 64), conv_depths=(1, 1), attn_depths=(1, 1), num_heads=(2, 4),
                            out_dim=48),
}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    "``jax.nn.gelu`` at its default, the tanh approximation, which the JAX E-RADIO calls."
    return F.gelu(x, approximate="tanh")


class _ConvBlock(nn.Module):
    "ConvNeXt-style block: depthwise 7x7 -> LN -> pw expand -> GELU -> pw project, residual (JAX eradio.py:45-57)."

    def __init__(self, dim, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dwconv = ChannelsLastConv(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = LayerNorm(dim, eps=1e-6, device=device, dtype=dtype)
        self.pw1 = linear(dim, 4 * dim, **kw)
        self.pw2 = linear(4 * dim, dim, **kw)

    def forward(self, x):
        return x + self.pw2(_gelu(self.pw1(self.norm(self.dwconv(x)))))


class _Downsample(nn.Module):
    "LN + strided 2x2 conv (stage transition)."

    def __init__(self, cin, cout, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.norm = LayerNorm(cin, eps=1e-6, device=device, dtype=dtype)
        self.conv = ChannelsLastConv(cin, cout, 2, stride=2, device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.conv(self.norm(x))


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    "(B, H, W, C) -> (B * H/win * W/win, win * win, C), windows row-major; H and W must be multiples of win."
    B, H, W, C = x.shape
    x = x.reshape(B, H // win, win, W // win, win, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, C)


def window_merge(x: torch.Tensor, win: int, H: int, W: int) -> torch.Tensor:
    "The inverse of :func:`window_partition`: (B * windows, win * win, C) -> (B, H, W, C)."
    B = x.shape[0] // ((H // win) * (W // win))
    x = x.reshape(B, H // win, W // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, x.shape[-1])


class _WindowAttnBlock(nn.Module):
    "Pre-LN windowed attention + MLP, both residual (JAX eradio.py:86-108)."

    def __init__(self, dim, num_heads, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device, dtype=dtype)
        self.qkv = linear(dim, 3 * dim, **kw)
        self.proj = linear(dim, dim, **kw)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device, dtype=dtype)
        self.fc1 = linear(dim, 4 * dim, **kw)
        self.fc2 = linear(4 * dim, dim, **kw)

    def forward(self, x, win: int):
        B, H, W, C = x.shape
        t = window_partition(self.norm1(x), win)  # (B * windows, L, C)
        # q/k/v stay strided views of the projection: K1 reads them by stride
        q, k, v = self.qkv(t).reshape(t.shape[0], t.shape[1], 3, self.num_heads, self.head_dim).unbind(2)
        t = self.proj(scaled_dot_product_attention(q, k, v).reshape(t.shape[0], t.shape[1], C))
        x = x + window_merge(t, win, H, W)
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class ERadio(nn.Module):
    """Hybrid conv / windowed-attention encoder with the RADIO model contract (JAX eradio.py:111-194):
    ``forward(x BCHW) -> (summary (B, out_dim), tokens (B, N, out_dim))``, N = (H/16) * (W/16)."""

    def __init__(self, model_version: str = "e-radio_v2", in_chans: int = 3, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = ERADIO_CONFIGS[model_version]
        c1, c2, c3, c4 = cfg["channels"]
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.out_dim = cfg["out_dim"]
        self.window_size = 8  # default; overridden by set_optimal_window_size

        self.stem1 = ChannelsLastConv(in_chans, c1 // 2, 3, stride=2, padding=1, **kw)
        self.stem2 = ChannelsLastConv(c1 // 2, c1, 3, stride=2, padding=1, **kw)
        self.stage1 = nn.ModuleList([_ConvBlock(c1, **kw) for _ in range(cfg["conv_depths"][0])])
        self.down1 = _Downsample(c1, c2, **kw)
        self.stage2 = nn.ModuleList([_ConvBlock(c2, **kw) for _ in range(cfg["conv_depths"][1])])
        self.down2 = _Downsample(c2, c3, **kw)
        self.stage3 = nn.ModuleList([_WindowAttnBlock(c3, cfg["num_heads"][0], **kw)
                                     for _ in range(cfg["attn_depths"][0])])
        self.down3 = _Downsample(c3, c4, **kw)
        self.stage4 = nn.ModuleList([_WindowAttnBlock(c4, cfg["num_heads"][1], **kw)
                                     for _ in range(cfg["attn_depths"][1])])
        self.up4 = ConvTranspose2dTorch(c4, c3, 2, 2, device=device, dtype=dtype, generator=generator)
        self.fuse_norm = LayerNorm(2 * c3, eps=1e-6, device=device, dtype=dtype)
        self.head = linear(2 * c3, self.out_dim, **kw)
        self.summary_norm = LayerNorm(self.out_dim, eps=1e-6, device=device, dtype=dtype)

    def set_optimal_window_size(self, image_shape: Tuple[int, int], max_window_size: int = 16) -> int:
        """The largest window <= ``max_window_size`` that tiles the /32 feature grid exactly (the /16 stage takes
        twice it); set before the forward, as the reference requires (radio.py:95-98). Returns it."""
        h, w = image_shape[0] // 32, image_shape[1] // 32
        for win in range(min(max_window_size, h, w), 0, -1):
            if h % win == 0 and w % win == 0:
                self.window_size = win
                return win
        self.window_size = 1
        return 1

    def forward(self, x: torch.Tensor):
        "x: (B, 3, H, W) with H, W multiples of 32."
        if x.shape[2] % 32 or x.shape[3] % 32:
            raise ValueError(f"E-RADIO needs input H, W divisible by 32, got {tuple(x.shape[2:])}")
        x = x.permute(0, 2, 3, 1)  # channels last
        x = self.stem2(_gelu(self.stem1(x)))
        for blk in self.stage1:
            x = blk(x)
        x = self.down1(x)
        for blk in self.stage2:
            x = blk(x)
        x = self.down2(x)  # /16
        win16 = min(self.window_size * 2, x.shape[1], x.shape[2])
        for blk in self.stage3:
            x = blk(x, win16)
        x16 = x
        x = self.down3(x)  # /32
        for blk in self.stage4:
            x = blk(x, min(self.window_size, x.shape[1], x.shape[2]))
        x = self.up4(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # back to /16
        feats = self.head(self.fuse_norm(torch.cat([x16, x.to(x16.dtype)], dim=-1)))  # (B, H/16, W/16, out_dim)
        B, Hf, Wf, C = feats.shape
        tokens = feats.reshape(B, Hf * Wf, C)
        return self.summary_norm(tokens.mean(dim=1)), tokens
