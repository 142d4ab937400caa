"""
Haar / rearrange (un)patching for the Cosmos tokenizer, the 2D half (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/modules/patching.py; reference
uniception/models/libs/cosmos_tokenizer/modules/patching.py:39-249).

"haar" is a levelwise 2D Haar DWT with a /2 rescale per level, output channels [LL, LH, HL, HH] with L/H over W
first, then over H: the channel order decides which weights of the encoder's ``conv_in`` see which band.
"rearrange" is pixel-unshuffle, ``b c (h p1) (w p2) -> b (c p1 p2) h w``. The 2-tap Haar kernel reduces to exact
2x2 block butterflies (reshapes and adds), as in the JAX package. Tensors are (B, C, H, W). The 3D (video)
patchers are not ported yet (ROADMAP queue 1 item 17).
"""

import torch

__all__ = ["Patcher", "UnPatcher"]

_R = 0.7071067811865476


def _dwt2(x: torch.Tensor, rescale: bool = True) -> torch.Tensor:
    "(B, C, H, W) -> (B, 4C, H/2, W/2): [LL, LH, HL, HH]."
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 2, 2, W // 2, 2)
    w0, w1 = x[..., 0], x[..., 1]  # split along W pairs
    xl = (w0 + w1) * _R  # (B, C, H/2, 2, W/2): axis 3 is the H pair
    xh = (w0 - w1) * _R
    ll = (xl[:, :, :, 0] + xl[:, :, :, 1]) * _R
    lh = (xl[:, :, :, 0] - xl[:, :, :, 1]) * _R
    hl = (xh[:, :, :, 0] + xh[:, :, :, 1]) * _R
    hh = (xh[:, :, :, 0] - xh[:, :, :, 1]) * _R
    out = torch.cat([ll, lh, hl, hh], dim=1)
    return out / 2 if rescale else out


def _idwt2(x: torch.Tensor, rescale: bool = True) -> torch.Tensor:
    "(B, 4C, H, W) -> (B, C, 2H, 2W): the inverse of _dwt2."
    B, C4, H, W = x.shape
    C = C4 // 4
    ll, lh, hl, hh = torch.split(x, C, dim=1)
    yl = torch.stack([(ll + lh) * _R, (ll - lh) * _R], dim=4)  # (B, C, H, W, 2) over the H pair, low W band
    yh = torch.stack([(hl + hh) * _R, (hl - hh) * _R], dim=4)
    out = torch.stack([(yl + yh) * _R, (yl - yh) * _R], dim=5)  # (B, C, H, W, 2 (H pair), 2 (W pair))
    out = out.permute(0, 1, 2, 4, 3, 5).reshape(B, C, 2 * H, 2 * W)
    return out * 2 if rescale else out


class Patcher:
    "Image -> patches (haar DWT levels or pixel-unshuffle)."

    def __init__(self, patch_size: int = 1, patch_method: str = "haar"):
        self.patch_size = patch_size
        self.patch_method = patch_method
        self.levels = max(0, patch_size.bit_length() - 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.patch_method == "haar":
            for _ in range(self.levels):
                x = _dwt2(x)
            return x
        if self.patch_method == "rearrange":
            B, C, H, W = x.shape
            p = self.patch_size
            x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 1, 3, 5, 2, 4)
            return x.reshape(B, C * p * p, H // p, W // p)
        raise ValueError("Unknown patch method: " + self.patch_method)


class UnPatcher:
    "Patches -> image (inverse haar or pixel-shuffle)."

    def __init__(self, patch_size: int = 1, patch_method: str = "haar"):
        self.patch_size = patch_size
        self.patch_method = patch_method
        self.levels = max(0, patch_size.bit_length() - 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.patch_method == "haar":
            for _ in range(self.levels):
                x = _idwt2(x)
            return x
        if self.patch_method == "rearrange":
            B, Cp, H, W = x.shape
            p = self.patch_size
            C = Cp // (p * p)
            x = x.reshape(B, C, p, p, H, W).permute(0, 1, 4, 2, 5, 3)
            return x.reshape(B, C, H * p, W * p)
        raise ValueError("Unknown patch method: " + self.patch_method)
