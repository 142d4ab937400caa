"""
Haar / rearrange (un)patching for the Cosmos tokenizer (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/modules/patching.py; reference
uniception/models/libs/cosmos_tokenizer/modules/patching.py:39-249).

"haar" is a levelwise 2D Haar DWT with a /2 rescale per level, output channels [LL, LH, HL, HH] with L/H over W
first, then over H: the channel order decides which weights of the encoder's ``conv_in`` see which band.
"rearrange" is pixel-unshuffle, ``b c (h p1) (w p2) -> b (c p1 p2) h w``. The 2-tap Haar kernel reduces to exact
2x2 block butterflies (reshapes and adds), as in the JAX package. Tensors are (B, C, H, W).

The 3D (video) patchers take (B, C, T, H, W): ``Patcher3D`` repeats the first frame ``p`` times (the causal start, so
1 + 8n frames patch to a whole number of groups), then runs levelwise 3D Haar DWTs (a /(2 sqrt 2) rescale per level,
eight sub-bands [lll, llh, ..., hhh], the letters over (T, H, W), W fastest) or the 3D rearrange
``b c (t p) (h p) (w p) -> b (c p p p) t h w``; ``UnPatcher3D`` inverts either and drops the ``p - 1`` leading frames.
"""

import torch

__all__ = ["Patcher", "UnPatcher", "Patcher3D", "UnPatcher3D"]

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


def _dwt3(x: torch.Tensor, rescale: bool = True) -> torch.Tensor:
    "(B, C, T, H, W) -> (B, 8C, T/2, H/2, W/2): [lll, llh, lhl, lhh, hll, hlh, hhl, hhh], the letters over (t, h, w)."
    B, C, T, H, W = x.shape
    x = x.reshape(B, C, T // 2, 2, H // 2, 2, W // 2, 2)
    t0, t1 = x[:, :, :, 0], x[:, :, :, 1]
    outs = []
    for tpart in ((t0 + t1) * _R, (t0 - t1) * _R):  # (B, C, T/2, H/2, 2, W/2, 2)
        h0, h1 = tpart[:, :, :, :, 0], tpart[:, :, :, :, 1]
        for hpart in ((h0 + h1) * _R, (h0 - h1) * _R):  # (B, C, T/2, H/2, W/2, 2)
            w0, w1 = hpart[..., 0], hpart[..., 1]
            outs += [(w0 + w1) * _R, (w0 - w1) * _R]
    out = torch.cat(outs, dim=1)
    return out / (2 * 2**0.5) if rescale else out


def _idwt3(x: torch.Tensor, rescale: bool = True) -> torch.Tensor:
    "(B, 8C, T, H, W) -> (B, C, 2T, 2H, 2W): the inverse of _dwt3."
    B, C8, T, H, W = x.shape
    parts = torch.split(x, C8 // 8, dim=1)

    def pair(a, b, dim):  # the inverse butterfly along a new axis of size 2 at ``dim``
        return torch.stack([(a + b) * _R, (a - b) * _R], dim=dim)

    ll, lh, hl, hh = (pair(parts[i], parts[i + 1], -1) for i in (0, 2, 4, 6))  # (..., W, 2)
    lo, hi = pair(ll, lh, 4), pair(hl, hh, 4)  # (B, C, T, H, 2, W, 2)
    out = pair(lo, hi, 3).reshape(B, C8 // 8, 2 * T, 2 * H, 2 * W)  # (B, C, T, 2, H, 2, W, 2)
    return out * (2 * 2**0.5) if rescale else out


class Patcher3D(Patcher):
    "Video -> patches: the first frame repeated ``patch_size`` times, then 3D haar levels or the 3D rearrange."

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        x = torch.cat([x[:, :, :1].expand(-1, -1, p, -1, -1), x[:, :, 1:]], dim=2)
        if self.patch_method == "haar":
            for _ in range(self.levels):
                x = _dwt3(x)
            return x
        if self.patch_method == "rearrange":
            B, C, T, H, W = x.shape
            x = x.reshape(B, C, T // p, p, H // p, p, W // p, p).permute(0, 1, 3, 5, 7, 2, 4, 6)
            return x.reshape(B, C * p**3, T // p, H // p, W // p)
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


class UnPatcher3D(UnPatcher):
    "Patches -> video: the inverse 3D haar levels or rearrange, then the ``patch_size - 1`` leading frames dropped."

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        if self.patch_method == "haar":
            for _ in range(self.levels):
                x = _idwt3(x)
            return x[:, :, p - 1:]
        if self.patch_method == "rearrange":
            B, Cp, T, H, W = x.shape
            x = x.reshape(B, Cp // p**3, p, p, p, T, H, W).permute(0, 1, 5, 2, 6, 3, 7, 4)
            return x.reshape(B, Cp // p**3, T * p, H * p, W * p)[:, :, p - 1:]
        raise ValueError("Unknown patch method: " + self.patch_method)
