"""
Patch embeddings for CroCo / DUSt3R style encoders (counterpart of
uniception_tpu/models/encoders/patch_embed.py):

    * PatchEmbedCroCo   — fixed image size check (patch_embed.py:34-61)
    * PatchEmbedDust3R  — any size divisible by the patch (patch_embed.py:68-82)
    * ManyAR_PatchEmbed — mixed landscape/portrait batches via true_shape
      (patch_embed.py:85-127): both orientations are patchified and merged
      per sample with ``torch.where``, as the JAX package does.

Tokens come out as (B, N, C) in the row-major order of the BCHW flatten, in
the compute ``dtype`` (None: the conv weight's dtype).
"""

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions

__all__ = ["PatchEmbedCroCo", "PatchEmbedDust3R", "ManyAR_PatchEmbed", "get_patch_embed"]


def _to_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


class PatchEmbedCroCo(nn.Module):
    "Conv patchifier with strict input-size check (CroCo semantics)."

    def __init__(
        self,
        img_size: Union[int, Tuple[int, int]] = 224,
        patch_size: Union[int, Tuple[int, int]] = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.img_size = _to_2tuple(img_size)
        self.patch_size = _to_2tuple(patch_size)
        self.grid_size = (self.img_size[0] // self.patch_size[0], self.img_size[1] // self.patch_size[1])
        self.num_patches = self.grid_size[0] * self.grid_size[1]
        self.embed_dim = embed_dim
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=self.patch_size, stride=self.patch_size, device=device)
        with torch.no_grad():
            # xavier-uniform over the flattened (out, in*kh*kw) view (patch_embed.py:63-65)
            nn.init.xavier_uniform_(self.proj.weight.view(embed_dim, -1), generator=generator)
            self.proj.bias.zero_()

    def _project(self, image: torch.Tensor) -> torch.Tensor:
        "BCHW image -> (B, H'*W', C) tokens, in the compute dtype (weights cast at use)."
        dt = self.compute_dtype or self.proj.weight.dtype
        x = F.conv2d(image.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt), stride=self.patch_size)
        return x.flatten(2).transpose(1, 2)

    def _check(self, H, W):
        if (H, W) != self.img_size:
            raise ValueError(f"Input image size ({H}, {W}) doesn't match model {self.img_size}.")

    def forward(self, image: torch.Tensor, true_shape: Optional[torch.Tensor] = None):
        B, _, H, W = image.shape
        self._check(H, W)
        x = self._project(image)
        pos = make_patch_positions(B, H // self.patch_size[0], W // self.patch_size[1], device=image.device)
        return x, pos


class PatchEmbedDust3R(PatchEmbedCroCo):
    "Patchifier accepting any size divisible by the patch size."

    def _check(self, H, W):
        if H % self.patch_size[0] or W % self.patch_size[1]:
            raise ValueError(f"Input image size ({H}, {W}) is not a multiple of the patch size {self.patch_size}.")


class ManyAR_PatchEmbed(PatchEmbedCroCo):
    """Mixed landscape/portrait batches.

    Inputs arrive in landscape frame (W >= H); ``true_shape`` (B, 2) gives
    each sample's actual (height, width). Portrait samples are patchified
    from the transposed image and merged with ``torch.where``.
    """

    def forward(self, image: torch.Tensor, true_shape: torch.Tensor):
        B, _, H, W = image.shape
        if W < H:
            raise ValueError(f"img should be in landscape mode, but got W={W} H={H}")
        if H % self.patch_size[0] or W % self.patch_size[1]:
            raise ValueError(f"Input image size ({H}, {W}) is not a multiple of the patch size {self.patch_size}.")
        if tuple(true_shape.shape) != (B, 2):
            raise ValueError(f"true_shape has the wrong shape={tuple(true_shape.shape)}")

        hp, wp = H // self.patch_size[0], W // self.patch_size[1]
        # a CPU true_shape (the server keeps it there) crosses without a stream sync
        is_landscape = (true_shape[:, 1] >= true_shape[:, 0]).to(image.device, non_blocking=True)[:, None, None]

        x_land = self._project(image)
        x_port = self._project(image.transpose(-1, -2))
        pos_land = make_patch_positions(B, hp, wp, device=image.device)
        pos_port = make_patch_positions(B, wp, hp, device=image.device)

        x = torch.where(is_landscape, x_land, x_port)
        pos = torch.where(is_landscape, pos_land, pos_port)
        return x, pos


def get_patch_embed(patch_embed_cls: str, img_size, patch_size, enc_embed_dim, *, device=None, dtype=None, generator=None):
    "String factory matching the reference's get_patch_embed (patch_embed.py:13-16)."
    classes = {
        "PatchEmbedCroCo": PatchEmbedCroCo,
        "PatchEmbedDust3R": PatchEmbedDust3R,
        "ManyAR_PatchEmbed": ManyAR_PatchEmbed,
    }
    if patch_embed_cls not in classes:
        raise ValueError(f"Unknown patch embed class: {patch_embed_cls}")
    return classes[patch_embed_cls](img_size, patch_size, 3, enc_embed_dim, device=device, dtype=dtype, generator=generator)
