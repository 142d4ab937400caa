"""
Positional-encoding helpers shared by encoders (counterpart of uniception_tpu/models/encoders/pe_utils.py):
DINO-style bicubic interpolation of a learned patch PE table with the historical ``interpolate_offset=0.1``
scale-factor kludge (reference encoders/patch_embedder.py:91-133, torch.hub dinov2 interpolate_pos_encoding), the
sinusoid table that the global- and alternating-attention info sharing use for their view- and set-index
encodings, and the 2D sine-cosine table.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["interpolate_patch_pos_embed", "sinusoid_encoding_table", "get_2d_sincos_pos_embed"]


def interpolate_patch_pos_embed(
    patch_pos_embed: torch.Tensor,
    h0: int,
    w0: int,
    interpolate_offset: float = 0.1,
    antialias: bool = False,
) -> torch.Tensor:
    """Interpolate a (1, N, D) square-grid PE table to an (h0, w0) grid: (1, h0 * w0, D), row-major over
    (h0, w0) as the JAX package lays it out (torch.hub's DINOv2 passes the sizes as (w0, h0)).

    Bicubic with ``align_corners=False`` in fp32, cast back to the table's dtype. With ``interpolate_offset`` set
    (DINO's kludge) the call passes ``scale_factor=((h0 + offset) / m, (w0 + offset) / m)``, so torch maps output
    pixels to sources by that scale rather than by the output size, as JAX ops/resize.py reproduces. As in the JAX
    package, ``antialias`` is accepted and not applied (DINOv2's default is False).
    """
    n = patch_pos_embed.shape[1]
    m = int(math.sqrt(n))
    if m * m != n:
        raise ValueError(f"PE table is not square: {n}")
    if (h0, w0) == (m, m):
        return patch_pos_embed
    dim = patch_pos_embed.shape[-1]
    grid = patch_pos_embed.reshape(1, m, m, dim).permute(0, 3, 1, 2).float()
    if interpolate_offset:
        scale = (float(h0 + interpolate_offset) / m, float(w0 + interpolate_offset) / m)
        out = F.interpolate(grid, scale_factor=scale, mode="bicubic", align_corners=False)
        if tuple(out.shape[-2:]) != (h0, w0):
            raise ValueError(f"interpolated PE grid {tuple(out.shape[-2:])} is not ({h0}, {w0})")
    else:
        out = F.interpolate(grid, size=(h0, w0), mode="bicubic", align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(1, h0 * w0, dim).to(patch_pos_embed.dtype)


def sinusoid_encoding_table(n_position: int, d_hid: int, base: float) -> np.ndarray:
    "Sinusoid PE table (reference dense_rep_encoder.py:178-188): computed in float64, returned as float32."
    position = np.arange(n_position)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(base, 2 * (hid // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, n_cls_token: int = 0) -> np.ndarray:
    """2D sine-cosine positional embedding table (reference libs/croco/pos_embed.py:19-66): (n_cls_token +
    grid_size^2, embed_dim) float32; the first half encodes the grid's x (column), the second its y (row), with
    base-10000 frequencies; the cls rows are zeros."""

    def one_axis(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(2, -1)
    emb = np.concatenate([one_axis(embed_dim // 2, grid[0]), one_axis(embed_dim // 2, grid[1])], axis=1)
    if n_cls_token > 0:
        emb = np.concatenate([np.zeros((n_cls_token, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)
