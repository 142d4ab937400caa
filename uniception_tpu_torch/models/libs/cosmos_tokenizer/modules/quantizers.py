"""
Quantizers of the Cosmos discrete tokenizers (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/modules/quantizers.py; reference
uniception/models/libs/cosmos_tokenizer/modules/quantizers.py:35-501): FSQuantizer (finite scalar quantization,
arXiv:2309.15505), ResidualFSQuantizer (arXiv:2107.03312 Alg. 1), VectorQuantizer (taming-transformers style) and
LFQuantizer (lookup-free, magvit2 style).

All take (B, C, H, W) latents (channel-first, as the reference) and round with straight-through gradients. FSQ's
index arithmetic is the JAX package's: codes to indices by an fp32 sum of the shifted codes times the level basis,
cast to int32; indices to codes by int32 floor division and remainder.
"""

from typing import List, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["FSQuantizer", "ResidualFSQuantizer", "VectorQuantizer", "LFQuantizer"]


def _round_ste(z: torch.Tensor) -> torch.Tensor:
    "Round half to even, with straight-through gradients."
    return z + (torch.round(z) - z).detach()


class FSQuantizer(nn.Module):
    "Finite scalar quantization (quantizers.py:68-212); no parameters."

    def __init__(self, levels: List[int], dim: Optional[int] = None, num_codebooks: int = 1, **ignore_kwargs):
        super().__init__()
        self._levels = np.asarray(levels, np.int32)
        self._basis = np.concatenate([[1], np.cumprod(levels[:-1])]).astype(np.int32)
        self.codebook_dim = len(levels)
        self.num_codebooks = num_codebooks
        self.effective_codebook_dim = self.codebook_dim * num_codebooks
        self.dim = dim if dim is not None else self.effective_codebook_dim
        assert self.dim == self.effective_codebook_dim, "projections not supported (unused in Cosmos configs)"
        self.codebook_size = int(np.prod(levels))

    def _const(self, arr: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=dtype or like.dtype, device=like.device)

    def bound(self, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        levels = self._const(self._levels, z, torch.float32)
        half_l = (levels - 1) * (1 + eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        return _round_ste(self.bound(z)) / self._const(self._levels // 2, z)

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        half_width = self._const(self._levels // 2, zhat)
        shifted = zhat * half_width + half_width
        return (shifted * self._const(self._basis, zhat)).sum(dim=-1).to(torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        "(B, h, w) or (B, N) integer indices -> (B, codebook_dim, ...) fp32 codes."
        idx = indices.to(torch.int32)[..., None]
        levels, basis = self._const(self._levels, idx), self._const(self._basis, idx)
        codes_nc = torch.div(idx, basis, rounding_mode="floor") % levels
        half_width = self._const(self._levels // 2, idx)
        codes = (codes_nc - half_width).float() / half_width.float()
        return torch.movedim(codes, -1, 1)

    def forward(self, z: torch.Tensor):
        """z: (B, C, *spatial) channel-first (an image's H, W). Returns (indices (B, *spatial) int32, codes
        (B, C, *spatial) in z's dtype, a zero loss (B, 1, 1, 1))."""
        is_img = z.dim() >= 4
        B = z.shape[0]
        if is_img:
            C, spatial = z.shape[1], tuple(z.shape[2:])
            zf = torch.movedim(z, 1, -1).reshape(B, -1, C)
        else:
            zf = z
        zf = zf.reshape(zf.shape[0], zf.shape[1], self.num_codebooks, self.codebook_dim)
        codes = self.quantize(zf.float())
        indices = self.codes_to_indices(codes)
        out = codes.reshape(codes.shape[0], codes.shape[1], -1)
        if is_img:
            out = torch.movedim(out.reshape((B,) + spatial + (-1,)), -1, 1)
            indices = indices.reshape((B,) + spatial + (self.num_codebooks,))
        if self.num_codebooks == 1:
            indices = indices[..., 0]
        return indices, out.to(z.dtype), torch.zeros((B, 1, 1, 1), dtype=out.dtype, device=z.device)


class ResidualFSQuantizer(nn.Module):
    "Residual FSQ (quantizers.py:35-65): each layer quantizes what the earlier ones left."

    def __init__(self, levels: List[int], num_quantizers: int, **ignore_kwargs):
        super().__init__()
        self.layers = nn.ModuleList([FSQuantizer(levels=levels) for _ in range(num_quantizers)])

    def forward(self, x: torch.Tensor):
        indices_stack, residual, quantized_out, loss_out = [], x, 0.0, 0.0
        for layer in self.layers:
            quant_indices, z, loss = layer(residual)
            indices_stack.append(quant_indices)
            residual = residual - z.detach()
            quantized_out = quantized_out + z
            loss_out = loss_out + loss
        return torch.stack(indices_stack, dim=1), quantized_out, loss_out

    def indices_to_codes(self, indices_stack: torch.Tensor) -> torch.Tensor:
        out = 0.0
        for i, layer in enumerate(self.layers):
            out = out + layer.indices_to_codes(indices_stack[:, i])
        return out


class VectorQuantizer(nn.Module):
    """Taming-transformers VQ (quantizers.py:214-...): the nearest of ``num_embeddings`` codebook rows, drawn
    uniform in (-1/n, 1/n) from ``generator``. The parameter's key is ``embedding``, the JAX module's."""

    def __init__(self, num_embeddings: int, embedding_dim: int, beta: float = 0.25, legacy: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None, **ignore_kwargs):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.legacy = num_embeddings, embedding_dim, beta, legacy
        self.embedding = nn.Parameter(torch.empty(num_embeddings, embedding_dim, device=device))
        with torch.no_grad():
            self.embedding.uniform_(-1.0 / num_embeddings, 1.0 / num_embeddings, generator=generator)

    def forward(self, z: torch.Tensor):
        "z: (B, C, H, W). Returns (quantized (B, C, H, W), loss, (None, None, indices (B, H, W)))."
        B, C, H, W = z.shape
        z_nhwc = z.permute(0, 2, 3, 1)
        zf = z_nhwc.reshape(-1, self.e_dim)
        emb = self.embedding
        d = (zf**2).sum(dim=1, keepdim=True) + (emb**2).sum(dim=1)[None] - 2 * zf @ emb.T
        idx = torch.argmin(d, dim=1)
        z_q = emb[idx].reshape(B, H, W, C)
        commit, codebook = torch.mean((z_q.detach() - z_nhwc) ** 2), torch.mean((z_q - z_nhwc.detach()) ** 2)
        loss = commit + self.beta * codebook if self.legacy else self.beta * commit + codebook
        z_q = z_nhwc + (z_q - z_nhwc).detach()  # straight-through
        return z_q.permute(0, 3, 1, 2), loss, (None, None, idx.reshape(B, H, W))

    def get_codebook_entry(self, indices: torch.Tensor, shape=None) -> torch.Tensor:
        z_q = self.embedding[indices]
        if shape is not None:
            z_q = z_q.reshape(shape).permute(0, 3, 1, 2)
        return z_q


class LFQuantizer(nn.Module):
    "Lookup-free quantization (magvit2 style): the sign of each of ``codebook_dim`` channels; no parameters."

    def __init__(self, codebook_size: int, codebook_dim: int, embed_dim: Optional[int] = None, **ignore_kwargs):
        super().__init__()
        assert 2**codebook_dim == codebook_size, "codebook_size must be 2**codebook_dim"
        self.codebook_dim = codebook_dim
        self.codebook_size = codebook_size

    def forward(self, z: torch.Tensor):
        "z: (B, C, H, W) with C == codebook_dim. Returns (indices (B, H, W) int32, quantized, commit loss)."
        q = torch.where(z > 0, 1.0, -1.0).to(z.dtype)
        z_q = z + (q - z).detach()
        weights = (2 ** torch.arange(self.codebook_dim, dtype=torch.int32, device=z.device)).reshape(1, -1, 1, 1)
        indices = ((q > 0).to(torch.int32) * weights).sum(dim=1, dtype=torch.int32)
        return indices, z_q, torch.mean((z - q.detach()) ** 2)
