"""
Zero-runtime-cost weight transforms for the int8 serving path (counterpart of
uniception_tpu/nn/smooth.py): SmoothQuant-style scale migration and
QuaRot-style Hadamard rotations.

Both are exact identities on the fp32 network function: they rewrite weights
(and the adjacent LayerNorm affine) so the int8 program is unchanged (the same
kernels, per-output-channel scales and dynamic per-token activation
quantization) while the quantization error drops. They compose with GPTQ
(nn/gptq.py) as GPTQ composes with RTN.

Scale migration (SmoothQuant, Xiao et al. 2023): a per-input-channel scale
``s`` moved across a linear's input boundary, folded exactly into the donor
that produces that input:

    * ``attn.qkv``         <- the block's ``norm1`` affine (weight, bias / s)
    * ``mlp.fc1``          <- ``norm2`` (self blocks) / ``norm3`` (cross)
    * ``cross_attn.projq`` <- ``norm2`` (cross blocks)
    * ``cross_attn.projk/projv`` <- ``norm_y`` (one input, one shared s)
    * ``attn.proj``        <- the v rows of ``attn.qkv`` (attention output is
      linear in v)
    * ``cross_attn.proj``  <- ``cross_attn.projv``'s rows
    * ``mlp.fc2`` has no exact donor (GELU does not commute with a
      per-channel scale) and is left alone.

``s_j = amax_x(j)^alpha / amax_w(j)^(1-alpha)``: alpha = 1 equalizes the
activation channels, alpha = 0 the weight columns (cross-layer
equalization).

Hadamard rotation (QuaRot, Ashkboos et al. 2024): a per-head orthogonal
``R = H_d . diag(+-1)`` inserted as ``R R^T = I`` between the v projection and
the output projection: v's output rows (of a torch (out, in) weight) rotated
by R, proj's input columns by R^T. q and k get none: RoPE sits between their
projections and the dot product.

The transforms change some layers' inputs deterministically (x -> x / s,
x -> x R), so calibrated Hessians follow analytically: pass ``hessians`` and
the affected entries are updated in place (D^-1 H D^-1, B^T H B), so one
capture serves every variant.

Gates kept from the JAX package: latent attention (an inner width other than
the model width; the port's blocks have none, the check is the same) and the
differential blocks' own attention (not ``Attention``/``CrossAttention``) are
skipped, and only power-of-two head dims rotate. The port has only the loop
layout, so the JAX package's stacked-depth branches fall away.
"""

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from uniception_tpu_torch.nn.blocks import Attention, CrossAttention, CrossAttentionBlock, SelfAttentionBlock
from uniception_tpu_torch.nn.quant import Int8Linear

__all__ = [
    "hadamard",
    "head_rotation",
    "smooth_trunk",
    "rotate_trunk",
]


def hadamard(n: int) -> torch.Tensor:
    "Normalized (orthogonal) Hadamard matrix of power-of-two order n (Sylvester), float64."
    if n & (n - 1):
        raise ValueError(f"Hadamard order must be a power of 2, got {n}")
    H = torch.ones((1, 1), dtype=torch.float64)
    while H.shape[0] < n:
        H = torch.cat([torch.cat([H, H], dim=1), torch.cat([H, -H], dim=1)], dim=0)
    return H / np.sqrt(n)


def head_rotation(head_dim: int, seed: int = 0) -> torch.Tensor:
    """The per-head rotation ``R = H_d . diag(+-1)`` (float64): Hadamard times
    a sign diagonal drawn from ``np.random.RandomState(seed)``, the JAX
    package's draw, so both packages build the same R."""
    signs = np.where(np.random.RandomState(seed).rand(head_dim) < 0.5, -1.0, 1.0)
    return hadamard(head_dim) * torch.from_numpy(signs)  # columns signed: H @ diag(signs)


# ---------------------------------------------------------------------------
# walking


def _iter_blocks(module: nn.Module, _path: str = ""):
    "Yield (loop_path, block) for every standard block under ``module`` (the root included)."
    if isinstance(module, (SelfAttentionBlock, CrossAttentionBlock)):
        yield _path, module
        return
    for name, child in module.named_children():
        p = f"{_path}.{name}".lstrip(".")
        if isinstance(child, (SelfAttentionBlock, CrossAttentionBlock)):
            # the Diff* blocks subclass these and carry their own attention: the isinstance gates below skip it
            yield p, child
        elif not isinstance(child, Int8Linear):
            yield from _iter_blocks(child, p)


def _key(block_path: str, rel: str) -> str:
    return f"{block_path}.{rel}".lstrip(".")


def _stat(stats: Dict, block_path: str, rel: str) -> Optional[torch.Tensor]:
    "The statistic of ``block.rel`` (loop key ``{block_path}.{rel}``) as float64, or None."
    v = stats.get(_key(block_path, rel))
    return None if v is None else torch.as_tensor(v).double()


def _latent(attn: Attention) -> bool:
    "Latent attention: the heads' inner width differs from the model width (JAX ``latent_attn_dim``)."
    return attn.num_heads * attn.head_dim != attn.qkv.weight.shape[-1]


def _hessian_scale(hessians, block_path: str, rel: str, s: torch.Tensor) -> None:
    "In place H <- D^-1 H D^-1 for the Hessian entry of a target."
    if hessians is None:
        return
    k = _key(block_path, rel)
    if k in hessians:
        H = torch.as_tensor(hessians[k])
        inv = 1.0 / s.to(H.device, torch.float64)
        hessians[k] = H * torch.outer(inv, inv)


def _hessian_rotate(hessians, block_path: str, rel: str, R: torch.Tensor, num_heads: int) -> None:
    "In place H <- B^T H B with B = blockdiag(R x num_heads) for a target."
    if hessians is None:
        return
    k = _key(block_path, rel)
    if k in hessians:
        H = torch.as_tensor(hessians[k])
        D, d = R.shape[0], H.shape[0]
        if d != num_heads * D:
            raise ValueError(f"{k}: Hessian of order {d} for {num_heads} heads of {D}")
        Rd = R.to(H.device, H.dtype)
        Hb = torch.einsum("da,hdje,eb->hajb", Rd, H.reshape(num_heads, D, num_heads, D), Rd)
        hessians[k] = Hb.reshape(d, d)


# ---------------------------------------------------------------------------
# parameter folds (torch layouts: a weight is (out, in))


def _scales(amax_x: torch.Tensor, weight: torch.Tensor, alpha: float) -> torch.Tensor:
    "s_j = amax_x_j^alpha / amax_w_j^(1-alpha) per input channel j, fp32, guarded for dead channels."
    aw = weight.float().abs().amax(dim=0)  # (in,)
    ax = amax_x.to(aw.device, torch.float32)
    s = torch.pow(ax.clamp_min(1e-12), alpha) / torch.pow(aw.clamp_min(1e-12), 1.0 - alpha)
    s = torch.where((ax > 0) & (aw > 0), s, torch.ones_like(s))
    return s.clamp(1e-5, 1e5)


def _set(param: torch.Tensor, value: torch.Tensor) -> None:
    "Write an fp32 result into a parameter in its own dtype."
    param.copy_(value.to(param.dtype))


def _fold_into_norm(norm, lin: nn.Linear, s: torch.Tensor) -> bool:
    "x / s into the donor LayerNorm's affine, s into the linear's input columns. Exact."
    if not isinstance(norm, nn.LayerNorm) or norm.weight is None:
        return False
    _set(lin.weight, lin.weight.float() * s[None, :])
    _set(norm.weight, norm.weight.float() / s)
    if norm.bias is not None:
        _set(norm.bias, norm.bias.float() / s)
    return True


def _fold_v_to_proj(v_lin: nn.Linear, v_rows: slice, proj: nn.Linear, t: torch.Tensor) -> None:
    """v's output rows (``v_rows`` of ``v_lin``'s output axis) scaled by 1/t, proj's input columns by t.
    Attention output is linear in v, so the fold is exact."""
    w = v_lin.weight.float()
    w[v_rows, :] = w[v_rows, :] / t[:, None]
    _set(v_lin.weight, w)
    if v_lin.bias is not None:
        b = v_lin.bias.float()
        b[v_rows] = b[v_rows] / t
        _set(v_lin.bias, b)
    _set(proj.weight, proj.weight.float() * t[None, :])


def _rotate_v_to_proj(v_lin: nn.Linear, v_start: int, proj: nn.Linear, R: torch.Tensor, num_heads: int) -> None:
    "Per-head R on v's output rows, R^T on proj's input columns. ``v_start`` offsets into v_lin's output axis."
    D = R.shape[0]
    inner = num_heads * D
    Rf = R.to(v_lin.weight.device, torch.float32)
    rows = slice(v_start, v_start + inner)

    w = v_lin.weight.float()
    v = w[rows, :].reshape(num_heads, D, -1)
    w[rows, :] = torch.einsum("hdi,de->hei", v, Rf).reshape(inner, -1)
    _set(v_lin.weight, w)
    if v_lin.bias is not None:
        b = v_lin.bias.float()
        b[rows] = torch.einsum("hd,de->he", b[rows].reshape(num_heads, D), Rf).reshape(inner)
        _set(v_lin.bias, b)

    pw = proj.weight.float()  # (out, inner)
    pv = pw.reshape(pw.shape[0], num_heads, D)
    _set(proj.weight, torch.einsum("ed,che->chd", Rf, pv).reshape(pw.shape[0], inner))  # columns <- R^T columns


# ---------------------------------------------------------------------------
# public transforms


@torch.no_grad()
def smooth_trunk(
    model: nn.Module,
    amax: Dict,
    alpha: float = 0.25,
    hessians: Optional[Dict] = None,
) -> int:
    """Apply SmoothQuant-style scale migration to every standard block of a
    float model, in place. ``amax`` maps loop-layout linear paths to
    per-input-channel |x| maxima (``nn.gptq.harvest_act_amax``; tensors or
    arrays). Targets with no entry are skipped. Returns the number of folds.
    Call before ``quantize_trunk``; pass ``hessians`` to keep a captured
    Hessian dict consistent for a later GPTQ pass."""
    folds = 0
    for path, block in _iter_blocks(model):
        is_cross = isinstance(block, CrossAttentionBlock)

        # self-attention qkv <- norm1
        attn = block.attn
        if isinstance(attn, Attention) and not _latent(attn):
            ax = _stat(amax, path, "attn.qkv")
            if ax is not None:
                s = _scales(ax, attn.qkv.weight, alpha)
                if _fold_into_norm(block.norm1, attn.qkv, s):
                    _hessian_scale(hessians, path, "attn.qkv", s)
                    folds += 1
            # attn.proj <- v rows of qkv
            ax = _stat(amax, path, "attn.proj")
            if ax is not None:
                t = _scales(ax, attn.proj.weight, alpha)
                inner = attn.num_heads * attn.head_dim
                _fold_v_to_proj(attn.qkv, slice(2 * inner, 3 * inner), attn.proj, t)
                _hessian_scale(hessians, path, "attn.proj", t)
                folds += 1

        # mlp.fc1 <- norm2 (self) / norm3 (cross)
        mlp_norm = block.norm3 if is_cross else block.norm2
        if isinstance(getattr(block.mlp, "fc1", None), nn.Linear):
            ax = _stat(amax, path, "mlp.fc1")
            if ax is not None:
                s = _scales(ax, block.mlp.fc1.weight, alpha)
                if _fold_into_norm(mlp_norm, block.mlp.fc1, s):
                    _hessian_scale(hessians, path, "mlp.fc1", s)
                    folds += 1
        # mlp.fc2 deliberately untouched: GELU blocks an exact fold

        if is_cross and isinstance(block.cross_attn, CrossAttention):
            ca = block.cross_attn
            # projq <- norm2
            ax = _stat(amax, path, "cross_attn.projq")
            if ax is not None:
                s = _scales(ax, ca.projq.weight, alpha)
                if _fold_into_norm(block.norm2, ca.projq, s):
                    _hessian_scale(hessians, path, "cross_attn.projq", s)
                    folds += 1
            # projk + projv <- norm_y (one input, one shared scale over both weights' column maxima)
            ax = _stat(amax, path, "cross_attn.projv")
            if ax is not None and isinstance(block.norm_y, nn.LayerNorm) and block.norm_y.weight is not None:
                s = _scales(ax, torch.cat([ca.projk.weight, ca.projv.weight], dim=0), alpha)
                _set(ca.projk.weight, ca.projk.weight.float() * s[None, :])
                if _fold_into_norm(block.norm_y, ca.projv, s):
                    _hessian_scale(hessians, path, "cross_attn.projv", s)
                    _hessian_scale(hessians, path, "cross_attn.projk", s)
                    folds += 1
            # cross proj <- projv output rows
            ax = _stat(amax, path, "cross_attn.proj")
            if ax is not None:
                t = _scales(ax, ca.proj.weight, alpha)
                _fold_v_to_proj(ca.projv, slice(0, ca.num_heads * ca.head_dim), ca.proj, t)
                _hessian_scale(hessians, path, "cross_attn.proj", t)
                folds += 1
    return folds


@torch.no_grad()
def rotate_trunk(model: nn.Module, hessians: Optional[Dict] = None, seed: int = 0) -> int:
    """Insert the per-head Hadamard rotation into every standard block's v ->
    proj pair (self and cross attention), in place on a float model.
    Deterministic in ``seed``. Returns the rotations applied. Call before
    ``quantize_trunk`` (and after :func:`smooth_trunk` when composing: the
    Hessian updates compose in the order applied)."""
    done = 0
    for path, block in _iter_blocks(model):
        attn = block.attn
        if isinstance(attn, Attention) and not _latent(attn) and (attn.head_dim & (attn.head_dim - 1)) == 0:
            R = head_rotation(attn.head_dim, seed)
            inner = attn.num_heads * attn.head_dim
            _rotate_v_to_proj(attn.qkv, 2 * inner, attn.proj, R, attn.num_heads)
            _hessian_rotate(hessians, path, "attn.proj", R, attn.num_heads)
            done += 1
        if isinstance(block, CrossAttentionBlock) and isinstance(block.cross_attn, CrossAttention):
            ca = block.cross_attn
            if (ca.head_dim & (ca.head_dim - 1)) == 0:
                R = head_rotation(ca.head_dim, seed)
                _rotate_v_to_proj(ca.projv, 0, ca.proj, R, ca.num_heads)
                _hessian_rotate(hessians, path, "cross_attn.proj", R, ca.num_heads)
                done += 1
    return done
