"""
S.V without the softmax (counterpart of ``mxu_only`` in scripts/sweep_attention.py:56-92).

out = float(bf16(q k^T in fp32)) . v with fp32 accumulation, rounded to q's
dtype, over (B, N, H, D) tensors: the two products of attention with no scale,
softmax or mask between them (the body of ``_mxu_only_kernel``, :63-68). It is
a diagnostic: its time is the lower bound the attention kernels are measured
against, the share of their time that is not the exp/max/sum work.

    * :func:`sv_only_ref` — plain PyTorch, the reference for the kernel;
    * :func:`sv_only` — K8 for CUDA tensors: K1's bf16 kernel with the
      softmax compiled out (csrc/flash_attention.cu ``fa_fwd_bf16_kernel<false, 64, 64>``),
      reading q/k/v through the same TMA tensor maps; a CPU tensor takes the
      plain version.
"""

import torch

from uniception_tpu_torch.ops import kernel_lib
from uniception_tpu_torch.ops.flash_attention import FWD_ROWS, HEAD_DIM, _check, _layouts, _on_cuda

__all__ = ["sv_only", "sv_only_ref"]


def sv_only_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch S.V: q (B, Nq, H, D), k and v (B, Nk, H, D). The fp32
    scores are rounded to v's dtype before the fp32 product with v; the result
    is returned in q's dtype."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    return torch.einsum("bhnm,bmhd->bnhd", s.to(v.dtype).float(), v.float()).to(q.dtype)


def sv_only(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K8: S.V through the kernel on CUDA tensors (bfloat16, D = 64, unit stride
    on D, 16-byte aligned base and (b, n, h) strides, as K1 takes them); anything
    else on a CUDA device raises. A CPU tensor takes :func:`sv_only_ref`. Returns
    a contiguous (B, Nq, H, D) tensor. ``sv_only.launches`` counts the kernel
    launches."""
    if not _on_cuda("sv_only", q):
        return sv_only_ref(q, k, v)
    _check("sv_only", q, k, v, head_dims=(HEAD_DIM,))
    if q.dtype != torch.bfloat16:
        raise ValueError(f"sv_only: dtype {q.dtype} not supported (bfloat16)")
    B, Nq, H, D = q.shape
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    status = kernel_lib.library().uc_sv_only(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Nq, k.shape[1], D,
        _layouts((q, FWD_ROWS), (k, FWD_ROWS), (v, FWD_ROWS)), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_lib.check(status, "sv_only")
    sv_only.launches += 1
    return out


sv_only.launches = 0
