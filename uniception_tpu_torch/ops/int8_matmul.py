"""
Int8 matmul with the dynamic per-row activation quantization fused in
(counterpart of uniception_tpu/ops/int8_matmul.py):

    a_scale = max(max|x_row|, 1e-30) / 127
    x_q     = clip(round(x / a_scale), -127, 127)          (int8, half to even)
    y       = float(x_q @ w_q) * (a_scale * w_scale) + bias (int32 accumulation)

the symmetric dynamic scheme of ``Int8Linear`` (nn/quant.py).

    * :func:`int8_matmul_dynamic_ref` — plain PyTorch with the kernel's
      numerics; the int8 product is exact (fp32 products over K chunks of
      1024, whose sums stay below 2^24, added in int32);
    * :func:`int8_matmul_dynamic` — the hand-written CUDA kernels (K4:
      csrc/int8_matmul.cu: the rows' quantization, then the int8 GEMM on the
      shared Hopper mainloop, tiled by ops/gemm.py gemm_plan) for CUDA
      tensors; a CPU tensor takes the plain version;
    * :func:`int8_gemm` — K4's GEMM launch alone, on codes and row scales
      given (for the card's tests and timings);
    * :func:`int8_matmul_scaled` — K4 with the row scales given rather than
      taken from the rows (its quantization launch reads them), stopping at
      the exact int32 sums: a tensor-parallel row-parallel layer quantizes
      its share of a row's features with the whole row's abs-max, and the
      ranks sum their int32 shares before one dequantization
      (parallel/mesh.py ``RowParallel``); its plain version is
      :func:`int8_matmul_scaled_ref`.

Layouts are the JAX package's: x (..., K), w_q (K, N) int8, w_scale (1, N)
(or (N,)) fp32, bias (N,) fp32 or None.
"""

from typing import Optional

import torch

from uniception_tpu_torch.ops import kernel_lib
from uniception_tpu_torch.ops.gemm import TILE_M, gemm_plan, maps_array, sm_count
from uniception_tpu_torch.ops.serving_operands import kernel_op

__all__ = ["int8_matmul_dynamic", "int8_matmul_dynamic_ref", "int8_gemm", "absmax_scale", "quantize_rows", "int8_dot",
           "int8_matmul_scaled", "int8_matmul_scaled_ref", "quantize_rows_scaled"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {**_DTYPE_CODES, torch.int32: 2}  # int32: the GEMM's sums, not dequantized
_EXACT_K = 1024  # 127^2 * 1024 < 2^24: a sum of this many int8 products is exact in fp32


def absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale max(amax, 1e-30) / 127, as a true IEEE division
    on every device (PyTorch multiplies a CUDA tensor by the reciprocal of a
    Python-scalar divisor, which the kernels do not)."""
    amax = amax.clamp_min(1e-30)
    return amax / torch.full_like(amax, 127.0)


def quantize_rows(x2: torch.Tensor):
    "Symmetric per-row int8 quantization of a (M, K) tensor: (x_q int8, a_scale (M, 1) fp32)."
    xf = x2.float()
    a_scale = absmax_scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / a_scale).clamp(-127, 127).to(torch.int8), a_scale


def quantize_rows_scaled(x2: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    "The int8 codes clip(round(x / a_scale), -127, 127) of a (M, K) tensor with its (M,) or (M, 1) row scales given."
    return torch.round(x2.float() / a_scale.float().reshape(-1, 1)).clamp(-127, 127).to(torch.int8)


def int8_dot(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    "The exact int32 product of (M, K) and (K, N) int8 matrices, through fp32 products over K chunks."
    acc = None
    for k0 in range(0, a_q.shape[-1], _EXACT_K):
        part = (a_q[:, k0 : k0 + _EXACT_K].float() @ w_q[k0 : k0 + _EXACT_K].float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def int8_matmul_dynamic_ref(x, w_q, w_scale, bias=None, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    "Plain PyTorch version of :func:`int8_matmul_dynamic` (same quantization decisions, exact int32 product)."
    K, N = w_q.shape
    x_q, a_scale = quantize_rows(x.reshape(-1, K))
    y = int8_dot(x_q, w_q).float() * (a_scale * w_scale.float().reshape(1, N))
    if bias is not None:
        y = y + bias.float().reshape(1, N)
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)


def int8_matmul_scaled_ref(x, a_scale, w_q) -> torch.Tensor:
    "Plain PyTorch version of :func:`int8_matmul_scaled`: the codes from the given row scales, their exact int32 product."
    K, N = w_q.shape
    return int8_dot(quantize_rows_scaled(x.reshape(-1, K), a_scale), w_q).reshape(*x.shape[:-1], N)


def int8_matmul_scaled(x, a_scale, w_q) -> torch.Tensor:
    """K4 on given row scales, up to its int32 sums: ``clip(round(x / a_scale), -127, 127) @ w_q``, exact.

    x: (..., K) bfloat16 or float32; a_scale: one fp32 scale per row of x (numel M), at least each row's own
    max|x| / 127 so no code clips; w_q: (K, N) int8 as for :func:`int8_matmul_dynamic`. Returns (..., N) int32.
    The quantization launch reads the scales instead of computing them, then K4's GEMM writes its int32 sums
    instead of dequantizing: a row-parallel layer's ranks sum these exactly and dequantize once
    (parallel/mesh.py ``RowParallel``). ``int8_matmul_scaled.launches`` counts the calls on the card. A CPU tensor
    takes :func:`int8_matmul_scaled_ref`. The launch is the custom op ``uniception::int8_matmul_scaled``.
    """
    return int8_matmul_scaled_op(x, a_scale, w_q)


@kernel_op("int8_matmul_scaled")
def int8_matmul_scaled_op(x: torch.Tensor, a_scale: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    "K4 on given row scales, up to its int32 sums, as one op: :func:`int8_matmul_scaled`."
    if x.device.type == "cpu":
        return int8_matmul_scaled_ref(x, a_scale, w_q)
    x2, w_nk, K, N = _checked("int8_matmul_scaled", x, w_q, None, None, torch.int32)
    M = x2.shape[0]
    if a_scale.numel() != M or a_scale.device != x.device:
        raise ValueError(f"int8_matmul_scaled: a_scale must hold M = {M} row scales on {x.device}")
    if M == 0:
        return torch.empty((*x.shape[:-1], N), dtype=torch.int32, device=x.device)
    x_q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scales = a_scale.reshape(M).float().contiguous().clone()  # the launch reads them from its scratch
    out = _launch(x2, x_q, scales, w_nk, None, None, torch.int32, None, with_quant=2)
    int8_matmul_scaled.launches += 1
    return out.reshape(*x.shape[:-1], N)


@int8_matmul_scaled_op.register_fake
def _(x, a_scale, w_q):
    return x.new_empty((*x.shape[:-1], w_q.shape[1]), dtype=torch.int32)


def int8_matmul_dynamic(x, w_q, w_scale, bias=None, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K4: ``y = dequant(quant_rowwise(x) @ w_q) [+ bias]`` with the quantization fused in the kernel.

    x: (..., K) bfloat16 or float32; w_q: (K, N) int8 — the kernel reads it
    as (N, K), so a transposed view of a contiguous (N, K) tensor (what
    ``Int8Linear`` passes) costs nothing and any other layout is copied;
    w_scale: (1, N) or (N,); bias: (N,) or None (both used in fp32). Returns
    (..., N) in ``out_dtype`` (default x's dtype: bfloat16 or float32).

    A CPU tensor takes :func:`int8_matmul_dynamic_ref`. On CUDA anything the
    kernel does not take (K % 16 != 0, other dtypes, an unaligned x) raises.
    The launch is the custom op ``uniception::int8_matmul``.
    ``int8_matmul_dynamic.launches`` counts the kernel launches.
    """
    if x.device.type == "cpu" and torch.is_grad_enabled() and x.requires_grad:
        return int8_matmul_dynamic_ref(x, w_q, w_scale, bias, out_dtype)  # differentiated as the plain version
    return int8_matmul_op(x, w_q, w_scale, bias, out_dtype or x.dtype)


@kernel_op("int8_matmul")
def int8_matmul_op(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                   out_dtype: torch.dtype) -> torch.Tensor:
    "K4 (the rows' quantization, then the GEMM) as one op: :func:`int8_matmul_dynamic` with its ``out_dtype`` given."
    if x.device.type == "cpu":
        return int8_matmul_dynamic_ref(x, w_q, w_scale, bias, out_dtype)
    x2, w_nk, K, N = _checked("int8_matmul_dynamic", x, w_q, w_scale, bias, out_dtype)
    M = x2.shape[0]
    if M == 0:
        return torch.empty((*x.shape[:-1], N), dtype=out_dtype, device=x.device)
    x_q = torch.empty((M, K), dtype=torch.int8, device=x.device)  # scratch: the codes, then the GEMM's A
    a_scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = _launch(x2, x_q, a_scale, w_nk, w_scale, bias, out_dtype, None)
    int8_matmul_dynamic.launches += 1
    return out.reshape(*x.shape[:-1], N)


@int8_matmul_op.register_fake
def _(x, w_q, w_scale, bias, out_dtype):
    return x.new_empty((*x.shape[:-1], w_q.shape[1]), dtype=out_dtype)


def _checked(op, x, w_q, w_scale, bias, out_dtype):
    "What K4's launches take, checked on a CUDA x: (x as a contiguous aligned (M, K), w_q as (N, K), K, N)."
    if x.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {x.device}")
    if w_q.dim() != 2 or w_q.dtype != torch.int8 or w_q.device != x.device:
        raise ValueError(f"{op}: w_q must be a (K, N) int8 tensor on {x.device}")
    K, N = w_q.shape
    if x.shape[-1] != K:
        raise ValueError(f"{op}: x {tuple(x.shape)} does not fit w_q {tuple(w_q.shape)}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in (_OUT_CODES if w_scale is None else _DTYPE_CODES):
        raise ValueError(f"{op}: dtypes {x.dtype} -> {out_dtype} not supported (float32, bfloat16)")
    if K % 16:
        raise ValueError(f"{op}: K = {K} must be a multiple of 16")
    if (w_scale is not None and w_scale.numel() != N) or (bias is not None and bias.numel() != N):
        raise ValueError(f"{op}: w_scale and bias must hold N = {N} values")
    x2 = x.reshape(-1, K).contiguous()
    if x2.numel() and x2.data_ptr() % 16:
        raise ValueError(f"{op}: x needs a 16-byte aligned base")
    return x2, (w_q.t() if w_q.t().is_contiguous() else w_q.t().contiguous()), K, N


def _launch(x2, x_q, a_scale, w_nk, w_scale, bias, out_dtype, plan, with_quant=1):
    """K4's C entry: the rows' quantization of x2 into x_q (none when x2 is None) with its scales written to a_scale
    (``with_quant`` 1) or read from it (2), then the GEMM with ``plan`` = (bn, split), or gemm_plan's. ``out_dtype``
    int32 writes the GEMM's sums (``w_scale`` and ``bias`` None)."""
    M, K = x_q.shape
    N = w_nk.shape[0]
    bn, split = plan or gemm_plan(M, N, K, 1, sm_count(x_q.device.index or 0))
    ws = None if w_scale is None else w_scale.reshape(N).float().contiguous()
    b = None if bias is None else bias.reshape(N).float().contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    tiles = -(-M // TILE_M) * -(-N // bn)
    work = torch.zeros(M * N + tiles, dtype=torch.int32, device=x_q.device) if split > 1 else None
    status = kernel_lib.library().uc_int8_matmul(
        None if x2 is None else x2.data_ptr(), w_nk.data_ptr(), None if ws is None else ws.data_ptr(),
        None if b is None else b.data_ptr(),
        out.data_ptr(), x_q.data_ptr(), a_scale.data_ptr(), None if work is None else work.data_ptr(),
        maps_array(M, K, N, 1, bn), 1 if x2 is None else _DTYPE_CODES[x2.dtype], _OUT_CODES[out_dtype],
        M, N, K, bn, split, 0 if x2 is None else with_quant, torch.cuda.current_stream(x_q.device).cuda_stream,
    )
    kernel_lib.check(status, "int8_matmul_dynamic")
    return out


def int8_gemm(x_q, a_scale, w_nk, w_scale, bias=None, out_dtype=torch.bfloat16, plan=None) -> torch.Tensor:
    """K4's GEMM launch alone: ``float(x_q @ w_nk^T) * (a_scale * w_scale) + bias`` on CUDA tensors.

    x_q: contiguous (M, K) int8 codes and a_scale their (M,) float32 row scales (what :func:`quantize_rows`
    gives); w_nk: contiguous (N, K) int8; ``plan`` = (bn, split) forces a tiling (else gemm_plan's).
    Returns (M, N) in ``out_dtype``. Not counted in ``int8_matmul_dynamic.launches``.
    """
    if x_q.device.type != "cuda" or x_q.dtype != torch.int8 or w_nk.dtype != torch.int8 or x_q.shape[1] % 16:
        raise ValueError("int8_gemm: needs CUDA int8 x_q and w_nk with K a multiple of 16")
    if not (x_q.is_contiguous() and w_nk.is_contiguous()) or x_q.shape[1] != w_nk.shape[1]:
        raise ValueError(f"int8_gemm: x_q {tuple(x_q.shape)} and w_nk {tuple(w_nk.shape)} must be contiguous (M, K), (N, K)")
    a_scale = a_scale.reshape(-1).float().contiguous()
    return _launch(None, x_q, a_scale, w_nk, w_scale, bias, out_dtype, plan)


int8_matmul_dynamic.launches = 0
int8_matmul_scaled.launches = 0
