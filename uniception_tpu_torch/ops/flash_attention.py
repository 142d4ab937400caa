"""
Flash attention, forward and backward (counterpart of uniception_tpu/ops/flash_attention.py).

Non-causal softmax(q k^T * scale) v over (B, N, H, D) tensors, with fp32
scores and accumulators and p cast to v's dtype before the P.V product, as
the Pallas kernel computes it. Training saves the (B, H, Nq) fp32 logsumexp
of the scaled scores, and the backward recomputes p from it (the standard
FlashAttention-2 recurrence of the Pallas backward kernels).

    * :func:`flash_attention_ref`, :func:`flash_attention_lse_ref` and
      :func:`flash_attention_bwd_ref` — plain PyTorch, the references for the
      kernels; ``flash_attention_ref`` is also the "naive" implementation;
    * :func:`flash_attention_fwd` and :func:`flash_attention_bwd` — the
      hand-written CUDA kernels (K1: csrc/flash_attention.cu, K3:
      csrc/flash_attention_bwd.cu) for CUDA tensors; a CPU tensor takes the
      plain versions. Their bf16 kernels read q/k/v (and dO) through TMA
      tensor maps whose dims, byte strides and boxes :func:`tma_layout`
      computes here;
    * :class:`FlashAttentionFunction` — the autograd Function over the two;
    * :func:`flash_attention` — the entry point: through the Function when a
      gradient is needed, else the forward without the logsumexp;
    * :func:`flash_attention_int8` and :func:`flash_attention_int8_ref` — the
      int8 inference variant of the single-key-block case (K6:
      csrc/flash_attention_int8.cu) and its plain version, built on
      :func:`flash_attention_int8_prep_ref`, the plain version of K6's prep
      (:func:`flash_attention_int8_prep` launches the prep alone).

Each launch of K1, K6 and K6's prep is a custom op of the ``uniception``
namespace (``torch.library``), whose real implementation checks, launches and
counts (or takes the plain version on a CPU tensor) and whose fake kernel
gives ``torch.export`` the outputs' shapes, so an exported program replays the
launches (utils/export.py); an eager call runs the implementation without the
op's dispatch (ops/serving_operands.py ``kernel_op``). K3 is not on the
serving path and launches directly.
"""

import collections
import ctypes
import functools
from typing import Optional

import torch

from uniception_tpu_torch.ops import kernel_lib
from uniception_tpu_torch.ops.gemm import sm_count
from uniception_tpu_torch.ops.int8_matmul import absmax_scale
from uniception_tpu_torch.ops.serving_operands import kernel_op

__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_ref",
    "flash_attention_lse_ref",
    "flash_attention_bwd_ref",
    "FlashAttentionFunction",
    "flash_attention_int8",
    "flash_attention_int8_ref",
    "flash_attention_int8_prep",
    "flash_attention_int8_prep_ref",
    "int8_pv_keys",
    "tma_layout",
    "fwd_rows",
    "tf32_workspace_floats",
    "k1_wide_tiles_per_split",
    "k1_wide_workspace_floats",
    "k3_tf32_workspace_floats",
    "head_dim_rule",
    "pad_head_dim",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The head dims each attention kernel takes, in one place (head_dim_rule): K1 any D up to 512, K3 and K6 any D up
# to 256, K5 any D % 4 == 0 up to 256 (the JAX package's fused rule); K8 only the sweep script's 64. A D that is not
# a multiple of 8 is copied into a zero-padded one first (pad_head_dim). A call outside its kernel's rule raises,
# naming the ROADMAP item that would widen it, and launches nothing.
MAX_HEAD_DIM = {"K1": 512, "K3": 256, "K5": 256, "K6": 256, "K8": 64}
HEAD_DIM_ITEM = "ROADMAP queue 2 item a"
HEAD_DIM_ALIGN = 8  # a bf16 row of D elements is a 16-byte multiple: what a tensor map's strides need
BOX_COLS = 64  # columns of each TMA box: one 128-byte swizzle row; a K1 tile of D > 64 is D / 64 boxes, rounded up
INT8_MODES = ("int8", "int8pv")
INT8_MAX_KEYS = 1024  # one key block: the Pallas int8 kernel's case (its _plan keeps 1024 keys up to D = 256)
INT8_CHUNK = 128  # K6's key tile and prep chunk (csrc/flash_attention_int8.cu BK): the scratch's padding
INT8_PREP_KEYS = 4  # keys per thread of K6's prep (PREP_KEYS): the first step of its k sum's fixed order
# Rows of the TMA boxes the bf16 kernels are built for (csrc/flash_attention.cu BQ / BK,
# csrc/flash_attention_bwd.cu OWN / LOOP); the C entry points refuse any other box.
FWD_ROWS = 128  # K1: query and key tiles
WIDE_FROM, WIDE_ROWS = 128, 64  # K1 above D = 128 (its wide kernel): 64-row query and key tiles
# K1's wide kernel splits the keys when its units fill less than a wave of the SMs (k1_wide_tiles_per_split). The
# fixed costs of a unit in 64-key tiles (a tile's K and V are 128 KB at D = 512): its Q load and epilogue, and with
# key splits its fp32 O written to the workspace and read back by the combine
WIDE_UNIT_COST_TILES, WIDE_SPLIT_COST_TILES = 1, 1
H100_SMS = 132
BWD_OWN_ROWS, BWD_LOOP_ROWS = 128, 64  # K3: a block's own rows, and the rows of each tile it loops over
TMA_MAX_STRIDE = 1 << 40  # a tensor map's byte strides stay below 2^40
# K1 and K3 fp32: D up to 16 (the JAX training example's heads) takes the CUDA-core kernels, every other D the 3xTF32
# kernels and their split operands' workspace (csrc/flash_attention.cu and flash_attention_bwd.cu F32_SMALL_DP,
# fa_fwd_tf32_kernel, fa_bwd_tf32_kernel)
F32_SMALL_HEAD_DIM = 16


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None):
    """Plain PyTorch attention with the kernel's numerics, and its logsumexp.

    q: (B, Nq, H, D); k, v: (B, Nk, H, D). Scores, max and sum in fp32; the
    unnormalized p is rounded to v's dtype before P.V (the Pallas kernel's
    ``p.astype(v.dtype)``), the fp32 result is divided by the fp32 sum and
    returned in q's dtype. Returns (out (B, Nq, H, D), lse (B, H, Nq) fp32),
    lse = max + log(sum) of the scaled scores.
    """
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * _scale(q, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)  # (B, H, Nq)
    out = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float()) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m[..., 0] + torch.log(l)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    "Plain PyTorch attention with the kernel's numerics (:func:`flash_attention_lse_ref` without the logsumexp)."
    return flash_attention_lse_ref(q, k, v, scale)[0]


def flash_attention_bwd_ref(q, k, v, out, lse, dout, scale: Optional[float] = None):
    """Plain PyTorch backward from the saved logsumexp, with the Pallas kernels' numerics.

    delta = rowsum(dO * O) and p = exp(s * scale - lse) in fp32; dv = p^T dO
    with p rounded to dO's dtype; ds = p * (dO v^T - delta) * scale in fp32;
    dq = ds k and dk = ds^T q with ds rounded to k's and q's dtype. Returns
    contiguous (dq, dk, dv) in the dtypes of q, k and v.
    """
    scale = _scale(q, scale)
    f = lambda t: t.float()  # noqa: E731
    delta = (f(dout) * f(out)).sum(-1).transpose(1, 2)  # (B, H, Nq)
    s = torch.einsum("bnhd,bmhd->bhnm", f(q), f(k)) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", f(p.to(dout.dtype)), f(dout))
    dp = torch.einsum("bnhd,bmhd->bhnm", f(dout), f(v))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhnm,bmhd->bnhd", f(ds.to(k.dtype)), f(k))
    dk = torch.einsum("bhnm,bnhd->bmhd", f(ds.to(q.dtype)), f(q))
    return dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def tma_layout(t: torch.Tensor, rows: int):
    """The tensor map of a (B, N, H, D) view as the kernels' C entry points take it (csrc/hopper.cuh).

    Returns 11 ints: the dims innermost first (D, H, N, B), the byte strides
    of H, N and B, and the box (64, 1, rows, 1): one head's ``rows`` rows of
    64 elements (one 128-byte swizzle row). K1 loads a tile of D > 64 as two
    such boxes, at columns 0 and 64, and a box's columns past D arrive as
    zeros (D = 32 is one box, half of it zeros). A dimension of size 1 is
    never stepped, so it gets the stride it would have in a contiguous tensor
    (a tensor map needs a multiple of 16 bytes there, whatever the view says).
    The fp32 kernels take their element strides from the same ints.
    """
    return _tma_layout(t.shape, t.stride(), t.element_size(), rows)


def _tma_layout(shape, stride, es, rows):
    B, N, H, D = shape
    sb, sn, sh, _ = (s * es for s in stride)
    sh = sh if H > 1 else D * es
    sn = sn if N > 1 else H * sh
    sb = sb if B > 1 else N * sn
    return (D, H, N, B, sh, sn, sb, BOX_COLS, 1, rows, 1)


@functools.lru_cache(maxsize=256)
def _layout_array(*specs):
    "The C array of the tensor-map layouts of (shape, stride, element size, rows) specs."
    return (ctypes.c_longlong * (11 * len(specs)))(*(x for spec in specs for x in _tma_layout(*spec)))


def _layouts(*pairs):
    """The C array of the tensor-map layouts of (tensor, rows) pairs. It holds no pointer, so one array is
    built per layout and reused: the C side reads it during the call only."""
    return _layout_array(*((t.shape, t.stride(), t.element_size(), rows) for t, rows in pairs))


def head_dim_rule(op: str, kernel: str, head_dim: int):
    """Raise unless ``kernel`` ("K1", "K3", "K5", "K6" or "K8") takes ``head_dim``: any D up to
    :data:`MAX_HEAD_DIM` (K5: a multiple of 4, K8: 64 only). The error names :data:`HEAD_DIM_ITEM`."""
    top = MAX_HEAD_DIM[kernel]
    ok = 1 <= head_dim <= top and (kernel != "K5" or head_dim % 4 == 0) and (kernel != "K8" or head_dim == top)
    if not ok:
        rule = {"K5": f"a multiple of 4 up to {top}", "K8": f"{top}"}.get(kernel, f"1 to {top}")
        raise ValueError(f"{op}: head dim {head_dim} not supported ({kernel} takes {rule}; other head dims: "
                         f"{HEAD_DIM_ITEM})")


def pad_head_dim(*tensors):
    """The tensors with their head dim (the last) zero-padded to a multiple of :data:`HEAD_DIM_ALIGN`, as contiguous
    copies, or the tensors themselves when it is one already. Zero columns change no dot product, so attention over
    the padded q/k/v, with the caller's scale (that of the true D), gives the true output in its first D columns.
    ``pad_head_dim.copies`` counts the calls that copied."""
    d = tensors[0].shape[-1]
    dp = -(-d // HEAD_DIM_ALIGN) * HEAD_DIM_ALIGN
    if dp == d:
        return tensors
    pad_head_dim.copies += 1
    return tuple(torch.nn.functional.pad(t, (0, dp - d)) for t in tensors)


pad_head_dim.copies = 0


def _check(op, *tensors, kernel="K1"):
    """Raise on what the kernels do not take: q, k, v (and o, dO) of one device and dtype, a head dim of ``kernel``'s
    rule (:func:`head_dim_rule`) that is a multiple of 8 (the wrappers pad any other first), and what a TMA tensor
    map needs: a 16-byte aligned base and (b, n, h) byte strides that are multiples of 16 and below 2^40."""
    q = tensors[0]
    for i, t in enumerate(tensors):
        name = ("q", "k", "v", "o", "dO")[i]
        if t.dim() != 4:
            raise ValueError(f"{op}: {name} must be (B, N, H, D), got {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{op}: q/k/v must share device and dtype, {name} is {t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{op}: {name} needs a unit stride on the head dim")
        # TMA tiles (bf16) and 16-byte vector loads (fp32): aligned base and (b, n, h) strides
        strides = [s * t.element_size() for s in t.stride()[:3]]
        if t.data_ptr() % 16 or any(s % 16 for s in strides):
            raise ValueError(f"{op}: {name} needs a 16-byte aligned base and (b, n, h) strides")
        if max(strides) >= TMA_MAX_STRIDE:
            raise ValueError(f"{op}: {name} has a stride of 2^40 bytes or more (a tensor map's limit)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op}: dtype {q.dtype} not supported (float32, bfloat16)")
    k, v = tensors[1], tensors[2]
    B, _, H, D = q.shape
    head_dim_rule(op, kernel, D)
    if D % HEAD_DIM_ALIGN:
        raise ValueError(f"{op}: head dim {D} is not a multiple of {HEAD_DIM_ALIGN} (pad_head_dim pads it)")
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"{op}: k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if B > 65535 or H > 65535:
        raise ValueError(f"{op}: B and H must be at most 65535 (grid limits)")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"{op}: empty query or key set")


def _on_cuda(op, t):
    "True for a CUDA tensor, False for a CPU tensor; raises on any other device."
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {t.device}")
    return t.device.type == "cuda"


def flash_attention_fwd(q, k, v, scale: Optional[float] = None, with_lse: bool = False):
    """K1: the flash-attention forward kernel; a CPU tensor takes :func:`flash_attention_lse_ref`.

    CUDA tensors (float32 or bfloat16, D up to 512, unit stride on D, 16-byte
    aligned strides; a D that is not a multiple of 8 is padded into a copy)
    launch the kernel; anything else on a CUDA device raises. Returns (out,
    lse): a contiguous (B, Nq, H, D) tensor in q's dtype, and with ``with_lse``
    the (B, H, Nq) fp32 logsumexp, else None. The launch is the custom op
    ``uniception::flash_attention_fwd`` (``_lse`` with the logsumexp).
    ``flash_attention.launches`` counts the calls that launched the kernel (in
    bf16 above D = 128 with a split over the keys, the kernel and the splits'
    combine), ``flash_attention.lse_launches`` those that wrote the
    logsumexp, and ``flash_attention.shapes`` the calls by (dtype, B, Nq, Nk,
    H, D).
    """
    scale = _scale(q, scale)
    D = q.shape[-1]
    if _on_cuda("flash_attention", q):
        head_dim_rule("flash_attention", "K1", D)
        q, k, v = pad_head_dim(q, k, v)
    if with_lse:
        return flash_attention_fwd_lse_op(q, k, v, scale, D)
    return flash_attention_fwd_op(q, k, v, scale, D), None


def _fwd_impl(q, k, v, scale: float, head_dim: int, with_lse: bool):
    """The real implementation of K1's ops: the plain version on a CPU tensor, else the checked and counted launch,
    its output cut to the caller's ``head_dim``."""
    if not _on_cuda("flash_attention", q):
        out, lse = flash_attention_lse_ref(q, k, v, scale)
        return out.contiguous(), lse
    _check("flash_attention", q, k, v)
    out, lse = forward_launch(q, k, v, scale, with_lse)
    flash_attention.launches += 1
    flash_attention.lse_launches += with_lse
    flash_attention.head_dims[head_dim] += 1
    flash_attention.shapes[q.dtype, q.shape[0], q.shape[1], k.shape[1], q.shape[2], head_dim] += 1
    return (out if out.shape[-1] == head_dim else out[..., :head_dim].contiguous()), lse


@kernel_op("flash_attention_fwd")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           head_dim: int) -> torch.Tensor:
    "K1 without the logsumexp as one op, on q/k/v padded to the kernel's head dim; ``head_dim`` is the caller's."
    return _fwd_impl(q, k, v, scale, head_dim, False)[0]


@flash_attention_fwd_op.register_fake
def _(q, k, v, scale, head_dim):
    return q.new_empty((*q.shape[:3], head_dim))


@kernel_op("flash_attention_fwd_lse")
def flash_attention_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                               head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    "K1 with the (B, H, Nq) fp32 logsumexp as one op (:func:`flash_attention_fwd_op`'s arguments)."
    return _fwd_impl(q, k, v, scale, head_dim, True)


@flash_attention_fwd_lse_op.register_fake
def _(q, k, v, scale, head_dim):
    B, Nq, H, _ = q.shape
    return q.new_empty((B, Nq, H, head_dim)), q.new_empty((B, H, Nq), dtype=torch.float32)


def fwd_rows(head_dim: int) -> int:
    "The rows of K1's TMA boxes at a head dim: 128, or 64 for the column-split kernel above D = 128."
    return WIDE_ROWS if head_dim > WIDE_FROM else FWD_ROWS


def tf32_workspace_floats(B: int, H: int, Nq: int, Nk: int, D: int) -> int:
    """The floats of K1's fp32 workspace (csrc/flash_attention.cu tf32_split_kernel): q and k split into tf32 hi and
    lo, (2, B H, N, D) each, then v split and transposed, (2, B H, D, Nk8) with Nk8 = Nk rounded up to 8."""
    return 2 * B * H * (Nq * D + Nk * D + D * (-(-Nk // 8) * 8))


def k3_tf32_workspace_floats(B: int, H: int, Nq: int, Nk: int, D: int) -> int:
    """The floats of K3's fp32 workspace (csrc/flash_attention_bwd.cu k3_split_kernel): q, dO, k and v split into tf32
    hi and lo, (2, B H, N, D) each, then q, dO and k split and transposed, (2, B H, D, N8) with N8 = N rounded up to 8
    (the rows contiguous: the B operands of dk, dv and dq, whose products sum over the rows)."""
    nq8, nk8 = -(-Nq // 8) * 8, -(-Nk // 8) * 8
    return 2 * B * H * (2 * Nq * D + 2 * Nk * D + D * (2 * nq8 + nk8))


@functools.lru_cache(maxsize=4096)
def k1_wide_tiles_per_split(B: int, H: int, Nq: int, Nk: int, sms: int = H100_SMS) -> int:
    """The 64-key tiles of each key split of K1's wide kernel (bf16, D > 128; csrc/flash_attention.cu
    fa_fwd_bf16_wide_kernel), all of them (one split) unless its B H ceil(Nq / 64) units fill less than a wave of
    ``sms`` SMs. Then the count that gives the least cost: waves of units times the tiles a unit takes with its fixed
    costs (WIDE_UNIT_COST_TILES, and WIDE_SPLIT_COST_TILES with more than one split), the fewest splits on a tie. Every
    split holds at least one tile, so every key lands in exactly one split."""
    n_tiles, units = -(-Nk // WIDE_ROWS), B * H * -(-Nq // WIDE_ROWS)
    if units >= sms:
        return n_tiles
    best = None
    for tps in range(n_tiles, 0, -1):
        splits = -(-n_tiles // tps)
        cost = -(-units * splits // sms) * (tps + WIDE_UNIT_COST_TILES + (splits > 1) * WIDE_SPLIT_COST_TILES)
        if best is None or cost < best[0]:
            best = (cost, tps)
    return best[1]


def k1_wide_workspace_floats(B: int, H: int, Nq: int, Nk: int, D: int, tps: int) -> int:
    """The floats of K1's wide-kernel workspace with ``tps`` tiles a key split (0 for one split): each split's fp32 O,
    unnormalised, (splits, B, H, Nq, D), then its row max (log2 units) and row sum, (splits, B, H, Nq) each."""
    splits = -(-(-(-Nk // WIDE_ROWS)) // tps)
    return 0 if splits == 1 else splits * B * H * Nq * (D + 2)


def forward_launch(q, k, v, scale: float, with_lse: bool = False):
    """K1's launch on CUDA q/k/v that :func:`flash_attention_fwd` would take, unchecked and uncounted: the
    wrapper that calls it (K1's own, or K5's attention launch, ops/fused_attention.py) counts its launches.
    Returns (out, lse) as :func:`flash_attention_fwd` does."""
    B, Nq, H, D = q.shape
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device) if with_lse else None
    Nk = k.shape[1]
    ws, tps, floats = None, 0, 0
    if q.dtype == torch.float32 and D > F32_SMALL_HEAD_DIM:  # the split operands of the 3xTF32 kernel's pre-pass
        floats = tf32_workspace_floats(B, H, Nq, Nk, D)
    elif q.dtype == torch.bfloat16 and D > WIDE_FROM:  # the wide kernel's key splits
        tps = k1_wide_tiles_per_split(B, H, Nq, Nk, sm_count(q.device.index or 0))
        floats = k1_wide_workspace_floats(B, H, Nq, Nk, D, tps)
    if floats:
        ws = torch.empty(floats, dtype=torch.float32, device=q.device)
    status = kernel_lib.library().uc_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        None if ws is None else ws.data_ptr(), _DTYPE_CODES[q.dtype], B, H, Nq, Nk, D, tps,
        _layouts(*((t, fwd_rows(D)) for t in (q, k, v))),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_lib.check(status, "flash_attention_fwd")
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, scale: Optional[float] = None):
    """K3: the flash-attention backward kernels; a CPU tensor takes :func:`flash_attention_bwd_ref`.

    q/k/v as for :func:`flash_attention_fwd` (read by stride), ``out`` and
    ``lse`` the forward's outputs, ``dout`` the output gradient (made
    contiguous when its layout does not fit the kernel). Returns contiguous
    (dq, dk, dv) in the input dtype. Anything the kernel does not take on a
    CUDA device raises, a head dim above 256 among it; a D that is not a
    multiple of 8 is padded into a copy. ``flash_attention_bwd.launches``
    counts the calls (each launches the delta, dq and dk/dv kernels, and in
    fp32 above D = 16 first the split pre-pass of the 3xTF32 kernels, into a
    workspace of :func:`k3_tf32_workspace_floats`).
    """
    scale = _scale(q, scale)
    if not _on_cuda("flash_attention_bwd", q):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, scale)
    d = q.shape[-1]  # the caller's head dim; D below is the kernel's, rounded up to 8
    head_dim_rule("flash_attention_bwd", "K3", d)
    q, k, v, out, dout = pad_head_dim(q, k, v, out, dout)
    if dout.stride(-1) != 1 or dout.data_ptr() % 16 or any(s * dout.element_size() % 16 for s in dout.stride()[:3]):
        dout = dout.contiguous()
    _check("flash_attention_bwd", q, k, v, out, dout, kernel="K3")
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if out.shape != q.shape or not out.is_contiguous() or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o must be contiguous and o, dO shaped like q {tuple(q.shape)}")
    if lse.shape != (B, H, Nq) or lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous float32 ({B}, {H}, {Nq}) tensor on {q.device}")
    delta = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Nk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Nk, H, D), dtype=q.dtype, device=q.device)
    ws = None
    if q.dtype == torch.float32 and D > F32_SMALL_HEAD_DIM:  # the split operands of the 3xTF32 kernels' pre-pass
        ws = torch.empty(k3_tf32_workspace_floats(B, H, Nq, Nk, D), dtype=torch.float32, device=q.device)
    status = kernel_lib.library().uc_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if ws is None else ws.data_ptr(), _DTYPE_CODES[q.dtype], B,
        H, Nq, Nk, D,
        _layouts((q, BWD_OWN_ROWS), (k, BWD_LOOP_ROWS), (v, BWD_LOOP_ROWS), (dout, BWD_OWN_ROWS),  # dq kernel
                 (k, BWD_OWN_ROWS), (v, BWD_OWN_ROWS), (q, BWD_LOOP_ROWS), (dout, BWD_LOOP_ROWS)),  # dk/dv kernel
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_lib.check(status, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.head_dims[d] += 1
    return (dq, dk, dv) if d == D else tuple(g[..., :d].contiguous() for g in (dq, dk, dv))


flash_attention_bwd.launches = 0
flash_attention_bwd.head_dims = collections.Counter()  # launches by the caller's head dim


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the kernels in both directions: the forward writes the
    logsumexp (K1) and saves (q, k, v, out, lse); the backward is K3. CPU
    tensors take the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over (B, N, H, D) tensors (non-causal, no mask).

    When a gradient is needed (grad mode on and q, k or v requires it) this
    is :class:`FlashAttentionFunction`; otherwise the forward alone, without
    the logsumexp. CUDA tensors launch the kernels (or raise), CPU tensors
    take the plain versions. Returns a (B, Nq, H, D) tensor in q's dtype.
    """
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]


flash_attention.launches = 0
flash_attention.lse_launches = 0
flash_attention.head_dims = collections.Counter()  # launches by the caller's head dim
flash_attention.shapes = collections.Counter()  # launches by (dtype, B, Nq, Nk, H, D), the caller's head dim


def _int8_args(op, k, mode):
    if mode not in INT8_MODES:
        raise ValueError(f"{op}: mode {mode!r} must be one of {INT8_MODES}")
    if k.shape[1] > INT8_MAX_KEYS:
        raise ValueError(f"{op}: {k.shape[1]} keys; the int8 kernel takes one block of at most {INT8_MAX_KEYS}")


def int8_pv_keys(n: int = INT8_CHUNK, device=None) -> torch.Tensor:
    """The key at each position of the transposed v8 scratch ("int8pv"), for ``n`` keys (a multiple of 32).

    Within each 32 keys, position 4t + e of each 16-half holds key 2t + (e & 1) + 8 (e >> 1) of that half: the
    order in which K6's score accumulators hold p, so p8 feeds the int8 P.V product from registers
    (csrc/flash_attention_int8.cu). The product sums over keys, so the order changes nothing else."""
    p = torch.arange(n, device=device)
    return (p & ~15) + ((p & 2) << 2) + ((p & 12) >> 1) + (p & 1)


def flash_attention_int8_prep_ref(k: torch.Tensor, v: torch.Tensor, mode: str = "int8"):
    """Plain PyTorch version of K6's prep: the int8 keys (and values) with their scales, in the kernel's layout.

    k, v: (B, Nk, H, D). The k mean over the Nk keys is summed in the kernel's fixed order (within each chunk
    of 128 keys, each group of 4 keys in key order, then the 32 groups in order; then the chunks in order) and
    divided by Nk; ks = max(max |k - mean|, 1e-30) / 127 per
    (b, h); k8 = round((k - mean) / ks). Returns (k8, kscale, v8t, vscale): k8 (B, H, Nk_pad, D) int8 with
    Nk_pad = Nk rounded up to 128, kscale (B, H) float32, and for "int8pv" v8 = round(v / vs) with vs per
    (b, h), TRANSPOSED to (B, H, D, Nk_pad) int8 with each 32 keys in :func:`int8_pv_keys` order, and vscale
    (B, H); None for both in "int8" mode. Zeros past Nk. Every value is the kernel's bit for bit.
    """
    _int8_args("flash_attention_int8_prep_ref", k, mode)
    B, Nk, H, D = k.shape
    chunks = -(-Nk // INT8_CHUNK)
    nk_pad = chunks * INT8_CHUNK
    kf = torch.zeros(B, nk_pad, H, D, dtype=torch.float32, device=k.device)
    kf[:, :Nk] = k.float()
    kc = kf.view(B, chunks, INT8_CHUNK // INT8_PREP_KEYS, INT8_PREP_KEYS, H, D)
    group = torch.zeros(B, chunks, INT8_CHUNK // INT8_PREP_KEYS, H, D, dtype=torch.float32, device=k.device)
    for i in range(INT8_PREP_KEYS):  # each group in key order (the padding adds zeros, which change no sum)
        group = group + kc[:, :, :, i]
    part = torch.zeros(B, chunks, H, D, dtype=torch.float32, device=k.device)
    for g in range(INT8_CHUNK // INT8_PREP_KEYS):  # then the groups in order
        part = part + group[:, :, g]
    tot = torch.zeros(B, H, D, dtype=torch.float32, device=k.device)
    for c in range(chunks):  # then the chunks in order
        tot = tot + part[:, c]
    mean = tot / torch.full_like(tot, float(Nk))  # (B, H, D)
    centred = k.float() - mean[:, None]
    ks = absmax_scale(centred.abs().amax(dim=(1, 3)))  # (B, H)
    k8 = torch.zeros(B, H, nk_pad, D, dtype=torch.int8, device=k.device)
    k8[:, :, :Nk] = torch.round(centred / ks[:, None, :, None]).clamp(-127, 127).to(torch.int8).transpose(1, 2)
    if mode != "int8pv":
        return k8, ks, None, None
    vf = v.float()
    vs = absmax_scale(vf.abs().amax(dim=(1, 3)))  # (B, H)
    v8 = torch.zeros(B, H, D, nk_pad, dtype=torch.int8, device=k.device)
    v8[..., :Nk] = torch.round(vf / vs[:, None, :, None]).clamp(-127, 127).to(torch.int8).permute(0, 2, 3, 1)
    return k8, ks, v8[..., int8_pv_keys(nk_pad, k.device)], vs


def flash_attention_int8_ref(q, k, v, scale: Optional[float] = None, mode: str = "int8") -> torch.Tensor:
    """Plain PyTorch int8 attention with the Pallas int8 kernel's numerics, on the scratch of
    :func:`flash_attention_int8_prep_ref`.

    k is smoothed by its mean over the keys and quantized with one scale per
    (b, h); q per row; s = float(q8 k8^T) * (qs * (ks * scale)), softmax with
    the row max over all keys. "int8": P.V in fp32 with p rounded to v's
    dtype; "int8pv": p8 = round(p * 127) and v quantized per (b, h), P.V in
    int32 times vs / 127. Both products are exact in fp32 (their integer sums
    stay below 2^24 for D up to 256 and at most 1024 keys). Returns (B, Nq, H, D)
    in q's dtype.
    """
    _int8_args("flash_attention_int8_ref", k, mode)
    scale = _scale(q, scale)
    Nk = k.shape[1]
    k8, ks, v8t, vs = flash_attention_int8_prep_ref(k, v, mode)
    qf = q.float()
    qs = absmax_scale(qf.abs().amax(dim=-1, keepdim=True))  # (B, Nq, H, 1)
    q8 = torch.round(qf / qs)
    s = torch.einsum("bnhd,bhmd->bhnm", q8, k8[:, :, :Nk].float())
    s = s * (qs * (ks[:, None, :, None] * scale)).permute(0, 2, 1, 3)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)  # (B, H, Nq)
    if mode == "int8pv":
        v8 = torch.empty_like(v8t)
        v8[..., int8_pv_keys(v8t.shape[-1], v8t.device)] = v8t
        pv = torch.einsum("bhnm,bhdm->bnhd", torch.round(p * 127.0), v8[..., :Nk].float())
        vs = vs[:, None, :, None]
        pv = pv * (vs / torch.full_like(vs, 127.0))  # a true division, as the kernel's
    else:
        pv = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float())
    return (pv / l.transpose(1, 2)[..., None]).to(q.dtype)


def int8_row_bytes(head_dim: int) -> int:
    "The int8 row of K6's scratch (csrc/flash_attention_int8.cu row_bytes): D rounded up to 64, 128 or 256."
    return 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256


def _int8_scratch(k, mode):
    "Empty K6 scratch for k's shape: (k8, kscale, v8t, vscale, stats), rows of int8_row_bytes(D)."
    B, Nk, H, D = k.shape
    chunks = -(-Nk // INT8_CHUNK)
    dk = int8_row_bytes(D)
    dev = k.device
    k8 = torch.empty((B, H, chunks * INT8_CHUNK, dk), dtype=torch.int8, device=dev)
    kscale = torch.empty((B, H), dtype=torch.float32, device=dev)
    pv8 = mode == "int8pv"
    v8t = torch.empty((B, H, dk, chunks * INT8_CHUNK), dtype=torch.int8, device=dev) if pv8 else None
    vscale = torch.empty_like(kscale) if pv8 else None
    stats = torch.empty((4, B, H, chunks, dk), dtype=torch.float32, device=dev)
    return k8, kscale, v8t, vscale, stats


def _ptr(t):
    return None if t is None else t.data_ptr()


def _int8_cuda_args(op, q, k, v, mode):
    _int8_args(op, k, mode)
    _check(op, q, k, v, kernel="K6")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{op}: dtype {q.dtype} not supported (bfloat16)")


def flash_attention_int8_prep(k: torch.Tensor, v: torch.Tensor, mode: str = "int8"):
    """K6's prep launches alone (the first two of every K6 call): (k8, kscale, v8t, vscale) as
    :func:`flash_attention_int8_prep_ref` returns them. A CPU tensor takes that plain version; CUDA tensors
    (bfloat16, D up to 256, read by stride; a D that is not a multiple of 8 is padded into a copy) launch the prep
    or raise; the scratch's columns (rows of v8t) past D are sliced off. The launch is the custom op
    ``uniception::flash_attention_int8_prep``. ``flash_attention_int8_prep.launches`` counts these calls (not those
    inside :func:`flash_attention_int8`)."""
    _int8_args("flash_attention_int8_prep", k, mode)
    D = k.shape[-1]
    if _on_cuda("flash_attention_int8_prep", k):
        head_dim_rule("flash_attention_int8_prep", "K6", D)
        k, v = pad_head_dim(k, v)
    k8, kscale, v8t, vscale = flash_attention_int8_prep_op(k, v, mode, D)
    return (k8, kscale, v8t, vscale) if mode == "int8pv" else (k8, kscale, None, None)


@kernel_op("flash_attention_int8_prep")
def flash_attention_int8_prep_op(k: torch.Tensor, v: torch.Tensor, mode: str,
                                 head_dim: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's prep as one op, on k/v padded to the kernel's head dim; ``head_dim`` is the caller's. In "int8" mode
    v8t and vscale are empty."""
    if not _on_cuda("flash_attention_int8_prep", k):
        k8, kscale, v8t, vscale = flash_attention_int8_prep_ref(k, v, mode)
        if v8t is None:
            v8t, vscale = k8.new_empty(0), kscale.new_empty(0)
        return k8, kscale, v8t, vscale
    _int8_cuda_args("flash_attention_int8_prep", k, k, v, mode)
    k8, kscale, v8t, vscale, stats = _int8_scratch(k, mode)
    status = kernel_lib.library().uc_flash_attention_int8_prep(
        k.data_ptr(), v.data_ptr(), k8.data_ptr(), _ptr(v8t), stats.data_ptr(), kscale.data_ptr(), _ptr(vscale),
        int(mode == "int8pv"), k.shape[0], k.shape[2], k.shape[1], k.shape[3],
        _layouts((k, INT8_CHUNK), (v, INT8_CHUNK)), torch.cuda.current_stream(k.device).cuda_stream,
    )
    kernel_lib.check(status, "flash_attention_int8_prep")
    flash_attention_int8_prep.launches += 1
    if v8t is None:
        return k8[..., :head_dim], kscale, k8.new_empty(0), kscale.new_empty(0)
    return k8[..., :head_dim], kscale, v8t[:, :, :head_dim], vscale


@flash_attention_int8_prep_op.register_fake
def _(k, v, mode, head_dim):
    B, Nk, H, D = k.shape
    nk_pad = -(-Nk // INT8_CHUNK) * INT8_CHUNK
    cols = int8_row_bytes(D) if k.device.type == "cuda" else head_dim  # the kernel's scratch rows, sliced
    k8 = k.new_empty((B, H, nk_pad, cols), dtype=torch.int8)[..., :head_dim]
    kscale = k.new_empty((B, H), dtype=torch.float32)
    if mode != "int8pv":
        return k8, kscale, k.new_empty(0, dtype=torch.int8), k.new_empty(0, dtype=torch.float32)
    v8t = k.new_empty((B, H, cols, nk_pad), dtype=torch.int8)[:, :, :head_dim]
    return k8, kscale, v8t, k.new_empty((B, H), dtype=torch.float32)


flash_attention_int8_prep.launches = 0


def flash_attention_int8(q, k, v, scale: Optional[float] = None, mode: str = "int8") -> torch.Tensor:
    """K6: the int8 attention kernel (inference; one key block of at most 1024 keys).

    CUDA tensors (bfloat16, D up to 256, read by stride as for K1; a D that
    is not a multiple of 8 is padded into a copy) launch the kernel: the prep
    (the k mean, the scales and the int8 keys, and values in "int8pv", over
    (b, h, key chunk) blocks), then the attention; anything else on a CUDA
    device raises. A CPU tensor takes :func:`flash_attention_int8_ref`.
    Returns a contiguous (B, Nq, H, D) tensor. The launch is the custom op
    ``uniception::flash_attention_int8``. ``flash_attention_int8.launches``
    counts the calls that launched it.
    """
    _int8_args("flash_attention_int8", k, mode)
    scale = _scale(q, scale)
    d = q.shape[-1]  # the caller's head dim; the kernel's is rounded up to 8
    if _on_cuda("flash_attention_int8", q):
        head_dim_rule("flash_attention_int8", "K6", d)
        q, k, v = pad_head_dim(q, k, v)
    return flash_attention_int8_op(q, k, v, scale, mode, d)


@kernel_op("flash_attention_int8")
def flash_attention_int8_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mode: str,
                            head_dim: int) -> torch.Tensor:
    "K6 as one op (prep and attention), on q/k/v padded to the kernel's head dim; ``head_dim`` is the caller's."
    if not _on_cuda("flash_attention_int8", q):
        return flash_attention_int8_ref(q, k, v, scale, mode).contiguous()
    _int8_cuda_args("flash_attention_int8", q, k, v, mode)
    B, Nq, H, D = q.shape
    k8, kscale, v8t, vscale, stats = _int8_scratch(k, mode)
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    status = kernel_lib.library().uc_flash_attention_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), k8.data_ptr(), _ptr(v8t), stats.data_ptr(),
        kscale.data_ptr(), _ptr(vscale), int(mode == "int8pv"), B, H, Nq, k.shape[1], D,
        _layouts((q, INT8_CHUNK), (k, INT8_CHUNK), (v, INT8_CHUNK)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_lib.check(status, "flash_attention_int8")
    flash_attention_int8.launches += 1
    flash_attention_int8.head_dims[head_dim] += 1
    return out if head_dim == D else out[..., :head_dim].contiguous()


@flash_attention_int8_op.register_fake
def _(q, k, v, scale, mode, head_dim):
    return q.new_empty((*q.shape[:3], head_dim))


flash_attention_int8.launches = 0
flash_attention_int8.head_dims = collections.Counter()  # launches by the caller's head dim
