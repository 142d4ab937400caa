"""
GPTQ: Hessian-aware error-compensated weight rounding for the int8 path
(counterpart of uniception_tpu/nn/gptq.py).

Round-to-nearest (``Int8Linear.from_linear``) rounds each weight on its own.
GPTQ (Frantar et al., 2023) quantizes input channels one at a time and folds
each channel's rounding error into the channels not yet quantized through the
inverse Hessian H^-1 (H = E[x x^T] over calibration inputs). The codes land on
the same symmetric per-output-channel grid, so serving runs the same kernels
(K4) at the same cost; only the integer codes change.

This is an offline transform (``python -m uniception_tpu_torch.calibrate_gptq``):
    1. :func:`install_hessian_capture` wraps the target linears in place with an
       accumulator (H and the token count in fp32, TF32 off, and the
       per-input-channel |x| maximum);
    2. forwards over calibration pairs; :func:`harvest_act_amax` and
       :func:`harvest_hessians` collect the statistics (float64, on the
       capture's device) and unwrap the linears;
    3. :func:`gptq_int8` re-rounds each weight (torch on the weight's device);
    4. :func:`apply_gptq` overwrites the codes of an int8-quantized model.

Layouts are the JAX package's, so its files cross unchanged: keys are the loop
layout's dotted paths (``encoder.enc_blocks.3.attn.qkv``), codes are (in, out)
int8 and scales (1, out) fp32. ``Int8Linear`` keeps its codes as (out, in);
:func:`apply_gptq` transposes on the way in. The port has only the loop
layout, so a stacked (scan) weight never occurs; a weight that is not 2-D
raises as the JAX capture does for one.
"""

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from uniception_tpu_torch.models.utils.config import get_attention_impl
from uniception_tpu_torch.nn.quant import Int8Linear

__all__ = [
    "HessianState",
    "install_hessian_capture",
    "harvest_hessians",
    "harvest_act_amax",
    "gptq_int8",
    "apply_gptq",
    "load_gptq_npz",
]


def load_gptq_npz(path: str) -> Dict[str, tuple]:
    """Load the ``{path: (w_q, w_scale)}`` dict that the calibration saves
    (npz keys ``<path>.w_q`` (in, out) int8 and ``<path>.w_scale`` (1, out))."""
    data = np.load(path)
    out: Dict[str, tuple] = {}
    for k in data.files:
        if k.endswith(".w_q"):
            p = k[: -len(".w_q")]
            out[p] = (data[k], data[p + ".w_scale"])
    return out


@contextlib.contextmanager
def _full_fp32():
    "fp32 matmuls with TF32 off (a TF32 Hessian is not the JAX package's fp32 one)."
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class HessianState:
    """Calibration accumulator of one linear's inputs (not a parameter: never
    trained or checkpointed): ``h`` = sum x x^T (d, d), ``n`` the token count,
    ``amax`` the per-input-channel |x| maximum (d,), all fp32 on ``device``.
    ``amax`` is the statistic SmoothQuant's scale migration needs (nn/smooth.py)."""

    def __init__(self, d: int, device=None):
        self.h = torch.zeros((d, d), dtype=torch.float32, device=device)
        self.n = torch.zeros((), dtype=torch.float32, device=device)
        self.amax = torch.zeros((d,), dtype=torch.float32, device=device)

    @torch.no_grad()
    def update(self, x: torch.Tensor) -> None:
        xf = x.reshape(-1, x.shape[-1]).float()
        with _full_fp32():
            self.h.addmm_(xf.t(), xf)
        self.n += float(xf.shape[0])
        torch.maximum(self.amax, xf.abs().amax(dim=0), out=self.amax)


class _HessianCapture(nn.Module):
    "Transparent wrapper accumulating the wrapped linear's input statistics."

    def __init__(self, inner: nn.Linear):
        super().__init__()
        self.inner = inner
        self.state = HessianState(int(inner.weight.shape[-1]), device=inner.weight.device)

    def forward(self, x):
        self.state.update(x)
        return self.inner(x)


def install_hessian_capture(
    module: nn.Module,
    *,
    min_params: int = 1 << 16,
    predicate: Optional[Callable[[str, nn.Linear], bool]] = None,
    _path: str = "",
) -> int:
    """Wrap every target linear under ``module`` (in place) with a Hessian
    accumulator; the same selection as ``quantize_linears``. Returns the number
    of layers wrapped. Run the forwards under ``torch.no_grad()`` afterwards.

    Raises under the "fused" attention implementation: K5 reads ``qkv.weight``
    (and the cross projections' weights) itself, so a wrapper would either see
    no input or take those layers out of the fused contract. Calibrate under
    "kernel" (CUDA) or "naive".
    """
    if get_attention_impl() == "fused":
        raise ValueError(
            "install_hessian_capture: the 'fused' attention implementation projects qkv inside its kernel (K5), "
            "so a capture wrapper would see no input there or take the layer off K5; calibrate under 'kernel' or "
            "'naive' (models/utils/config.py set_attention_impl)"
        )
    count = 0
    for name, child in list(module.named_children()):
        child_path = f"{_path}.{name}".lstrip(".")
        if isinstance(child, nn.Linear):
            w = child.weight
            if w.numel() >= min_params and (predicate is None or predicate(child_path, child)):
                if w.dim() != 2:
                    raise ValueError(
                        f"install_hessian_capture: {child_path} has a stacked {tuple(w.shape)} kernel — calibrate on "
                        "the LOOP layout (scan_blocks=False) for per-depth Hessians; apply_gptq then maps the loop "
                        "keys onto stacked models at load"
                    )
                setattr(module, name, _HessianCapture(child))
                count += 1
        elif not isinstance(child, (Int8Linear, _HessianCapture)):
            count += install_hessian_capture(child, min_params=min_params, predicate=predicate, _path=child_path)
    return count


def harvest_act_amax(module: nn.Module, *, _path: str = "") -> Dict[str, torch.Tensor]:
    """Collect ``{dotted_path: per-input-channel |x| max}`` (float64) from the
    installed capture wrappers without unwrapping them (call before
    :func:`harvest_hessians`). Feed to ``nn/smooth.py``'s scale migration."""
    out: Dict[str, torch.Tensor] = {}
    for name, child in module.named_children():
        child_path = f"{_path}.{name}".lstrip(".")
        if isinstance(child, _HessianCapture):
            out[child_path] = child.state.amax.double()
        elif not isinstance(child, Int8Linear):
            out.update(harvest_act_amax(child, _path=child_path))
    return out


def harvest_hessians(module: nn.Module, *, unwrap: bool = True, _path: str = "") -> Dict[str, torch.Tensor]:
    """Collect ``{dotted_path: H}`` from every installed capture wrapper (H in
    float64, normalized by the token count) and, with ``unwrap=True``, put the
    original linears back in place."""
    out: Dict[str, torch.Tensor] = {}
    for name, child in list(module.named_children()):
        child_path = f"{_path}.{name}".lstrip(".")
        if isinstance(child, _HessianCapture):
            h = child.state.h.double()
            out[child_path] = h / torch.tensor(max(float(child.state.n), 1.0), dtype=h.dtype, device=h.device)
            if unwrap:
                setattr(module, name, child.inner)
        elif not isinstance(child, Int8Linear):
            out.update(harvest_hessians(child, unwrap=unwrap, _path=child_path))
    return out


@torch.no_grad()
def gptq_int8(
    w,
    H,
    *,
    blocksize: int = 128,
    percdamp: float = 0.01,
    dtype: torch.dtype = torch.float64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GPTQ re-rounding of one weight ``w`` (in, out) — a torch linear's
    ``weight.t()`` — against Hessian ``H`` (in, in). Returns ``(w_q int8 (in,
    out), w_scale fp32 (1, out))`` on the symmetric per-output-channel grid of
    ``quantize_int8``: drop-in codes for ``Int8Linear``.

    Torch on ``w``'s device (numpy inputs are taken as CPU tensors), in
    ``dtype`` (float32 halves the factorization's cost; the damping keeps it
    stable). Input channels are taken in order, in blocks of ``blocksize``
    with the lazy trailing update: the published schedule. Dead channels
    (H_jj <= 0) are zeroed, the diagonal is damped by ``percdamp`` times its
    mean, and U = chol(H^-1)^T carries each channel's compensation
    coefficients. With H = I the compensation vanishes and the result is RTN.
    """
    w = torch.as_tensor(w)
    device = w.device
    w = w.to(dtype).clone()
    d_in = w.shape[0]
    H = torch.as_tensor(H).to(device=device, dtype=dtype).clone()
    if tuple(H.shape) != (d_in, d_in):
        raise ValueError(f"gptq_int8: H {tuple(H.shape)} does not fit w {tuple(w.shape)}")
    amax = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-30)
    scale = amax / torch.full_like(amax, 127.0)  # (1, out); a tensor divisor: a true division on CUDA too

    diag = torch.arange(d_in, device=device)
    dead = H[diag, diag] <= 0
    H[diag[dead], diag[dead]] = 1.0
    w[dead, :] = 0.0
    H[diag, diag] += percdamp * H[diag, diag].mean()

    # U = upper factor with H^-1 = U^T U: row U[j, k > j] carries channel j's compensation coefficients
    Linv = torch.linalg.inv(torch.linalg.cholesky(H))
    Hinv = Linv.t() @ Linv
    U = torch.linalg.cholesky(Hinv).t().contiguous()

    q_codes = torch.empty_like(w)
    s = scale[0]
    for i0 in range(0, d_in, blocksize):
        i1 = min(i0 + blocksize, d_in)
        Wb = w[i0:i1]
        Eb = torch.empty_like(Wb)
        Ub = U[i0:i1, i0:i1]
        # the rows' views taken up front and every result written in place: the column loop, sequential by
        # construction, then issues one kernel per step (it is bound by launches on a GPU)
        rows = zip(Wb.unbind(0), q_codes[i0:i1].unbind(0), Eb.unbind(0), Ub.unbind(0))
        for j, (wj, qj, ej, uj) in enumerate(rows):
            torch.div(wj, s, out=qj).round_().clamp_(-127, 127)
            torch.sub(wj, qj * s, out=ej).div_(uj[j])
            if j + 1 < i1 - i0:
                Wb[j + 1 :].sub_(torch.outer(uj[j + 1 :], ej))
        if i1 < d_in:
            w[i1:] -= U[i0:i1, i1:].t() @ Eb

    return q_codes.to(torch.int8), scale.to(torch.float32)


@torch.no_grad()
def apply_gptq(module: nn.Module, weights: Dict[str, tuple], *, _path: str = "") -> int:
    """Overwrite the codes and scales of already-quantized ``Int8Linear``
    layers with GPTQ codes. ``weights`` maps loop-layout dotted paths to
    ``(w_q (in, out), w_scale (1, out))`` (numpy or torch: what the
    calibration saves); layers with no entry keep their RTN codes, and a
    zero-point layer's ``w_colsum`` is recomputed. Returns the number of
    layers rewritten."""
    count = 0
    for name, child in module.named_children():
        child_path = f"{_path}.{name}".lstrip(".")
        if isinstance(child, Int8Linear):
            if child_path not in weights:
                continue
            w_q, w_s = (torch.as_tensor(a) for a in weights[child_path])
            want = (child.in_features, child.out_features)
            if tuple(w_q.shape) != want:
                raise ValueError(f"apply_gptq: {child_path} codes {tuple(w_q.shape)}, the layer takes (in, out) {want}")
            child.w_q.copy_(w_q.t())  # kept as (out, in)
            child.w_scale.copy_(w_s.float().reshape(1, child.out_features))
            if child.w_colsum is not None:  # zero-point mode precomputes colsum(W_q * s): refresh it
                child.w_colsum.copy_(child.w_q.to(torch.int32).sum(dim=-1).float().reshape(1, -1) * child.w_scale)
            count += 1
        else:
            count += apply_gptq(child, weights, _path=child_path)
    return count
