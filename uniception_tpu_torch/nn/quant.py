"""
Int8 serving path: w8a8 dynamic-quantized linear layers (counterpart of
uniception_tpu/nn/quant.py).

    * weights:     symmetric per-output-channel int8, scale_j = max_i |W[i, j]| / 127
    * activations: symmetric per-token int8 computed on the fly (the default),
                   per-token zero-point ("asym": x = m + (x - m), m the row's
                   mid-range, with the exact rank-1 correction m * colsum(W_q * s)),
                   or one static per-tensor scale from an offline calibration
    * y = (x_q @ W_q) * (scale_t * scale_j) [+ m * colsum] + b, int32 accumulation

Routing: the symmetric dynamic mode is the int8 matmul kernel's contract (K4,
ops/int8_matmul.py) at every K on a CUDA device; the "naive" implementation
takes its plain version. The zero-point and static modes quantize eagerly and
take ``torch._int_mm`` (the product the JAX package leaves to XLA).

State keys are the JAX module's: ``w_q`` (in, out) int8, ``w_scale`` (1, out),
``bias``, ``a_scale``, ``w_colsum``; the layer keeps w_q as (out, in), the
kernel's layout, and its state-dict hooks export and load the (in, out) view.
"""

from typing import Callable, Optional

import torch
from torch import nn

from uniception_tpu_torch.models.utils.config import get_attention_impl
from uniception_tpu_torch.ops.int8_matmul import absmax_scale, int8_matmul_dynamic, int8_matmul_dynamic_ref

__all__ = ["Int8Linear", "quantize_linears", "quantize_int8", "quantize_trunk", "trunk_policy"]


def quantize_int8(w: torch.Tensor, axis: int = 0):
    """Symmetric int8 quantization of ``w`` per channel along ``axis``.

    Returns (w_q int8, scale fp32) with ``w ~= w_q * scale`` (scale broadcast
    along ``axis``).
    """
    wf = w.float()
    scale = absmax_scale(wf.abs().amax(dim=axis, keepdim=True))
    return torch.round(wf / scale).clamp(-127, 127).to(torch.int8), scale


def _int_mm(x_q: torch.Tensor, w_kn: torch.Tensor) -> torch.Tensor:
    "torch._int_mm, with the rows padded to the 17 that the CUDA version needs at least."
    m = x_q.shape[0]
    if x_q.is_cuda and m <= 16:
        x_q = torch.cat([x_q, x_q.new_zeros(17 - m, x_q.shape[1])])
    return torch._int_mm(x_q, w_kn)[:m]


class Int8Linear(nn.Module):
    """Inference replacement for a linear layer with int8 weights and int8
    activations (int32 accumulation). Build it with :meth:`from_linear`; it
    is not trained. The output takes the input's dtype."""

    def __init__(
        self,
        w_q: torch.Tensor,
        w_scale: torch.Tensor,
        bias: Optional[torch.Tensor],
        a_scale: Optional[torch.Tensor] = None,
        w_colsum: Optional[torch.Tensor] = None,
    ):
        "w_q (in, out) int8 and w_scale (1, out) as in the JAX package; the (out, in) copy is what is kept."
        super().__init__()
        self.in_features, self.out_features = int(w_q.shape[0]), int(w_q.shape[1])
        self.register_buffer("w_q", w_q.t().contiguous())  # (out, in)
        self.register_buffer("w_scale", w_scale.float().reshape(1, self.out_features))
        self.register_buffer("bias", None if bias is None else bias.float())
        # static per-tensor activation scale (w8a8-static); None = dynamic per token
        self.register_buffer("a_scale", None if a_scale is None else torch.as_tensor(a_scale, dtype=torch.float32))
        # zero-point activation mode: the (1, out) dequantized column sums; None = symmetric
        self.register_buffer("w_colsum", None if w_colsum is None else w_colsum.float())
        self._register_state_dict_hook(Int8Linear._export_w_q)
        self._register_load_state_dict_pre_hook(Int8Linear._import_w_q, with_module=True)

    @staticmethod
    def _export_w_q(module, state_dict, prefix, local_metadata):
        state_dict[prefix + "w_q"] = state_dict[prefix + "w_q"].t()  # (in, out), a view of the kept tensor

    @staticmethod
    def _import_w_q(module, state_dict, prefix, *args):
        key = prefix + "w_q"
        if key in state_dict:
            state_dict[key] = state_dict[key].t()

    @classmethod
    def from_linear(cls, lin: nn.Linear, asym: Optional[bool] = None) -> "Int8Linear":
        "Quantize ``lin`` (weight (out, in)) per output channel; ``asym`` selects the zero-point activation mode."
        w_q, scale = quantize_int8(lin.weight.detach(), axis=-1)  # (out, in), (out, 1)
        w_scale = scale.reshape(1, -1)
        bias = None if lin.bias is None else lin.bias.detach().float()
        w_colsum = None
        if asym:
            w_colsum = w_q.to(torch.int32).sum(dim=-1).float().reshape(1, -1) * w_scale
        return cls(w_q.t(), w_scale, bias, w_colsum=w_colsum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.a_scale is None and self.w_colsum is None:
            fn = int8_matmul_dynamic_ref if get_attention_impl() == "naive" else int8_matmul_dynamic
            return fn(x, self.w_q.t(), self.w_scale, self.bias, out_dtype=x.dtype)
        xf = x.float()
        m = None
        if self.a_scale is not None:
            a_scale = self.a_scale
        else:  # zero-point: center each token into the full int8 range
            mx, mn = xf.amax(dim=-1, keepdim=True), xf.amin(dim=-1, keepdim=True)
            m = (mx + mn) * 0.5
            a_scale = absmax_scale((mx - mn) * 0.5)
            xf = xf - m
        x_q = torch.round(xf / a_scale).clamp(-127, 127).to(torch.int8)
        y = _int_mm(x_q.reshape(-1, self.in_features), self.w_q.t()).reshape(*x.shape[:-1], self.out_features)
        y = y.float() * (a_scale * self.w_scale)
        if m is not None:
            y = y + m * self.w_colsum  # exact: x @ Wq*s = (x - m) @ Wq*s + m * colsum(Wq*s)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def trunk_policy(spec: str):
    """Parse a mixed-precision trunk policy into (enc_pred, dec_pred)
    predicates for :func:`quantize_linears` (the JAX package's grammar).

    ``"all"`` | ``"none"`` | comma list of ``scope.layer``, scope one of
    ``enc`` / ``dec`` / ``*``, layer one of ``qkv``, ``proj`` (self-attention
    out-projection), ``cross`` (every cross-attention projection), ``fc1``,
    ``fc2``, ``mlp`` (fc1 + fc2), ``*``. Example: ``"enc.*,dec.mlp"``.
    """
    spec = (spec or "all").strip()
    if spec == "all":
        return (lambda p, l: True), (lambda p, l: True)
    if spec == "none":
        return (lambda p, l: False), (lambda p, l: False)

    layer_substr = {
        "qkv": ("attn.qkv",),
        "proj": ("attn.proj",),  # the self-attention out-projection, not cross (below)
        "cross": ("cross_attn.",),
        "fc1": ("mlp.fc1",),
        "fc2": ("mlp.fc2",),
        "mlp": ("mlp.fc1", "mlp.fc2"),
    }
    rules = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            scope, layer = item.split(".", 1)
        except ValueError as e:
            raise ValueError(f"bad policy item {item!r}: expected scope.layer") from e
        if scope not in ("enc", "dec", "*"):
            raise ValueError(f"bad policy scope {scope!r} in {item!r}")
        if layer != "*" and layer not in layer_substr:
            raise ValueError(f"bad policy layer {layer!r} in {item!r} (one of {sorted(layer_substr)})")
        rules.append((scope, layer))

    def make_pred(component):
        def pred(path, _lin):
            for scope, layer in rules:
                if scope not in ("*", component):
                    continue
                if layer == "*":
                    return True
                if layer == "proj" and "cross_attn." in path:  # cross has its own token
                    continue
                if any(s in path for s in layer_substr[layer]):
                    return True
            return False

        return pred

    return make_pred("enc"), make_pred("dec")


def quantize_linears(
    module: nn.Module,
    *,
    min_params: int = 1 << 16,
    predicate: Optional[Callable[[str, nn.Linear], bool]] = None,
    asym: Optional[Callable[[str, nn.Linear], bool]] = None,
    _path: str = "",
) -> int:
    """Replace every large linear layer under ``module`` (in place) with an
    :class:`Int8Linear`. Returns the number of layers converted.

    min_params: skip layers with fewer weight elements.
    predicate: optional ``(dotted_path, linear) -> bool`` filter on top of the size threshold.
    asym: optional ``(dotted_path, linear) -> bool`` selecting the zero-point activation mode.
    """
    count = 0
    for name, child in list(module.named_children()):
        path = f"{_path}.{name}".lstrip(".")
        if isinstance(child, nn.Linear):
            if child.weight.numel() >= min_params and (predicate is None or predicate(path, child)):
                setattr(module, name, Int8Linear.from_linear(child, asym=None if asym is None else asym(path, child)))
                count += 1
        elif not isinstance(child, Int8Linear):
            count += quantize_linears(child, min_params=min_params, predicate=predicate, asym=asym, _path=path)
    return count


def quantize_trunk(model: nn.Module, policy: str = "all", *, asym: Optional[str] = None, min_params: int = 1 << 16) -> int:
    """Quantize a model's trunk (``model.encoder`` and ``model.info_sharing``:
    DUSt3R, UFMFlow, MultiViewPointmapModel) under a mixed-precision policy (see
    :func:`trunk_policy`); ``asym`` is a second policy naming the layers that
    take the zero-point activation mode (None: "none"). Returns the number of
    converted linears."""
    enc_pred, dec_pred = trunk_policy(policy)
    enc_asym, dec_asym = trunk_policy(asym or "none")
    n = quantize_linears(model.encoder, min_params=min_params, predicate=enc_pred, asym=enc_asym)
    n += quantize_linears(model.info_sharing, min_params=min_params, predicate=dec_pred, asym=dec_asym)
    return n
