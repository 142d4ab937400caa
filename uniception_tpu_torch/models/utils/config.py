"""
Global kernel selection (counterpart of uniception_tpu/models/utils/config.py).

The implementation switch:

    - "kernel": the hand-written CUDA kernels for CUDA tensors — the default,
                the counterpart of "pallas";
    - "fused":  as "kernel", but every attention layer inside the fused
                contract (nn/blocks.py ``_fused_attention_applicable``: plain
                projections, RoPE2D or no positional encoding, at most 2048
                keys) runs the fused qkv-projection + RoPE + attention kernel
                (K5, ops/fused_attention.py), the counterpart of "fused"; a
                call outside the contract takes exact attention (K1), never
                the int8 attention, as the JAX package routes it;
    - "naive":  the plain PyTorch version of EVERY kernel (flash attention,
                int8 attention, 2D RoPE, the fused attention, the int8 matmul,
                the 3x3 conv), for parity runs: a naive run launches no kernel.

The attention quantization mode (inference only, the single-key-block case
of ops/attention.py): "none" (bf16 QK^T and PV, the default), "int8" (int8
QK^T, bf16 PV) or "int8pv" (int8 QK^T and PV).

The 3x3-conv lowering of the DPT head's eligible convs (nn/dpt_parts.py):
"torch" (the stock conv, the default, the counterpart of "xla") or "kernel"
(the hand-written conv kernel, the counterpart of "pallas").

A CPU tensor always takes the plain versions. The GELU mode is "exact" (erf,
parity with torch nn.GELU) or "tanh". All are set with the setters below, and
read at import from the JAX package's environment variables
(uniception_tpu/models/utils/config.py): ``UNICEPTION_TPU_ATTN`` ("pallas" and
"xla" are "kernel"; "fused", "naive"), ``UNICEPTION_TPU_ATTN_QUANT``,
``UNICEPTION_TPU_CONV3X3`` ("pallas" is "kernel", "xla" is "torch") and
``UNICEPTION_TPU_GELU``; each also takes the port's own names. An unknown value
raises ``ValueError`` naming the variable (the JAX package warns and falls
back to its default).
"""

import os

__all__ = [
    "get_attention_impl",
    "set_attention_impl",
    "get_attention_quant",
    "set_attention_quant",
    "get_conv3x3_impl",
    "set_conv3x3_impl",
    "get_gelu_mode",
    "set_gelu_mode",
    "use_fused_attn",
    "set_fused_attn",
]

_VALID_IMPLS = ("kernel", "fused", "naive")


def _from_env(var: str, default: str, names: dict) -> str:
    """The setting an environment variable asks for, through ``names`` (the JAX package's value -> the port's);
    ``default`` when it is unset. Raises ValueError, naming the variable, on any other value."""
    value = os.environ.get(var)
    if value is None:
        return default
    if value not in names:
        raise ValueError(f"{var}={value!r} is not one of {sorted(names)}")
    return names[value]


_ATTN_IMPL = _from_env("UNICEPTION_TPU_ATTN", "kernel",
                       {"pallas": "kernel", "xla": "kernel", "kernel": "kernel", "fused": "fused", "naive": "naive"})
_ATTN_QUANT = _from_env("UNICEPTION_TPU_ATTN_QUANT", "none", {m: m for m in ("none", "int8", "int8pv")})
_CONV3X3_IMPL = _from_env("UNICEPTION_TPU_CONV3X3", "torch",
                          {"pallas": "kernel", "xla": "torch", "kernel": "kernel", "torch": "torch"})
_GELU_MODE = _from_env("UNICEPTION_TPU_GELU", "exact", {"exact": "exact", "tanh": "tanh"})


def get_attention_impl() -> str:
    "Return the selected implementation ('kernel', 'fused' or 'naive')."
    return _ATTN_IMPL


def set_attention_impl(impl: str):
    "Select the kernels ('kernel'), the kernels with the fused attention ('fused'), or every kernel's plain version ('naive')."
    global _ATTN_IMPL
    if impl not in _VALID_IMPLS:
        raise ValueError(f"Invalid attention impl {impl!r}; must be one of {_VALID_IMPLS}")
    _ATTN_IMPL = impl


def get_attention_quant() -> str:
    "Return the attention quantization mode ('none', 'int8' or 'int8pv')."
    return _ATTN_QUANT


def set_attention_quant(mode: str):
    "Select the attention quantization mode ('none', 'int8' or 'int8pv')."
    global _ATTN_QUANT
    if mode not in ("none", "int8", "int8pv"):
        raise ValueError(f"Invalid attention quant mode {mode!r}")
    _ATTN_QUANT = mode


def get_conv3x3_impl() -> str:
    "Return the 3x3-conv lowering ('torch' or 'kernel')."
    return _CONV3X3_IMPL


def set_conv3x3_impl(impl: str):
    "Select the 3x3-conv lowering ('torch' or 'kernel')."
    global _CONV3X3_IMPL
    if impl not in ("torch", "kernel"):
        raise ValueError(f"Invalid conv3x3 impl {impl!r}")
    _CONV3X3_IMPL = impl


def get_gelu_mode() -> str:
    "Return the current GELU mode ('exact' or 'tanh')."
    return _GELU_MODE


def set_gelu_mode(mode: str):
    "Select the GELU implementation ('exact' for parity, 'tanh' for speed)."
    global _GELU_MODE
    if mode not in ("exact", "tanh"):
        raise ValueError(f"Invalid gelu mode {mode!r}")
    _GELU_MODE = mode


def use_fused_attn() -> bool:
    "True when a kernel implementation (not 'naive') is selected: the reference's and the JAX package's shim."
    return _ATTN_IMPL != "naive"


def set_fused_attn(enable: bool = True):
    "Select the kernels ('kernel') or every kernel's plain version ('naive'), mirroring the reference API."
    set_attention_impl("kernel" if enable else "naive")
