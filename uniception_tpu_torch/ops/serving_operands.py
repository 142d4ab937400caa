"""
Weight layouts that a serving artifact computes once (utils/export.py).

Some kernels read a weight in a layout of their own: K7 its HWIO bf16 copy
(nn/dpt_parts.py), K5's bf16 projection at a head dim other than 64 its
padded heads (ops/fused_attention.py). Eager calls keep or remake such a copy
as they always have. An exported program must neither bake the copy in as a
constant (that would put the weights in the file) nor remake it on every call,
so the callers go through :func:`weight_layout`:

    * eager: ``fn(*weights)``, nothing else;
    * while utils/export.py traces a module, the active :class:`LayoutTrace`
      decides: at discovery it records which layouts of which state tensors the
      forward needs, and in the forward's trace it hands back the operand that
      the artifact's ``prepare`` program computed from those tensors at ``bind``.

:func:`exporting` tells a caller that it is being traced for export (either
by utils/export.py or by ``torch.export`` itself), so a host branch on data
(DUSt3R's landscape-only batches) takes the static route.

Each kernel launch is a custom op of the ``uniception`` namespace
(:func:`kernel_op`), so a trace records it as one node. An eager call runs
the op's implementation directly: the op's dispatch costs several
microseconds of host time a call, and a forward makes hundreds of calls.
"""

import functools
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

__all__ = ["weight_layout", "exporting", "traced", "kernel_op", "KernelOp", "LayoutTrace"]

_ACTIVE: Optional["LayoutTrace"] = None


class LayoutTrace:
    """The layouts one export needs. ``names`` maps id(state tensor) -> its index in the artifact's state list
    (the tensors the traced module holds). In "record" mode a call notes each (key, state indices) in first-use
    order and computes the layout; in "read" mode it returns the operands the ``prepare`` program gave for a
    recorded one. A layout of anything that is not a state tensor is computed in place, as eager does."""

    def __init__(self, names: dict, mode: str, operands=(), slots=None):
        self.names, self.mode, self.operands = names, mode, operands
        self.slots = {} if slots is None else slots  # (key, indices) -> (first operand, count, is one tensor)
        self.records = []  # (key, fn, indices) in first-use order

    def __call__(self, key: str, fn: Callable, weights):
        idx = tuple(self.names.get(id(w)) for w in weights)
        if any(i is None for i in idx):
            return fn(*weights)
        if self.mode == "record":
            out = fn(*weights)
            if (key, idx) not in self.slots:
                one = isinstance(out, torch.Tensor)
                self.slots[key, idx] = (sum(s[1] for s in self.slots.values()), 1 if one else len(out), one)
                self.records.append((key, fn, idx))
            return out
        if (key, idx) not in self.slots:
            raise RuntimeError(f"weight layout {key!r} of state {idx} was not recorded: the traced forward differs "
                               "from the one the export recorded")
        first, n, one = self.slots[key, idx]
        return self.operands[first] if one else tuple(self.operands[first : first + n])

    def __enter__(self):
        global _ACTIVE
        self._outer, _ACTIVE = _ACTIVE, self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._outer


def exporting() -> bool:
    "Whether the caller is being traced for export (utils/export.py's discovery pass or ``torch.export``)."
    return _ACTIVE is not None or torch.compiler.is_exporting()


def weight_layout(key: str, fn: Callable, *weights):
    """``fn(*weights)``: a layout of state tensors that a kernel reads (a tensor or a tuple of tensors). ``key``
    names the layout with everything it depends on besides the weights (e.g. the head count), so equal keys on equal
    weights are one operand. Eager: computed here; under export: see the module doc."""
    if _ACTIVE is None:
        return fn(*weights)
    return _ACTIVE(key, fn, weights)


def traced() -> bool:
    """Whether a launch goes through its custom op: the caller is traced (export, ``torch.compile``) or a dispatch
    mode watches the calls (FakeTensorMode, a mode that counts them)."""
    return exporting() or torch.compiler.is_compiling() or _get_current_dispatch_mode() is not None


def kernel_op(name: str):
    """``@kernel_op("name")`` on a kernel's implementation registers it as the custom op ``uniception::name``; the
    decorated name is a :class:`KernelOp`."""
    return lambda fn: KernelOp(name, fn)


class KernelOp:
    """A kernel's implementation ``fn`` and its custom op ``op``: a call runs ``fn`` directly, or ``op`` where
    :func:`traced` holds (same arguments, same bits). ``register_fake`` registers the op's fake kernel."""

    def __init__(self, name: str, fn: Callable):
        self.fn, self.op = fn, torch.library.custom_op(f"uniception::{name}", fn, mutates_args=())
        self.register_fake = self.op.register_fake
        functools.update_wrapper(self, fn)

    def __call__(self, *args):
        return self.op(*args) if traced() else self.fn(*args)
