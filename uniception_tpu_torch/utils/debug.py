"""
Numerics debugging helpers (counterpart of uniception_tpu/utils/debug.py): a
scan for NaN/Inf over nested tensors, arrays, dicts, lists, tuples and
dataclasses, with the JAX package's leaf paths (``['key'][0].field``) and
messages.
"""

import dataclasses
import functools
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch

__all__ = ["checkify_nan", "find_nonfinite", "assert_finite"]


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    "(path, leaf) in the JAX package's flattening order: dict keys sorted, sequences in order, dataclass fields."
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):  # namedtuple
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif tree is not None:
        yield path, tree


def find_nonfinite(tree: Any, prefix: str = "") -> list:
    "Return [(path, n_nan, n_inf)] for every floating-point leaf with non-finite values."
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            n_nan, n_inf = int(torch.isnan(leaf).sum()), int(torch.isinf(leaf).sum())
        else:
            try:
                arr = np.asarray(leaf)
            except Exception:
                continue
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            n_nan, n_inf = int(np.isnan(arr).sum()), int(np.isinf(arr).sum())
        if n_nan or n_inf:
            bad.append((prefix + path, n_nan, n_inf))
    return bad


def assert_finite(tree: Any, label: str = "tree"):
    "Raise with a per-leaf report if any floating-point leaf of ``tree`` is non-finite."
    bad = find_nonfinite(tree)
    if bad:
        lines = "\n".join(f"  {p}: {n} NaN, {i} Inf" for p, n, i in bad)
        raise FloatingPointError(f"Non-finite values in {label}:\n{lines}")


def checkify_nan(fn: Callable) -> Callable:
    """Wrap ``fn`` so a NaN/Inf in its outputs raises ``FloatingPointError``
    naming the first non-finite leaf.

    This is not a checkify: the JAX package's version (``jax.experimental.
    checkify`` with float checks) traps a non-finite value in any intermediate
    of a jitted function. Here the outputs are scanned after the call, so a
    NaN that never reaches an output goes unseen; for gradients torch has
    ``torch.autograd.detect_anomaly``.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = find_nonfinite(out)
        if bad:
            p, n, i = bad[0]
            name = getattr(fn, "__name__", "fn")
            raise FloatingPointError(f"Non-finite values in the output of {name}: first at {p or '<root>'} "
                                     f"({n} NaN, {i} Inf)")
        return out

    return wrapped
