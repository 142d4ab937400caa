"""
Load a torch-layout state dict of numpy arrays into a module.

The arrays are ``{state-dict key: np.ndarray}``: what
``uniception_tpu.utils.torch_compat.state_dict_from_module`` exports from a
JAX module, or a reference ``.pth`` state dict converted to numpy. An entry
that names a non-persistent buffer (the multi-view info sharing's sinusoid
index tables: computed at construction, never loaded) is dropped, here and in
``utils.coldstart.materialize``.
"""

import re
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["load_state_dict_numpy", "recomputed_buffers"]


def recomputed_buffers(module: nn.Module) -> set:
    "Dotted names of the module's non-persistent buffers: computed at construction, never saved or loaded."
    return {
        f"{prefix}.{name}".lstrip(".")
        for prefix, mod in module.named_modules()
        for name, buf in mod._buffers.items()
        if buf is not None and name in mod._non_persistent_buffers_set
    }


def load_state_dict_numpy(module: nn.Module, arrays: Dict[str, np.ndarray], strict: bool = True,
                          ignore: Sequence[str] = ()):
    """Copy ``arrays`` into ``module``'s parameters and buffers, cast to each one's dtype.

    Keys matching a regex of ``ignore`` (known aliases of other keys, such as
    the reference DPT's ``head{1,2}.*`` and ``scratch.layer*_rn`` spellings)
    and keys naming a non-persistent buffer are dropped first and never
    reported as unexpected.

    Raises ValueError on a shape mismatch, and (with ``strict``) KeyError on
    missing or unexpected keys, as torch_compat.load_torch_state_dict does.
    Returns (missing_keys, unexpected_keys).
    """
    pats, recomputed = [re.compile(p) for p in ignore], recomputed_buffers(module)
    arrays = {k: v for k, v in arrays.items() if k not in recomputed and not any(p.search(k) for p in pats)}
    own = module.state_dict()
    missing = [k for k in own if k not in arrays]
    unexpected = [k for k in arrays if k not in own]
    if strict and (missing or unexpected):
        raise KeyError(f"strict load failed: missing_keys={missing}, unexpected_keys={unexpected}")
    present = {k: np.asarray(arrays[k]) for k in own if k in arrays}
    for key, arr in present.items():  # every shape is checked before any parameter changes
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"Shape mismatch for {key}: arrays {arr.shape} vs module {tuple(own[key].shape)}")
    with torch.no_grad():
        for key, arr in present.items():
            own[key].copy_(torch.tensor(arr))  # copy_ casts to the parameter's dtype and device
    return missing, unexpected
