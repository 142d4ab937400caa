"""
Load a torch-layout state dict of numpy arrays into a module.

The arrays are ``{state-dict key: np.ndarray}``: what
``uniception_tpu.utils.torch_compat.state_dict_from_module`` exports from a
JAX module, or a reference ``.pth`` state dict converted to numpy. An entry
that names a non-persistent buffer (the multi-view info sharing's sinusoid
index tables: computed at construction, never loaded) is dropped, here and in
``utils.coldstart.materialize``.

:func:`load_encoder_checkpoint` reads a checkpoint file (``.pth``, ``.pt``,
``.bin`` or ``.npz``, utils/checkpoint.py) and loads its ``"model"`` state
strictly: the encoders' ``pretrained_checkpoint_path`` / ``weights`` /
``pe_checkpoint_path`` readers.
"""

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["load_state_dict_numpy", "load_encoder_checkpoint", "recomputed_buffers"]


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


def load_encoder_checkpoint(module: nn.Module, path: str, ignore: Sequence[str] = (),
                            kept_blocks: Optional[Dict[str, int]] = None):
    """Load the checkpoint file at ``path`` into ``module``: its ``"model"`` state dict (a bare state dict is
    wrapped so, utils/checkpoint.py ``load_checkpoint``) in the module's keys, the reference's torch names, strictly;
    ``ignore`` as for :func:`load_state_dict_numpy`. ``kept_blocks`` maps a block list's key prefix
    (``"model.blocks."``) to the number of blocks the module keeps: the checkpoint's entries of later blocks (a
    full-depth file loaded into an encoder cut by ``keep_first_n_layers``) are dropped first. Returns
    (missing_keys, unexpected_keys)."""
    from uniception_tpu_torch.utils.checkpoint import load_checkpoint

    state = load_checkpoint(path)["model"]
    for prefix, kept in (kept_blocks or {}).items():
        later = re.compile(re.escape(prefix) + r"(\d+)\.")
        state = {k: v for k, v in state.items() if not ((m := later.match(k)) and int(m.group(1)) >= kept)}
    return load_state_dict_numpy(module, state, strict=True, ignore=ignore)
