"""
Checkpoint I/O (counterpart of uniception_tpu/utils/checkpoint.py).

The reference's checkpoint contract: a mapping with a ``"model"`` state dict
plus metadata keys such as ``data_norm_type`` (reference:
encoders/croco.py:99-111). Two containers:

    * ``.npz``: torch-layout arrays under ``model.<key>`` plus one JSON
      metadata entry, ``__uniception_tpu_meta__`` — the JAX package's format,
      so a file written by either package loads in the other;
    * ``.pth`` / ``.pt`` / ``.bin``: ``torch.load(map_location="cpu")``; a bare
      state dict is wrapped as ``{"model": ...}``.

:func:`load_checkpoint` returns numpy arrays, floating ones as fp32 (as the
JAX package does), ready for ``utils.weights.load_state_dict_numpy``.
"""

import json
import os
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["load_checkpoint", "save_checkpoint"]

_META_KEY = "__uniception_tpu_meta__"


def _to_numpy_tree(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype.is_floating_point else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(v) for v in obj)
    return obj


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint from .npz or .pth/.pt/.bin.

    Returns a dict with at least a "model" key mapping dotted names to numpy
    arrays, plus any metadata keys stored alongside.
    """
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data[_META_KEY])) if _META_KEY in data.files else {}
            model = {k[len("model."):]: data[k] for k in data.files if k.startswith("model.")}
        return {"model": model, **meta}
    if path.endswith((".pth", ".pt", ".bin")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if "model" not in ckpt and all(hasattr(v, "shape") for v in ckpt.values()):
            ckpt = {"model": ckpt}
        return _to_numpy_tree(ckpt)
    raise ValueError(f"Unknown checkpoint format: {path}")


def save_checkpoint(path: str, model_state: Dict[str, Any], **metadata):
    """Save a torch-layout state dict (numpy arrays or tensors; bf16 and fp16
    tensors are widened to fp32) + metadata to the .npz format."""
    if not path.endswith(".npz"):
        raise ValueError("the .npz interchange format needs a .npz path")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {f"model.{k}": _to_numpy_tree(v) if isinstance(v, torch.Tensor) else np.asarray(v)
               for k, v in model_state.items()}
    payload[_META_KEY] = np.array(json.dumps(metadata))
    np.savez(path, **payload)
