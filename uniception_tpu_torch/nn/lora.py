"""
LoRA adapters (counterpart of uniception_tpu/nn/lora.py).

A :class:`LoRALinear` wraps a linear layer with a rank-``r`` update
``y = base(x) + (x @ lora_a) @ lora_b * (alpha / r)``; ``lora_b`` starts at
zero, so wrapping changes nothing until the adapters train. With
``make_train_step(trainable=lora_trainable)`` only the adapters get
gradients and optimizer state; the base weights get no weight gradient.
:func:`merge_lora` folds every adapter back into its base weight in place
(``W += (A @ B * scale)^T``) and puts the plain linear back, so serving
(int8 quantization, the fused attention, checkpoints) sees an ordinary model.

The adapters are stored in the JAX package's layouts, ``lora_a`` (in, r) and
``lora_b`` (r, out), in the base weight's dtype, and the state-dict keys are
the JAX export's (``...qkv.base.weight``, ``...qkv.lora_a``), so a JAX
LoRA-wrapped model's state loads with ``utils.weights.load_state_dict_numpy``
as any other. :class:`LoRALinear` is not an ``nn.Linear``: the fused-attention
rule (nn/blocks.py) and ``nn.quant.quantize_linears`` test for ``nn.Linear``
and would read the base weight alone, dropping the adapter. A wrapped
projection therefore leaves the fused contract, as in the JAX package.
"""

from typing import Callable, Optional

import torch
from torch import nn

__all__ = ["LoRALinear", "apply_lora", "merge_lora", "lora_trainable"]


class LoRALinear(nn.Module):
    """A linear layer plus a trainable low-rank update:
    ``y = base(x) + (x @ lora_a) @ lora_b * (alpha / rank)``.

    ``lora_a`` (in, rank) is drawn normal / rank from ``generator``,
    ``lora_b`` (rank, out) is zero, both in the base weight's dtype and on
    its device. The update runs in x's dtype.
    """

    def __init__(self, base: nn.Linear, rank: int = 8, alpha: Optional[float] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        out_f, in_f = base.weight.shape
        dtype, device = base.weight.dtype, base.weight.device
        self.base = base
        self.rank = rank
        self.alpha = float(alpha if alpha is not None else rank)
        a = torch.randn(in_f, rank, generator=generator, device=device) * (1.0 / rank)
        self.lora_a = nn.Parameter(a.to(dtype))
        self.lora_b = nn.Parameter(torch.zeros(rank, out_f, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.tensor(self.alpha / self.rank, dtype=x.dtype).item()  # alpha / rank rounded to x's dtype
        return self.base(x) + ((x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)) * scale

    def merged_weight(self) -> torch.Tensor:
        "The base weight (out, in) with the adapter folded in, summed in fp32, in the base weight's dtype."
        w = self.base.weight
        delta = (self.lora_a.float() @ self.lora_b.float()) * (self.alpha / self.rank)
        return (w.float() + delta.t()).to(w.dtype)


def apply_lora(module: nn.Module, rank: int = 8, alpha: Optional[float] = None, *,
               generator: Optional[torch.Generator] = None, min_params: int = 1 << 16,
               predicate: Optional[Callable[[str, nn.Linear], bool]] = None, _path: str = "") -> int:
    """Wrap every ``nn.Linear`` under ``module`` with at least ``min_params``
    weight elements (and, with ``predicate``, for which ``predicate(dotted
    path, linear)`` holds) in a :class:`LoRALinear`, in place, drawing the
    adapters from ``generator`` in module order. Returns the number wrapped."""
    count = 0
    for name, child in list(module.named_children()):
        path = f"{_path}.{name}".lstrip(".")
        if isinstance(child, nn.Linear):
            if child.weight.numel() >= min_params and (predicate is None or predicate(path, child)):
                setattr(module, name, LoRALinear(child, rank=rank, alpha=alpha, generator=generator))
                count += 1
        elif not isinstance(child, LoRALinear):
            count += apply_lora(child, rank, alpha, generator=generator, min_params=min_params, predicate=predicate,
                                _path=path)
    return count


@torch.no_grad()
def merge_lora(module: nn.Module) -> int:
    "Fold every :class:`LoRALinear` under ``module`` into its base linear, in place. Returns the count."
    count = 0
    for name, child in list(module.named_children()):
        if isinstance(child, LoRALinear):
            child.base.weight.copy_(child.merged_weight())
            setattr(module, name, child.base)
            count += 1
        else:
            count += merge_lora(child)
    return count


def lora_trainable(name: str) -> bool:
    "``make_train_step(trainable=lora_trainable)``: train only the adapters (``named_parameters`` names)."
    return name.rsplit(".", 1)[-1] in ("lora_a", "lora_b")
