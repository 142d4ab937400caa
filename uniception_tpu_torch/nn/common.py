"""
Small shared NN utilities (counterpart of uniception_tpu/nn/common.py):
Identity, GELU by the configured mode, the reference's Linear init with an
optional compute dtype, the xavier-uniform and truncated-normal inits (zeros
under fast init, models/utils/config.py), gradient checkpointing, and
the counterparts of flax's ``nnx.Linear`` and ``nnx.Conv`` (lecun-normal init;
the conv on channels-last activations) for the modules the JAX package builds
from them directly, and flax's ``nnx.GroupNorm``.

Mixed precision follows flax's ``dtype`` / ``param_dtype`` split: parameters
stay in their own dtype (fp32 masters for training) and are cast to the
compute dtype at each use, with the input, so the optimizer sees fp32
parameters and fp32 gradients while the matmuls run in bf16.
"""

from typing import Optional

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from uniception_tpu_torch.models.utils.config import get_fast_init, get_gelu_mode

__all__ = ["Identity", "gelu_exact", "xavier_uniform", "trunc_normal", "Linear", "LinearX", "remat_call",
           "lecun_normal", "flax_linear", "ChannelsLastConv", "GroupNorm"]

Identity = nn.Identity


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    "GELU as torch nn.GELU (erf), or its tanh approximation when the GELU mode is 'tanh'."
    return F.gelu(x, approximate="tanh" if get_gelu_mode() == "tanh" else "none")


def xavier_uniform(shape, dtype: torch.dtype = torch.float32, *, generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
    """A new tensor of ``shape`` (torch's layout: (out, in, *kernel)) drawn uniform in +-sqrt(6 / (fan_in +
    fan_out)) from ``generator``: the JAX package's ``xavier_uniform`` (its nn/common.py:42), and zeros under fast
    init (models/utils/config.py ``fast_init``), as there."""
    t = torch.empty(shape, dtype=dtype, device=device)
    with torch.no_grad():
        return t.zero_() if get_fast_init() else nn.init.xavier_uniform_(t, generator=generator)


def trunc_normal(tensor: torch.Tensor, std: float = 0.02, *, generator: Optional[torch.Generator] = None):
    """Fill ``tensor`` in place with ``std`` times a unit normal truncated to (-2, 2), so values lie within two
    ``std`` (their standard deviation is 0.88 ``std``): ``jax.nn.initializers.truncated_normal(stddev=std)``, the
    JAX package's ``trunc_normal`` (its nn/common.py:54); zeros under fast init. Returns the tensor."""
    with torch.no_grad():
        if get_fast_init():
            return tensor.zero_()
        nn.init.trunc_normal_(tensor, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return tensor.mul_(std)


class Linear(nn.Linear):
    """nn.Linear with an optional compute dtype: input, weight and bias are
    cast to ``dtype`` at use (flax ``nnx.Linear(dtype=...)``); None computes
    in the parameters' dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


def LinearX(
    in_features: int,
    out_features: int,
    *,
    bias: bool = True,
    device=None,
    dtype=None,
    generator: Optional[torch.Generator] = None,
) -> Linear:
    """:class:`Linear` with the reference's init scheme: xavier-uniform
    weight (zeros under fast init), zero bias (reference:
    encoders/croco.py:136-145 et al.). ``dtype`` is the compute dtype."""
    lin = Linear(in_features, out_features, bias=bias, device=device, dtype=dtype)
    with torch.no_grad():
        if get_fast_init():
            lin.weight.zero_()
        else:
            nn.init.xavier_uniform_(lin.weight, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def remat_call(blk: nn.Module, *args):
    """Apply a module under gradient checkpointing (the JAX package's
    ``remat_call``, full rematerialization): its activations are not kept
    for the backward but recomputed there, trading FLOPs for memory."""
    return checkpoint(blk, *args, use_reentrant=False)


def lecun_normal(weight: torch.Tensor, fan_in: int, *, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default kernel init in place: a unit normal truncated to (-2, 2), scaled to variance 1 / fan_in
    (``variance_scaling(1, "fan_in", "truncated_normal")``). Returns the tensor."""
    return trunc_normal(weight, 1.0 / (0.87962566103423978 * math.sqrt(fan_in)), generator=generator)


def flax_linear(in_features: int, out_features: int, *, bias: bool = True, device=None, dtype=None,
                generator: Optional[torch.Generator] = None) -> Linear:
    "``nnx.Linear``: :class:`Linear` with a lecun-normal weight and zero bias; ``dtype`` is the compute dtype."
    lin = Linear(in_features, out_features, bias=bias, device=device, dtype=dtype)
    lecun_normal(lin.weight, in_features, generator=generator)
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


class ChannelsLastConv(nn.Conv2d):
    """``nnx.Conv`` on channels-last activations: (B, H, W, Cin) -> (B, H', W', Cout) through an NCHW view of the
    same memory, torch's (out, in / groups, kh, kw) weight, lecun-normal init, zero bias, compute ``dtype``.
    ``padding`` is torch's: flax's default "SAME" is no padding at the stride-k k x k convs the JAX modules use."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0, groups: int = 1, bias: bool = True, *,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, groups=groups, bias=bias,
                         device=device)
        self.compute_dtype = dtype
        lecun_normal(self.weight, (cin // groups) * self.kernel_size[0] * self.kernel_size[1], generator=generator)
        if bias:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias).permute(0, 2, 3, 1)


class GroupNorm(nn.GroupNorm):
    """``nnx.GroupNorm``: epsilon 1e-6, statistics in fp32 with flax's fast variance (E[x^2] - E[x]^2, floored at 0),
    the scale folded into the reciprocal deviation as flax folds it, the output in the compute ``dtype`` (None: the
    input's). The statistics are two full-width reductions: torch's native group norm reduces each (sample, group)
    row in one thread block, which at MoGe's one-group norms over 296^2 maps is two blocks for the whole card. MoGe's
    conv head, the Cosmos tokenizer's ``Normalize`` (32 groups) and its video ``CausalNormalize`` share it."""

    def __init__(self, num_channels: int, num_groups: int, *, dtype=None, device=None):
        super().__init__(num_groups, num_channels, eps=1e-6, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, frames: bool = False) -> torch.Tensor:
        """x: (B, C, *spatial). With ``frames`` a (B, C, T, *spatial) tensor takes its statistics per frame, as the
        norm of the frames folded into the batch does, without the copies of the fold."""
        dt = self.compute_dtype or x.dtype
        B, C, G = x.shape[0], x.shape[1], self.num_groups
        if frames:
            xg, dims, shape = x.float().reshape(B, G, C // G, x.shape[2], -1), (2, 4), (1, G, C // G, 1, 1)
        else:
            xg, dims, shape = x.float().reshape(B, G, C // G, -1), (2, 3), (1, G, C // G, 1)
        mean = xg.mean(dim=dims, keepdim=True)
        var = (xg.square().mean(dim=dims, keepdim=True) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().view(shape)
        out = (xg - mean) * mul + self.bias.float().view(shape)
        return out.reshape(x.shape).to(dt)
