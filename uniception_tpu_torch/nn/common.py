"""
Small shared NN utilities (counterpart of uniception_tpu/nn/common.py):
Identity, GELU by the configured mode, the reference's Linear init with an
optional compute dtype, the xavier-uniform and truncated-normal inits (zeros
under fast init, models/utils/config.py), gradient checkpointing with the
``UNICEPTION_TPU_REMAT_POLICY`` policies (:func:`remat_call`), and
the counterparts of flax's ``nnx.Linear`` and ``nnx.Conv`` (lecun-normal init;
the conv on channels-last activations) for the modules the JAX package builds
from them directly, and flax's ``nnx.GroupNorm``.

Mixed precision follows flax's ``dtype`` / ``param_dtype`` split: parameters
stay in their own dtype (fp32 masters for training) and are cast to the
compute dtype at each use, with the input, so the optimizer sees fp32
parameters and fp32 gradients while the matmuls run in bf16.
"""

from typing import Callable, Optional

import collections
import contextlib
import contextvars
import functools
import math
import os
import warnings

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

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


class RematPolicy:
    """A selective-checkpointing policy (``torch.utils.checkpoint.create_selective_checkpoint_contexts``): the outputs
    of the ops ``saves(op, args)`` holds are kept from the forward, everything else is recomputed in the backward.
    ``names`` are the :func:`checkpoint_name` names whose tensors it keeps."""

    def __init__(self, name: str, saves: Callable, names=()):
        self.name, self.saves, self.names = name, saves, tuple(names)

    def __call__(self, ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if self.saves(op, args) else CheckpointPolicy.PREFER_RECOMPUTE

    def __repr__(self):
        return f"RematPolicy({self.name!r})"


@functools.lru_cache(maxsize=None)
def _attention_ops() -> frozenset:
    "The attention kernels' ops: K1 with and without its logsumexp, K5 self and cross, K6."
    import uniception_tpu_torch.ops.flash_attention  # noqa: F401  (registers the ops)
    import uniception_tpu_torch.ops.fused_attention  # noqa: F401

    u = torch.ops.uniception
    return frozenset(op.default for op in (u.flash_attention_fwd, u.flash_attention_fwd_lse, u.fused_self_attention,
                                           u.fused_cross_attention, u.flash_attention_int8))


_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))

# JAX's dots_with_no_batch_dims_saveable: the outputs of the products without batch dims are kept. Every F.linear
# (on 2-D or folded 3-D input) and every 2-D matmul lands on aten.mm or aten.addmm; batched products (bmm, baddbmm:
# the attention einsums), the kernels' ops (in JAX a pallas_call is not a dot_general either), convolutions and
# everything elementwise are recomputed.
DOTS = RematPolicy("dots", lambda op, args: op in _DOTS)


def _saves_attn_out(op, args) -> bool:
    if op is _NAME_OP_DEFAULT:
        return args[1] == "attn_out"
    return op in _attention_ops()


# JAX's save_only_these_names("attn_out"): the attention outputs are kept, whichever route made them: a kernel's op
# (K1's keeps its logsumexp with its output, the one tensor the port keeps beyond JAX: B·H·N fp32, 1/32 of the bf16
# output at D = 64, and with it the recompute does not launch K1 again; the gradients are the same), or, on the
# routes without one ("naive", Dv != Dq), the tensor :func:`checkpoint_name` marks.
ATTN_OUT = RematPolicy("attn_out", _saves_attn_out, names=("attn_out",))

_ACTIVE_POLICY = contextvars.ContextVar("uniception_remat_policy", default=None)


@torch.library.custom_op("uniception::checkpoint_name", mutates_args=())
def _checkpoint_name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_checkpoint_name_op.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name_op.register_autograd(lambda ctx, grad: (grad, None))
_NAME_OP_DEFAULT = torch.ops.uniception.checkpoint_name.default


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: name ``x`` for a remat policy that keeps tensors by name. Inside a
    :func:`remat_call` whose policy keeps ``name`` it is the op ``uniception::checkpoint_name`` (a copy of ``x``),
    which that policy saves; everywhere else it returns ``x`` itself."""
    policy = _ACTIVE_POLICY.get()
    if policy is None or name not in policy.names:
        return x
    return _checkpoint_name_op(x, name)


def resolve_remat_policy() -> Optional[RematPolicy]:
    """The ``UNICEPTION_TPU_REMAT_POLICY`` default for gradient checkpointing, read at each call as the JAX package
    reads it: "dots" -> :data:`DOTS`, "attn_out" -> :data:`ATTN_OUT`, unset -> None (full rematerialization); any
    other value warns and is full rematerialization. Shared by :func:`remat_call` and the DPT processor's
    checkpoint."""
    env_policy = os.environ.get("UNICEPTION_TPU_REMAT_POLICY")
    if env_policy == "dots":
        return DOTS
    if env_policy == "attn_out":
        return ATTN_OUT
    if env_policy:
        warnings.warn(
            f"UNICEPTION_TPU_REMAT_POLICY={env_policy!r} is not one of"
            " ('dots', 'attn_out'); falling back to full rematerialization.",
            stacklevel=2,
        )
    return None


def _generators(blk) -> list:
    "The explicit generators the modules under ``blk`` (a module, or a bound method of one) draw their masks from."
    owner = getattr(blk, "__self__", blk)
    if not isinstance(owner, nn.Module):
        return []
    gens = {}
    for m in owner.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator):
            gens[id(g)] = g
    return list(gens.values())


@contextlib.contextmanager
def _in_states(gens, states):
    "Run with each generator at the state it had when the forward began, then put back the state it has now."
    now = [g.get_state() for g in gens]
    for g, s in zip(gens, states):
        g.set_state(s)
    try:
        yield
    finally:
        for g, s in zip(gens, now):
            g.set_state(s)


@contextlib.contextmanager
def _chain(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


_SAVE = (CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_SAVE)


class _Remat:
    """One :func:`remat_call`: checkpoint's ``context_fn`` and, with a policy, the policy function its selective
    contexts call.

    Selective checkpointing decides at each op of the forward whether to keep its output, before it can know whether
    the backward reads it: the recompute stops after the last tensor the backward saves (non-reentrant checkpoint's
    early stop), so an output kept after that is held to the block's backward and never read (a block's last linear,
    whose output only joins the residual). JAX's remat keeps only what its backward reads, so each op's place is
    noted against the forward's saves (a saved-tensors hook over checkpoint's own) and, when the forward ends, an
    output kept after the last save is given up: it is recomputed if the recompute ever reaches it."""

    def __init__(self, policy: Optional[RematPolicy], gens):
        self.policy, self.gens = policy, gens
        self.states = [g.get_state() for g in gens]
        self.seq, self.last_save = 0, 0  # ops dispatched in the forward; ops dispatched at its last save
        self.calls, self.recalls = collections.Counter(), collections.Counter()
        self.kept, self.dropped, self.storage = [], set(), None  # (place, op, index) of each kept output

    def __call__(self, ctx, op, *args, **kwargs):
        if ctx.is_recompute:  # torch versions that ask the policy again in the recompute
            idx = self.recalls[op]
            self.recalls[op] += 1
            return CheckpointPolicy.PREFER_RECOMPUTE if (op, idx) in self.dropped else self.policy(ctx, op, *args)
        idx = self.calls[op]
        self.calls[op] += 1
        decision = self.policy(ctx, op, *args)
        if decision in _SAVE:
            self.kept.append((self.seq, op, idx))
        self.seq += 1
        return decision

    def contexts(self):
        if self.policy is None:
            forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            forward, recompute = create_selective_checkpoint_contexts(self)
            self.storage = forward.storage
            forward = _chain(forward, self._watch_saves())
        return forward, _chain(_in_states(self.gens, self.states), recompute)

    @contextlib.contextmanager
    def _watch_saves(self):
        pack, unpack = torch._C._autograd._top_saved_tensors_default_hooks(False)  # checkpoint's own

        def watched(x):
            self.last_save = self.seq
            return pack(x)

        with torch.autograd.graph.saved_tensors_hooks(watched, unpack):
            yield
        self._give_up_late()

    def _give_up_late(self):
        "Give up the outputs kept after the forward's last save (storage by op: by index, or a queue of kept ones)."
        from torch.utils import checkpoint as ckpt

        late = [(op, idx) for place, op, idx in self.kept if place >= self.last_save]
        for op, n in collections.Counter(op for op, _ in late).items():
            entries = self.storage.get(op)
            if isinstance(entries, dict) and hasattr(ckpt, "_RECOMPUTE"):
                for o, idx in late:
                    if o is op:
                        entries[idx] = ckpt._RECOMPUTE
            elif isinstance(entries, list):
                del entries[len(entries) - n:]
            else:
                continue
            self.dropped.update((o, idx) for o, idx in late if o is op)

    def kept_tensors(self) -> list:
        "The tensors the policy keeps for the backward after the forward (the selective storage's live entries)."
        out = []
        for entries in (self.storage or {}).values():
            for entry in (entries.values() if isinstance(entries, dict) else entries):
                for leaf in entry if isinstance(entry, (tuple, list)) else (entry,):
                    val = getattr(leaf, "val", None)
                    if isinstance(val, torch.Tensor):
                        out.append(val)
        return out


def _named(blk, policy, *args):
    token = _ACTIVE_POLICY.set(policy)
    try:
        return blk(*args)
    finally:
        _ACTIVE_POLICY.reset(token)


def remat_call(blk: nn.Module, *args, policy: Optional[RematPolicy] = None):
    """Apply ``blk`` (a module or any callable) under gradient checkpointing (the JAX package's ``remat_call``):
    activations inside it are recomputed in the backward instead of kept, trading FLOPs for memory.

    policy: None takes :func:`resolve_remat_policy` (``UNICEPTION_TPU_REMAT_POLICY``, read at each call):
        unset       -> full rematerialization: only the arguments are kept;
        "dots"      -> :data:`DOTS`, JAX's ``dots_with_no_batch_dims_saveable``: the linears' outputs are kept;
        "attn_out"  -> :data:`ATTN_OUT`, JAX's ``save_only_these_names("attn_out")``: the attention outputs are
                       kept (with K1's logsumexp), the projections, norms and MLP recomputed.
    A policy is torch's selective checkpointing over the dispatched ops: under it every kernel launch is its
    ``uniception::`` op (ops/serving_operands.py ``traced``), so a kept kernel output is not launched again and a
    recomputed one is launched (and counted) once more.

    Dropout and stochastic depth drawing from an explicit generator draw the forward's masks again in the recompute
    under every policy: each such generator (on the modules under ``blk``) is set back to its state at the forward
    for the recompute and then returned to where it was, so it advances once per call, as a plain call advances it.
    (The JAX package's ``remat_call`` runs a split copy of the module, whose RNG counter never advances: every call
    there reuses one mask. The port does not copy that.)"""
    if policy is None:
        policy = resolve_remat_policy()
    gens = _generators(blk)
    if policy is None and not gens:
        return checkpoint(blk, *args, use_reentrant=False)
    return checkpoint(_named, blk, policy, *args, use_reentrant=False, context_fn=_Remat(policy, gens).contexts)


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
