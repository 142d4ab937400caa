"""
Rank meshes and tensor-parallel sharding (counterpart of uniception_tpu/parallel/mesh.py).

The JAX package places weights with ``NamedSharding`` over a device mesh and
lets XLA insert the collectives. The port runs one process per rank
(``torch.distributed``): a :class:`Mesh` is the world's ranks laid out on
named axes, with one process group per line of each axis, and the modules
call the collectives themselves.

Axes convention, as in the JAX package:
    * "data"  — batch sharding (pure DP)
    * "model" — attention heads / MLP hidden sharding (TP)

Tensor parallelism (:func:`tp_shard_state`) keeps, on each rank of the
"model" axis, its share of every column-parallel layer's output features and
of every row-parallel layer's input features; a row-parallel layer is wrapped
in :class:`RowParallel`, which sums its partial products over the "model" group
before its bias, and a column-parallel one in :class:`ColumnParallel`, whose
input's gradient is summed over the group (Megatron's pair of operators,
parallel/comm.py ``reduce_from`` and ``copy_to``). Every other parameter is the
same on each rank of the group, and so is its gradient. :data:`TP_RULES` are
the JAX rules in the port's state-dict names and layouts: a torch ``weight`` is (out, in), so
JAX's ``kernel`` (in, out) ``P(None, "model")`` is ``P("model", None)`` here;
``Int8Linear`` exports ``w_q`` (in, out) as JAX keeps it, so its rules read as
JAX's.

ZeRO-1 and FSDP (:func:`zero1_shard_state`, :func:`fsdp_shard_state`) split
each tensor over the "data" axis by JAX's per-leaf rule (:func:`leaf_data_spec`:
the largest axis that is free, divisible by the data size and larger than 1),
taken in JAX's layout and reported in the tensor's own.

Two column-parallel layers hold several sections in one output axis: ``qkv``
(q, k and v, each H heads) and SwiGLU's ``w12`` (x1, x2). JAX's spec splits the
axis in contiguous pieces, which at 2-way TP gives rank 0 all of q and half of k;
GSPMD reshuffles before the attention, a rank-local attention cannot. So the
port shards each section on its own (q, k and v by heads, x1 and x2 by
columns), and :func:`leaf_tp_spec` still reports JAX's spec.
"""

import contextlib
import re
import weakref

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.utils.config import get_attention_impl
from uniception_tpu_torch.nn.quant import _int_mm
from uniception_tpu_torch.ops.int8_matmul import absmax_scale, int8_matmul_scaled, int8_matmul_scaled_ref
from uniception_tpu_torch.parallel import comm

__all__ = [
    "Mesh",
    "P",
    "PartitionSpec",
    "make_mesh",
    "replicate_state",
    "RowParallel",
    "ColumnParallel",
    "tp_shard_state",
    "leaf_tp_spec",
    "leaf_data_spec",
    "data_dim",
    "data_slice",
    "zero1_shard_state",
    "fsdp_shard_state",
    "fsdp_release",
    "canonical_name",
    "shard_batch",
    "tree_map",
    "TP_RULES",
]


class PartitionSpec(tuple):
    "One entry per tensor dimension: the mesh axis it is split over, or None (``jax.sharding.PartitionSpec``)."

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """The world's ranks laid out on named axes: ``ranks`` an integer array holding every global rank once, one
    dimension per name in ``axis_names``. Every rank builds the same mesh (the process groups of every line of every
    axis are created collectively, in one order). ``shape`` maps each axis to its size, ``coords`` this rank's
    coordinate on it, ``device`` this rank's device."""

    def __init__(self, ranks, axis_names):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        world = comm.world_size()
        if ranks.ndim != len(axis_names) or sorted(ranks.ravel().tolist()) != list(range(world)):
            raise ValueError(f"mesh {ranks.shape} over {axis_names} must hold each of the {world} ranks once")
        self.ranks, self.axis_names = ranks, axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.device = comm.device()
        me = comm.rank()
        where = np.argwhere(ranks == me)[0]
        self.coords = {name: int(c) for name, c in zip(axis_names, where)}
        self._lines = {}
        for i, name in enumerate(axis_names):
            for line in np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i]).tolist():
                group = dist.new_group(line) if len(line) > 1 else comm.SOLO
                if me in line:
                    self._lines[name] = (group, line)

    def group(self, axis: str):
        "The process group of this rank's line along ``axis`` (``comm.SOLO`` for an axis of size 1)."
        return self._lines[axis][0]

    def members(self, axis: str) -> list:
        "The global ranks of this rank's line along ``axis``, in axis order."
        return self._lines[axis][1]

    def peer(self, axis: str, offset: int) -> int:
        "The global rank ``offset`` steps along ``axis`` from this one (cyclic)."
        line = self.members(axis)
        return line[(self.coords[axis] + offset) % len(line)]

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """Create a ("data", "model") mesh over the world's ranks (``devices``: the global ranks in mesh order, default
    all of them). data=-1 takes the ranks that remain. Consecutive ranks share a "model" line, so under torchrun a
    tensor-parallel group is the cards of one host."""
    ranks = list(range(comm.world_size())) if devices is None else list(devices)
    n = len(ranks)
    if data == -1:
        assert n % model == 0, f"{n} ranks not divisible by model={model}"
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} ranks"
    return Mesh(np.asarray(ranks).reshape(data, model), ("data", "model"))


# Tensor-parallel rules over the port's state-dict names; values are PartitionSpecs over the state tensor's dims.
# Column-parallel (shard output features): qkv, projq/k/v, fc1, w12. Row-parallel (shard input features): proj, fc2, w3.
TP_RULES = [
    (re.compile(r".*\b(qkv|projq|projk|projv)\.weight$"), P("model", None)),
    (re.compile(r".*\b(qkv|projq|projk|projv)\.bias$"), P("model")),
    (re.compile(r".*\b(fc1|w12)\.weight$"), P("model", None)),
    (re.compile(r".*\b(fc1|w12)\.bias$"), P("model")),
    (re.compile(r".*\battn\.proj\.weight$"), P(None, "model")),
    (re.compile(r".*\bcross_attn\.proj\.weight$"), P(None, "model")),
    (re.compile(r".*\b(fc2|w3)\.weight$"), P(None, "model")),
    # Int8Linear: w_q (in, out) int8 and the per-output-channel w_scale / w_colsum (1, out), as JAX keeps them.
    # Column-parallel scales shard with the output axis; a row-parallel layer's are per output and stay replicated,
    # and its w_colsum (from the full kernel) is added after the partial-sum reduce, like the bias.
    (re.compile(r".*\b(qkv|projq|projk|projv)\.w_q$"), P(None, "model")),
    (re.compile(r".*\b(qkv|projq|projk|projv)\.w_scale$"), P(None, "model")),
    (re.compile(r".*\b(qkv|projq|projk|projv)\.w_colsum$"), P(None, "model")),
    (re.compile(r".*\b(fc1|w12)\.w_q$"), P(None, "model")),
    (re.compile(r".*\b(fc1|w12)\.w_scale$"), P(None, "model")),
    (re.compile(r".*\b(fc1|w12)\.w_colsum$"), P(None, "model")),
    (re.compile(r".*\battn\.proj\.w_q$"), P("model", None)),
    (re.compile(r".*\bcross_attn\.proj\.w_q$"), P("model", None)),
    (re.compile(r".*\b(fc2|w3)\.w_q$"), P("model", None)),
]


def _spec_for(path: str, rules) -> P:
    for pattern, spec in rules:
        if pattern.match(path):
            return spec
    return P()  # replicated


def leaf_tp_spec(path: str, leaf, mesh: Mesh, rules=None) -> P:
    """The PartitionSpec of one state tensor under tensor parallelism: JAX's answer for the same leaf, over the
    tensor's own dims (a torch ``weight`` is the transpose of JAX's ``kernel``).

    path: the dotted state-dict key (a trailing '.value' is stripped, as from a flax path). A leaf with one more dim
    than its rule (a depth-stacked layout) shifts the rule right; a sharded dim the "model" axis does not divide
    falls back to replication."""
    rules = rules if rules is not None else TP_RULES
    if path.endswith(".value"):
        path = path[: -len(".value")]
    model_size = mesh.shape["model"]
    spec = _spec_for(path, rules)
    if len(spec) > 0 and getattr(leaf, "ndim", 0) == len(spec) + 1:
        spec = P(None, *spec)
    for dim, axis in enumerate(spec):
        if axis is not None and (dim >= getattr(leaf, "ndim", 0) or leaf.shape[dim] % model_size != 0):
            return P()
    return spec


def replicate_state(module: nn.Module, mesh: Mesh) -> nn.Module:
    "Every rank's ``module`` on its device with rank 0's parameters and buffers (one broadcast each); returns it."
    module.to(mesh.device)
    src = int(mesh.ranks.ravel()[0])
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            comm.broadcast(t.data, src)
    return module


def _state_weight(lin):
    """A linear layer's weight as its state dict names and holds it: ``weight`` (out, in), ``w_q`` (in, out), or a
    LoRA-wrapped layer's ``base.weight``, which no rule shards (JAX's rules match ``qkv.kernel``, not
    ``qkv.base.kernel``): under LoRA the wrapped layers and their adapters stay whole on every "model" rank."""
    if hasattr(lin, "w_q"):
        return "w_q", lin.w_q.t()
    if hasattr(lin, "lora_a"):
        return "base.weight", lin.base.weight
    return "weight", lin.weight


def _keep_outputs(lin, idx: torch.Tensor):
    "Column-parallel: keep output features ``idx`` of a Linear or Int8Linear."
    with torch.no_grad():
        if hasattr(lin, "w_q"):
            lin.w_q = lin.w_q[idx.to(lin.w_q.device)].contiguous()
            lin.w_scale = lin.w_scale[:, idx.to(lin.w_scale.device)].contiguous()
            if lin.w_colsum is not None:
                lin.w_colsum = lin.w_colsum[:, idx.to(lin.w_colsum.device)].contiguous()
            if lin.bias is not None:
                lin.bias = lin.bias[idx.to(lin.bias.device)].contiguous()
        else:
            lin.weight = nn.Parameter(lin.weight[idx.to(lin.weight.device)].contiguous(),
                                      requires_grad=lin.weight.requires_grad)
            if lin.bias is not None:
                lin.bias = nn.Parameter(lin.bias[idx.to(lin.bias.device)].contiguous(),
                                        requires_grad=lin.bias.requires_grad)
    lin.out_features = int(idx.numel())


class RowParallel(nn.Module):
    """A row-parallel layer under tensor parallelism: ``inner`` (a Linear or Int8Linear) holds this rank's share of
    the input features, and the ranks of ``group`` (the "model" axis) sum their partial products before the bias.

    A float layer's partial products are summed in fp32 and rounded once to its compute dtype. An int8 layer
    quantizes its share of each row with the whole row's statistics, as JAX's GSPMD reduces them over the sharded
    feature axis: the row abs-max (or max and min) is all-reduced over the group first. The ranks then sum their
    exact int32 partial products and dequantize once, in the unsharded layer's order of roundings (JAX's
    ``Int8Linear`` takes the int32 dot, then dequantizes), so the output is the unsharded layer's, bit for bit. In
    the symmetric dynamic mode K4 makes the codes from the given scales and their int32 product
    (``int8_matmul_scaled``). w_colsum's correction and the bias come after the reduce."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.inner, self.group = inner, group
        self.in_features, self.out_features = inner.in_features, inner.out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lin, group = self.inner, self.group
        if not hasattr(lin, "w_q"):
            dt = getattr(lin, "compute_dtype", None) or lin.weight.dtype
            y = comm.reduce_from(F.linear(x.to(dt), lin.weight.to(dt)), group)
            return y if lin.bias is None else y + lin.bias.to(dt)
        x2 = x.reshape(-1, lin.in_features)
        m = None
        if lin.a_scale is not None:
            a_scale = lin.a_scale
        elif lin.w_colsum is None:  # symmetric dynamic: the whole row's abs-max
            a_scale = absmax_scale(comm.all_reduce(x2.float().abs().amax(dim=-1, keepdim=True), "max", group))
        else:  # zero-point: the whole row's range, each token centred into the full int8 range
            mx = comm.all_reduce(x2.float().amax(dim=-1, keepdim=True), "max", group)
            mn = -comm.all_reduce(-x2.float().amin(dim=-1, keepdim=True), "max", group)
            m = (mx + mn) * 0.5
            a_scale = absmax_scale((mx - mn) * 0.5)
        if lin.a_scale is None and lin.w_colsum is None:
            fn = int8_matmul_scaled_ref if get_attention_impl() == "naive" else int8_matmul_scaled
            acc = fn(x2, a_scale, lin.w_q.t())
        else:
            xf = x2.float() if m is None else x2.float() - m
            acc = _int_mm(torch.round(xf / a_scale).clamp(-127, 127).to(torch.int8), lin.w_q.t())
        y = comm.all_reduce(acc, "sum", group).float() * (a_scale * lin.w_scale)
        if m is not None:
            y = y + m * lin.w_colsum
        if lin.bias is not None:
            y = y + lin.bias
        return y.to(x.dtype).reshape(*x.shape[:-1], lin.out_features)


class ColumnParallel(nn.Module):
    """A column-parallel layer under tensor parallelism: ``inner`` (a Linear or Int8Linear) holds this rank's share of
    the output features. The forward is ``inner``'s; the input's gradient is summed over ``group`` (the "model"
    axis), since each rank's output features give a share of it (``comm.copy_to``). Attributes the wrapper does not
    hold (``weight``, ``bias``, ``w_q``, ...) are ``inner``'s."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.inner, self.group = inner, group

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(super().__getattr__("inner"), name)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        "The layer's input as the kernels that read ``weight`` directly take it: its gradient summed over the group."
        return comm.copy_to(x, self.group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner(self.enter(x))


def _keep_inputs(lin, lo: int, hi: int, group) -> RowParallel:
    "Row-parallel: keep input features [lo, hi) of a Linear or Int8Linear, wrapped to reduce over ``group``."
    with torch.no_grad():
        if hasattr(lin, "w_q"):
            lin.w_q = lin.w_q[:, lo:hi].contiguous()
        else:
            lin.weight = nn.Parameter(lin.weight[:, lo:hi].contiguous(), requires_grad=lin.weight.requires_grad)
    lin.in_features = hi - lo
    return RowParallel(lin, group)


def _span(r: int, t: int, n: int):
    return r * n // t, (r + 1) * n // t


def _sections(n_sections: int, width: int, r: int, t: int) -> torch.Tensor:
    "Output rows of rank r's share of each of ``n_sections`` consecutive sections of ``width`` rows."
    lo, hi = _span(r, t, width)
    return torch.cat([s * width + torch.arange(lo, hi) for s in range(n_sections)])


def _record_tp(lin, names_dims, parts):
    """Record on a float layer, for each of its tensors ``names_dims`` ({name: dim}) sharded by tensor parallelism,
    the dim and the rows or columns of the whole tensor each rank of the "model" axis holds (``parts``, in axis
    order): ``lin.tp_layout`` = {name: (dim, parts)}, which training's gather and re-shard read."""
    if not hasattr(lin, "w_q"):
        lin.tp_layout = {n: (d, parts) for n, d in names_dims.items() if getattr(lin, n, None) is not None}


def tp_shard_state(module: nn.Module, mesh: Mesh, rules=None) -> nn.Module:
    """Shard ``module`` (in place) with the tensor-parallel rules over the mesh's "model" axis; returns it.

    Each attention module (``Attention``, ``CrossAttention``) keeps this rank's heads: q, k and v each by heads,
    ``proj`` the matching input columns; each MLP (``Mlp``, ``SwiGLUFFN``) its share of the hidden features. A module
    is sharded when every one of its layers' weights is sharded by :func:`leaf_tp_spec` (so a head count or hidden
    width that the axis does not divide stays replicated, as the divisibility fallback leaves it); everything else is
    replicated. Each row-parallel layer becomes a :class:`RowParallel` around it, each column-parallel one a
    :class:`ColumnParallel`; a float layer records which rows or columns of each whole tensor every rank holds
    (``tp_layout``, read by training's gathers). The module goes to the rank's device first."""
    from uniception_tpu_torch.nn.blocks import Attention, CrossAttention, Mlp, SwiGLUFFN

    rules = rules if rules is not None else TP_RULES
    module.to(mesh.device)
    t = mesh.shape["model"]
    if t == 1:
        return module
    r, group = mesh.coords["model"], mesh.group("model")
    for name, m in list(module.named_modules()):
        pre = f"{name}." if name else ""

        def ok(attr):  # the rules shard this layer's weight
            key, weight = _state_weight(getattr(m, attr))
            return any(a is not None for a in leaf_tp_spec(f"{pre}{attr}.{key}", weight, mesh, rules))

        if isinstance(m, (Attention, CrossAttention)):
            cols = ("qkv",) if isinstance(m, Attention) else ("projq", "projk", "projv")
            if m.num_heads % t or not all(ok(a) for a in cols + ("proj",)):
                continue
            width = m.num_heads * m.head_dim
            for a in cols:
                n_sec = 3 if a == "qkv" else 1
                lin = getattr(m, a)
                _keep_outputs(lin, _sections(n_sec, width, r, t))
                _record_tp(lin, {"weight": 0, "bias": 0}, [_sections(n_sec, width, i, t) for i in range(t)])
                setattr(m, a, ColumnParallel(lin, group))
            _record_tp(m.proj, {"weight": 1}, [torch.arange(*_span(i, t, width)) for i in range(t)])
            m.proj = _keep_inputs(m.proj, *_span(r, t, width), group)
            m.num_heads //= t
        elif isinstance(m, (Mlp, SwiGLUFFN)):
            col, row = ("fc1", "fc2") if isinstance(m, Mlp) else ("w12", "w3")
            if not (ok(col) and ok(row)) or getattr(m, row).in_features % t:
                continue
            hidden = getattr(m, row).in_features
            n_sec, lin = 1 if col == "fc1" else 2, getattr(m, col)
            _keep_outputs(lin, _sections(n_sec, hidden, r, t))
            _record_tp(lin, {"weight": 0, "bias": 0}, [_sections(n_sec, hidden, i, t) for i in range(t)])
            setattr(m, col, ColumnParallel(lin, group))
            _record_tp(getattr(m, row), {"weight": 1}, [torch.arange(*_span(i, t, hidden)) for i in range(t)])
            setattr(m, row, _keep_inputs(getattr(m, row), *_span(r, t, hidden), group))
    return module


def tree_map(fn, tree):
    "``fn`` on every tensor leaf of nested dicts, lists and tuples (None stays None)."
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of a global host batch (every rank passes the whole batch): the leading axis split in equal
    consecutive blocks over ``axis``, in axis order, on this rank's device."""
    n, i = mesh.shape[axis], mesh.coords[axis]

    def rows(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"shard_batch: {x.shape[0]} rows do not split over {n} ranks of {axis!r}")
        b = x.shape[0] // n
        return x[i * b : (i + 1) * b].to(mesh.device)

    return tree_map(rows, batch)


# --- the data axis: ZeRO-1 and FSDP ----------------------------------------------------------------------------


def canonical_name(name: str) -> str:
    """A parameter's name as the unsharded module holds it: the tensor-parallel wrappers' ``inner`` and FSDP's
    ``parametrizations.<name>.original`` taken out."""
    name = re.sub(r"(^|\.)parametrizations\.(\w+)\.original$", r"\1\2", name)
    return ".".join(p for p in name.split(".") if p != "inner")


def _jax_dims(path: str, ndim: int) -> list:
    """For each dim of a port tensor, the dim of the JAX leaf it is: a Linear's ``weight`` (out, in) is JAX's kernel
    (in, out); a conv's ``weight`` (out, in, *k) is JAX's (*k, in, out); everything else keeps its layout."""
    if path.endswith("weight") and ndim >= 2:
        return [ndim - 1, ndim - 2] + list(range(ndim - 2))
    return list(range(ndim))


def leaf_data_spec(path: str, leaf, mesh: Mesh, tp_spec=None) -> P:
    """The PartitionSpec of one tensor over the "data" axis (and the "model" axis it already has): JAX's
    ``_data_shard_largest_axis`` for the same leaf, in the tensor's own dims.

    JAX's rule, taken in JAX's layout: the largest axis that is not already sharded, that the data size divides and
    that is larger than 1 (the first such in JAX's dim order on a tie); scalars, indivisible leaves and a data axis
    of 1 keep ``tp_spec`` (None: replicated). ``leaf`` is the tensor (or anything with ``shape``); under tensor
    parallelism the rank's share, whose model dim ``tp_spec`` names."""
    shape = tuple(leaf.shape)
    ndim = len(shape)
    existing = list(tp_spec or ()) + [None] * (ndim - len(tp_spec or ()))
    data = mesh.shape["data"]
    if ndim == 0 or data == 1:
        return P(*existing)
    torch_dim = {j: d for d, j in enumerate(_jax_dims(path, ndim))}  # JAX dim -> port dim
    cands = [j for j in range(ndim)
             if existing[torch_dim[j]] is None and shape[torch_dim[j]] % data == 0 and shape[torch_dim[j]] > 1]
    if not cands:
        return P(*existing)
    existing[torch_dim[max(cands, key=lambda j: shape[torch_dim[j]])]] = "data"
    return P(*existing)


def data_dim(spec) -> "int | None":
    "The dim a spec splits over the data axis, or None."
    return next((d for d, a in enumerate(spec) if a == "data"), None)


def data_slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    "This rank's contiguous block of ``t`` along ``dim`` over the data axis (a view)."
    n = t.shape[dim] // mesh.shape["data"]
    return t.narrow(dim, mesh.coords["data"] * n, n)


def _tp_spec(owner, pname: str, ndim: int):
    layout = getattr(owner, "tp_layout", {}).get(pname)
    if layout is None:
        return None
    spec = [None] * ndim
    spec[layout[0]] = "model"
    return P(*spec)


def zero1_shard_state(state, mesh: Mesh, tp_specs=None):
    """ZeRO-1: this rank's share of a {name: tensor} state (the optimizer moments, named as their parameters) over
    the "data" axis. Each tensor keeps the block :func:`leaf_data_spec` gives this rank's data coordinate (a view);
    a tensor the rule leaves whole stays whole. ``tp_specs`` ({name: spec}) names the model dims tensor parallelism
    already split. Returns {name: (slice, dim or None)}."""
    out = {}
    for name, t in state.items():
        d = data_dim(leaf_data_spec(name, t, mesh, (tp_specs or {}).get(name)))
        out[name] = (t if d is None else data_slice(t, d, mesh), d)
    return out


_GATHERED = {}  # storage pointer of a gathered whole parameter -> (its _DataGather, the shard), while it lives


class _Gather(torch.autograd.Function):
    """The whole tensor from each rank's shard (an all-gather over the data axis). Backward: the whole tensor's
    gradient is added to the gather's ``grad`` (every use of the parameter in the step), and the data reduce and the
    slice come after the backward (``training``), as plain data parallelism reduces its gradients."""

    @staticmethod
    def forward(ctx, shard, gm):
        ctx.gm = gm
        return comm.all_gather(shard, gm.dim, gm.group)

    @staticmethod
    def backward(ctx, g):
        gm = ctx.gm
        gm.grad = g if gm.grad is None else gm.grad + g
        return None, None


class _DataGather(nn.Module):
    """FSDP's parametrization of one parameter: the module holds this rank's shard (``original``) and reads the whole
    tensor, gathered over the data axis at each read and released when the read's result is."""

    def __init__(self, dim: int, mesh: Mesh):
        super().__init__()
        self.dim, self.group = dim, mesh.group("data")
        self.grad = None  # the step's gradient of the whole tensor, summed over its uses, before the data reduce

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and shard.requires_grad:
            full = _Gather.apply(shard, self)
        else:
            full = comm.all_gather(shard, self.dim, self.group)
        key = full.untyped_storage().data_ptr()
        _GATHERED[key] = (self, shard)
        weakref.finalize(full, _GATHERED.pop, key, None)
        return full


def fsdp_shard_state(module: nn.Module, mesh: Mesh) -> nn.Module:
    """FSDP / ZeRO-3: keep only this rank's share of each parameter over the "data" axis (in place); returns the
    module.

    Each parameter that :func:`leaf_data_spec` splits (after tensor parallelism's own split, kept) is replaced by its
    block (``<owner>.parametrizations.<name>.original``) and read through a parametrization that all-gathers the whole
    tensor at each read: every layer gathers its weights when it runs, and the whole tensor is released once the
    layer's result no longer needs it (:func:`fsdp_release` re-gathers the ones a backward needs instead of keeping
    them). A gather's gradient is the whole tensor's; the train step reduces it over "data" and keeps its block.
    ``module.fsdp_leaves`` maps each split parameter's unsharded name to (parametrization, dim)."""
    from torch.nn.utils import parametrize

    leaves = {}
    for mname, owner in list(module.named_modules()):
        for pname, p in list(owner.named_parameters(recurse=False)):
            name = canonical_name(f"{mname}.{pname}" if mname else pname)
            d = data_dim(leaf_data_spec(name, p, mesh, _tp_spec(owner, pname, p.ndim)))
            if d is None:
                continue
            gm = _DataGather(d, mesh)
            with torch.no_grad():
                setattr(owner, pname, nn.Parameter(data_slice(p.detach(), d, mesh).clone(),
                                                   requires_grad=p.requires_grad))
            parametrize.register_parametrization(owner, pname, gm, unsafe=True)
            leaves[name] = (gm, d)
    module.fsdp_leaves = leaves
    return module


class _Regather:
    "A saved view of a gathered parameter, kept as its shard and gathered again when the backward reads it."

    def __init__(self, gm, shard, t):
        self.gm, self.shard = gm, shard
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()

    def get(self):
        full = comm.all_gather(self.shard.detach(), self.gm.dim, self.gm.group)
        return full.as_strided(self.size, self.stride, self.offset)


def _pack(t):
    hit = _GATHERED.get(t.untyped_storage().data_ptr()) if t.device.type != "meta" else None
    return t if hit is None else _Regather(hit[0], hit[1], t)


def _unpack(x):
    return x.get() if isinstance(x, _Regather) else x


@contextlib.contextmanager
def fsdp_release():
    """While open, a gathered parameter that the autograd graph saves for the backward (a fp32 layer's weight) is kept
    as its shard and gathered again when the backward reads it, so no whole parameter outlives its layer. (A bf16
    compute cast saves its own copy, as it does without FSDP.)"""
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield
