"""
Pipeline parallelism (GPipe-style) over a stack of transformer blocks
(counterpart of uniception_tpu/parallel/pipeline.py).

The JAX package shards the depth axis of its scan layout over a mesh "stage"
axis and runs a static schedule inside one ``shard_map``. The port keeps the
loop layout (a list of blocks), and one process per rank: the ranks of a
"stage" line each keep depth/S consecutive blocks (:func:`shard_stacked_state`),
and microbatches go stage to stage by send and receive on the JAX package's
static schedule (step t runs microbatch t - s on stage s; bubble fraction
(S-1)/(M+S-1)). The last stage's outputs reach every rank. A "data" axis splits
each microbatch's rows (pp x dp), a "model" axis shards each stage's blocks by
tensor parallelism (pp x tp, parallel/mesh.py ``tp_shard_state``).

Under autograd every stage keeps each microbatch's graph, and the backward is
the reverse schedule: the stage takes its outputs' gradient from stage s + 1
(the last stage its rows of the output gradient: every rank computes the same
loss, so the broadcast's gradient is one copy, not a sum over the stages), runs
backward and sends its input gradient to stage s - 1. The parameter gradients
add up over the microbatches and over "data".

Usage:
    mesh = Mesh(np.arange(world).reshape(S, D), ("stage", "data"))
    shard_stacked_state(blocks, mesh)
    out = pipeline_blocks(blocks, x, pos, mesh=mesh, data_axis="data", num_microbatches=4)
"""

from typing import Optional, Sequence

import torch
from torch import nn

from uniception_tpu_torch.parallel import comm
from uniception_tpu_torch.parallel.mesh import Mesh, tp_shard_state

__all__ = ["pipeline_blocks", "shard_stacked_state"]


def _stage_slice(depth: int, mesh: Mesh, stage_axis: str) -> slice:
    S = mesh.shape[stage_axis]
    assert depth % S == 0, f"depth {depth} not divisible by {S} stages"
    per = depth // S
    s = mesh.coords[stage_axis]
    return slice(s * per, (s + 1) * per)


def shard_stacked_state(stacked: nn.ModuleList, mesh: Mesh, stage_axis: str = "stage",
                        model_axis: Optional[str] = None) -> None:
    """Keep only this rank's stage of ``stacked`` (in place): its depth/S blocks go to the rank's device, the other
    stages' blocks are replaced by empty placeholders, so a rank holds depth/S blocks in memory.

    model_axis: also shard the kept blocks with the tensor-parallel rules over that axis (pp x tp); it must be
    named "model", the axis the rules name."""
    mine = _stage_slice(len(stacked), mesh, stage_axis)
    if model_axis is not None:
        assert model_axis == "model", "TP_RULES specs name the axis 'model'"
    for i in range(len(stacked)):
        if mine.start <= i < mine.stop:
            stacked[i].to(mesh.device)
            if model_axis is not None:
                tp_shard_state(stacked[i], mesh)
        else:
            stacked[i] = nn.Identity()


class _Plan:
    "One pipeline call: the rank's stage, blocks, microbatches and the rows of each that are this rank's."

    def __init__(self, stacked, x, broadcast_args, mesh, stage_axis, data_axis, num_microbatches):
        self.mesh, self.stage_axis, self.data_axis = mesh, stage_axis, data_axis
        self.S, self.s = mesh.shape[stage_axis], mesh.coords[stage_axis]
        self.mine = list(stacked)[_stage_slice(len(stacked), mesh, stage_axis)]
        self.batch = x.shape[0]
        self.M = num_microbatches or self.S
        assert self.batch % self.M == 0, f"batch {self.batch} not divisible by {self.M} microbatches"
        self.mb = self.batch // self.M
        self.d, self.di = 1, 0
        if data_axis is not None:
            self.d, self.di = mesh.shape[data_axis], mesh.coords[data_axis]
            assert self.mb % self.d == 0, f"microbatch {self.mb} not divisible by data axis {self.d}"
        self.rows = self.mb // self.d
        self.args = broadcast_args
        self.group = mesh.group(stage_axis)
        self.nxt, self.prv = mesh.peer(stage_axis, 1), mesh.peer(stage_axis, -1)
        self.saved = {}  # microbatch -> (stage input, stage output), the graphs a backward runs

    def local(self, a, m):  # this rank's rows of microbatch m
        lo = m * self.mb + self.di * self.rows
        return a[lo : lo + self.rows].to(self.mesh.device)

    def stage(self, h, m):
        args = tuple(self.local(a, m) for a in self.args)
        for blk in self.mine:
            h = blk(h, *args)
        return h

    def forward(self, x, keep: bool):
        """The static schedule (step t runs microbatch t - s on stage s); the last stage's outputs on every rank.
        With ``keep`` each microbatch's graph is kept for :meth:`backward`."""
        S, s, M = self.S, self.s, self.M
        like = self.local(x, 0)
        outs, sends = [], []
        for t in range(M + S - 1):
            m = t - s
            if not 0 <= m < M:
                continue
            h = self.local(x, m) if s == 0 else comm.Exchange([], None, [like], self.prv, self.group).wait()[0]
            if keep:
                h = h.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self.stage(h, m)
                self.saved[m] = (h, y)
                y = y.detach()
            else:
                y = self.stage(h, m)
            if s < S - 1:
                sends.append(comm.Exchange([y], self.nxt, [], None, self.group))
            else:
                outs.append(y)
        for pending in sends:
            pending.wait()
        out = torch.cat(outs) if s == S - 1 else like.new_empty((M * self.rows, *like.shape[1:]))
        out = comm.broadcast(out, self.mesh.members(self.stage_axis)[-1], self.group)
        return self._gather(out, x.shape)

    def _gather(self, out, shape):
        "(M, rows) blocks of every data coordinate in the batch's order, as a (batch, ...) tensor."
        if self.data_axis is not None:  # (d, M, rows) -> (M, d * rows)
            out = comm.all_gather(out.reshape(self.M, self.rows, *out.shape[1:]), 1, self.mesh.group(self.data_axis))
        return out.reshape(shape)

    def backward(self, dout, params):
        """The reverse schedule: the last stage takes its rows of the output gradient (every rank computes the same
        loss, so one copy of it, not a sum over the stages), each stage runs its microbatches' graphs backward in
        reverse order and sends the input gradient to the stage before. The parameter gradients add up over the
        microbatches (and over "data"); the first stage's input gradients reach every rank as the outputs did."""
        S, s, M = self.S, self.s, self.M
        grads = [None] * len(params)
        dxs, sends = [], []
        for m in reversed(range(M)):
            h, y = self.saved.pop(m)
            if s == S - 1:
                dy = self.local(dout, m).to(y.dtype)
            else:
                dy = comm.Exchange([], None, [y], self.nxt, self.group).wait()[0]
            got = torch.autograd.grad(y, [h] + params, dy, allow_unused=True)
            grads = [g if a is None else (a if g is None else g + a) for g, a in zip(grads, got[1:])]
            if s > 0:
                sends.append(comm.Exchange([got[0]], self.prv, [], None, self.group))
            else:
                dxs.insert(0, got[0])
        for pending in sends:
            pending.wait()
        if self.data_axis is not None:
            group = self.mesh.group(self.data_axis)
            grads = [None if g is None else comm.all_reduce(g, "sum", group) for g in grads]
        like = dout[: self.rows]
        dx = torch.cat(dxs) if s == 0 else like.new_empty((M * self.rows, *like.shape[1:]))
        dx = comm.broadcast(dx.to(like.dtype), self.mesh.members(self.stage_axis)[0], self.group)
        return self._gather(dx, dout.shape), grads


class _Pipeline(torch.autograd.Function):
    "The pipeline with its gradient: inputs x and the rank's stage parameters."

    @staticmethod
    def forward(ctx, plan, x, *params):
        ctx.plan, ctx.n = plan, len(params)
        ctx.save_for_backward(*params)
        return plan.forward(x, keep=True)

    @staticmethod
    def backward(ctx, dout):
        dx, grads = ctx.plan.backward(dout.contiguous(), list(ctx.saved_tensors))
        return (None, dx, *grads)


def pipeline_blocks(
    stacked: Sequence[nn.Module],
    x: torch.Tensor,
    *broadcast_args,
    mesh: Mesh,
    stage_axis: str = "stage",
    data_axis: Optional[str] = None,
    model_axis: Optional[str] = None,
    num_microbatches: Optional[int] = None,
):
    """Run the blocks of ``stacked`` (``blk(x, *args)`` in order) as a GPipe pipeline; every rank of the mesh calls
    it with the same whole ``x``.

    x: (B, ...) activations; B must divide by num_microbatches (default: the stage count).
    broadcast_args: extra per-sample block inputs (e.g. RoPE positions (B, N, 2)), microbatched alongside x.
    data_axis: split each microbatch's rows over this axis (pp x dp); the stage-to-stage transfers and the final
        gather act per data coordinate.
    model_axis: the stage's blocks are tensor-parallel over this axis (shard them with
        ``shard_stacked_state(..., model_axis="model")``); activations are the same on its ranks.
    Returns the (B, ...) output on every rank, equal to running the blocks in a loop.

    Under autograd (grad mode on, and x or a parameter of the rank's stage requiring a gradient) every stage keeps
    each microbatch's graph, and the backward runs the reverse schedule (``_Plan.backward``): each rank's stage
    parameters get the gradient of its (replicated) loss, summed over the microbatches and over ``data_axis``, and
    x the whole input gradient on every rank.
    """
    plan = _Plan(stacked, x, broadcast_args, mesh, stage_axis, data_axis, num_microbatches)
    params = [p for blk in plan.mine for p in blk.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _Pipeline.apply(plan, x, *params)
    with torch.no_grad():
        return plan.forward(x, keep=False)
