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
    """
    S = mesh.shape[stage_axis]
    s = mesh.coords[stage_axis]
    mine = list(stacked)[_stage_slice(len(stacked), mesh, stage_axis)]
    batch = x.shape[0]
    M = num_microbatches or S
    assert batch % M == 0, f"batch {batch} not divisible by {M} microbatches"
    mb = batch // M
    d, di = 1, 0
    if data_axis is not None:
        d, di = mesh.shape[data_axis], mesh.coords[data_axis]
        assert mb % d == 0, f"microbatch {mb} not divisible by data axis {d}"
    rows = mb // d

    def local(a, m):  # this rank's rows of microbatch m
        return a[m * mb + di * rows : m * mb + (di + 1) * rows].to(mesh.device)

    def stage(h, m):
        args = tuple(local(a, m) for a in broadcast_args)
        for blk in mine:
            h = blk(h, *args)
        return h

    group = mesh.group(stage_axis)
    nxt, prv = mesh.peer(stage_axis, 1), mesh.peer(stage_axis, -1)
    like = local(x, 0)
    outs, sends = [], []
    with torch.no_grad():
        # static schedule: step t runs microbatch t - s on stage s
        for t in range(M + S - 1):
            m = t - s
            if not 0 <= m < M:
                continue
            h = local(x, m) if s == 0 else comm.Exchange([], None, [like], prv, group).wait()[0]
            y = stage(h, m)
            if s < S - 1:
                sends.append(comm.Exchange([y], nxt, [], None, group))
            else:
                outs.append(y)
        for pending in sends:
            pending.wait()
        out = torch.cat(outs) if s == S - 1 else torch.empty((M * rows, *like.shape[1:]), dtype=like.dtype,
                                                               device=mesh.device)
        out = comm.broadcast(out, mesh.members(stage_axis)[-1], group)  # the last stage's outputs on every stage
        if data_axis is not None:  # (d, M, rows) -> (M, d * rows) in the batch's order
            out = comm.all_gather(out.reshape(M, rows, *out.shape[1:]), 1, mesh.group(data_axis))
    return out.reshape(batch, *x.shape[1:])
