"""
Sharded inference (counterpart of uniception_tpu/parallel/inference.py).

A data-parallel (and optionally tensor-parallel) forward for DUSt3R-style
two-view models over a ("data", "model") mesh of ranks: the batch is split
over "data", the parameters are rank 0's on every rank (or, with ``use_tp``,
each rank's tensor-parallel share, parallel/mesh.py ``tp_shard_state``), and
the results of every "data" rank are gathered, so the caller holds the whole
batch's results as the JAX package's global array holds them.

Every serving kernel runs on each rank's own rows: the JAX package has to keep
its int8 matmul on XLA under a mesh (``force_xla_int8``: a Pallas call does not
partition); the port's K4 runs on each rank's shards, so it needs no such switch.
"""

from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from uniception_tpu_torch.parallel import comm
from uniception_tpu_torch.parallel.mesh import make_mesh, replicate_state, shard_batch, tp_shard_state, tree_map

__all__ = ["make_infer_fn", "InferContext"]


class InferContext:
    "Holds the mesh and the sharded forward."

    def __init__(self, mesh, infer):
        self.mesh = mesh
        self.infer = infer

    def shard(self, batch):
        "This rank's rows of a host batch (the same on every rank), split along the data axis, on its device."
        return shard_batch(batch, self.mesh)


def make_infer_fn(
    model: nn.Module,
    forward: Optional[Callable] = None,
    data: int = -1,
    model_axis: int = 1,
    use_tp: bool = False,
) -> Tuple[InferContext, Any]:
    """Build a dp(+tp) sharded inference fn for a DUSt3R-style model; every rank of the world calls it.

    Returns (context, params): ``params`` is the rank's module on its device, with rank 0's weights (broadcast)
    and, with ``use_tp`` and ``model_axis`` > 1, only its tensor-parallel share of them. The call signature is
    ``ctx.infer(params, img1, img2) -> (res1, res2)`` on this rank's rows (``ctx.shard((img1, img2))``); it returns
    the whole batch's results on every rank.

    forward: optional ``f(model, *inputs)`` override (defaults to ``model.forward_pair``).
    """
    mesh = make_mesh(data=data, model=model_axis)
    replicate_state(model, mesh)
    if use_tp and model_axis > 1:
        tp_shard_state(model, mesh)

    if forward is None:
        def forward(m, img1, img2):
            return m.forward_pair(img1, img2)

    group = mesh.group("data")

    @torch.inference_mode()
    def infer(params, *inputs):
        return tree_map(lambda t: comm.all_gather(t, 0, group), forward(params, *inputs))

    return InferContext(mesh, infer), model
