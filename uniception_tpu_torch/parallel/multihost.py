"""
Multi-process initialization (counterpart of uniception_tpu/parallel/multihost.py).

The JAX package runs one controller over every device of a pod; the port runs
one process per rank (``torch.distributed``), so initialization joins this
process to the world's process group and picks its device. The global
("data", "model") mesh and the assembly of a batch from each process's own
rows follow.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from uniception_tpu_torch.parallel import comm
from uniception_tpu_torch.parallel.mesh import Mesh, make_mesh, tree_map

__all__ = ["initialize_multihost", "global_mesh", "shard_local_batch"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Optional[str] = None,
):
    """Join this process to the world's process group.

    Without arguments the world comes from torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``); else from ``coordinator_address`` ("host:port" or an init-method URL such as
    ``tcp://localhost:29500``), ``num_processes`` and ``process_id``.

    ``device`` "cuda" (the default) puts the rank on card ``LOCAL_RANK`` (else ``process_id``) modulo the cards
    visible, and raises without one; "cpu" keeps it on the CPU. ``backend`` is the caller's choice, else it follows
    the device: "nccl" for a card (one rank per card), "gloo" for the CPU. Under gloo a rank's CUDA tensors cross
    through pinned host buffers (parallel/comm.py); NCCL refuses two ranks on one card.
    """
    device = device or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_multihost: no CUDA device (pass device='cpu' to run the ranks on the CPU)")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if coordinator_address is None:
        init_method, world, rank = "env://", None, None
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    else:
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank, local = num_processes, process_id, int(os.environ.get("LOCAL_RANK", process_id))
    if device == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    kwargs = {} if world is None else dict(world_size=world, rank=rank)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    comm.init(dev)
    if dist.get_rank() == 0:
        print(f"torch.distributed initialized: {dist.get_world_size()} processes, backend {backend}, device "
              f"{dev.type} ({comm.transport()})")


def global_mesh(model_axis: int = 1) -> Mesh:
    """The global ("data", "model") mesh over every rank of the world; "model" is the minor axis, so a
    tensor-parallel group is a block of consecutive ranks (the cards of one host under torchrun)."""
    return make_mesh(data=-1, model=model_axis)


def shard_local_batch(batch, mesh: Mesh, axis: str = "data"):
    """This process's rows as its share of the global batch along ``axis``.

    The counterpart of ``mesh.shard_batch`` where each process has loaded only its own rows: nothing moves between
    ranks, each rank's tensors go to its device. Every rank must pass the same number of rows (checked with one
    all-reduce over the axis), as the JAX version requires. Returns the tensors on this rank's device.
    """
    leaves = []
    tree_map(lambda x: leaves.append(torch.as_tensor(x)), batch)
    rows = torch.tensor([leaves[0].shape[0] if leaves else 0], dtype=torch.int64, device=comm.device())
    hi = comm.all_reduce(rows, "max", mesh.group(axis))
    lo = -comm.all_reduce(-rows, "max", mesh.group(axis))
    if int(hi) != int(lo) or any(x.shape[0] != leaves[0].shape[0] for x in leaves):
        raise ValueError(f"shard_local_batch: ranks passed {int(lo)} to {int(hi)} rows; each must pass the same")
    return tree_map(lambda x: torch.as_tensor(x).to(comm.device()), batch)
