"""
The process-group plumbing the multi-GPU modules share: one process per rank,
``torch.distributed``, explicit collectives.

    * :func:`init` / :func:`device`: this rank's process group and device,
      recorded once by ``multihost.initialize_multihost``;
    * :func:`all_reduce`, :func:`all_gather`, :func:`broadcast` and
      :class:`Exchange` (a send to one peer and a receive from another, started
      together): the collectives, each counted in :data:`calls` and wrapped in a
      ``comm::<name>`` profiler span;
    * :func:`reduce_from` and :func:`copy_to`: Megatron's pair of tensor-parallel
      operators with their gradients (a sum forward and the identity backward, the
      identity forward and a sum backward);
    * :func:`spawn`: start a world of rank processes (``spawn``, never ``fork``)
      on this host and collect what each returns.

The transport follows the process group's backend. Under NCCL every tensor
moves as it lies on the card. Under gloo a CPU tensor moves as it lies, and a
CUDA tensor is copied into a pinned host buffer, moved by gloo, and copied
back: that staging is how gloo carries a card's tensors (:func:`transport`
names it), so a world of several ranks on one card runs its kernels on the card
and its collectives through the host. Sums are taken in fp32 and rounded once
to the tensor's dtype; 2-byte floats move as their bytes.
"""

import collections
import socket
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["init", "device", "backend", "rank", "world_size", "transport", "calls", "all_reduce", "all_gather",
           "broadcast", "Exchange", "reduce_from", "copy_to", "spawn", "SOLO"]

_DEVICE: Optional[torch.device] = None
_AS_BYTES = (torch.bfloat16, torch.float16)  # gloo has no 2-byte integer type and no bf16: such data moves as bytes
SOLO = "solo"  # the group of a mesh line of one rank: every collective over it returns its input
calls = collections.Counter()  # collective calls by name ("all_reduce", "all_gather", "broadcast", "exchange")


def init(dev: torch.device):
    "Record this rank's device (``multihost.initialize_multihost`` calls it after ``init_process_group``)."
    global _DEVICE
    _DEVICE = torch.device(dev)


def device() -> torch.device:
    """This rank's device: the one ``initialize_multihost`` recorded, else (a process group initialised directly,
    as under torchrun with ``init_process_group``) the backend's own: the current card under NCCL, the CPU under
    gloo. Raises without a process group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize_multihost first")
    if _DEVICE is not None:
        return _DEVICE
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def backend() -> str:
    return dist.get_backend()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def transport() -> str:
    "How this rank's tensors move: the backend, and for gloo with a CUDA device the pinned host staging."
    b, dev = backend(), device()
    if b == "gloo" and dev.type == "cuda":
        return "gloo, CUDA tensors staged through pinned host buffers"
    return f"{b}, tensors moved as they lie on {dev.type}"


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    "The tensor gloo or NCCL moves: contiguous, 2-byte floats as their bytes, a CUDA tensor on pinned host memory."
    w = t.contiguous()
    if w.dtype in _AS_BYTES:
        w = w.reshape(-1).view(torch.uint8)
    if _staged(w):
        host = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
        host.copy_(w)
        return host
    return w


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    "A received wire tensor as a tensor of ``like``'s dtype and shape on its device."
    if w.device != like.device:
        w = w.to(like.device, non_blocking=True)
    return w.view(like.dtype).reshape(like.shape) if w.dtype != like.dtype else w


def _span(name):
    calls[name] += 1
    return torch.profiler.record_function(f"comm::{name}")


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The reduction of ``t`` over ``group`` ("sum" or "max"; a float tensor in fp32, rounded once to its dtype), as a
    new tensor."""
    if group is SOLO:
        return t.clone()
    with _span("all_reduce"):
        work = t.float() if t.is_floating_point() else t
        w = _wire(work)
        if w is t:
            w = w.clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=group)
        return _unwire(w, work).to(t.dtype)


def all_gather(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    "Every rank's ``t`` of ``group`` concatenated along ``dim`` in the group's rank order (equal shapes)."
    if group is SOLO:
        return t
    with _span("all_gather"):
        w = _wire(t)
        parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, w, group=group)
        return torch.cat([_unwire(p, t) for p in parts], dim=dim)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    "``t`` of global rank ``src`` on every rank of ``group``, written into ``t`` in place; returns ``t``."
    if group is SOLO:
        return t
    with _span("broadcast"):
        w = _wire(t)
        dist.broadcast(w, src=src, group=group)
        if w.data_ptr() != t.data_ptr():
            t.copy_(_unwire(w, t))
        return t


class Exchange:
    """Send ``send`` tensors to global rank ``dst`` and receive tensors shaped like ``recv_like`` from global rank
    ``src``, started at construction (``batch_isend_irecv``); :meth:`wait` gives the received tensors on ``recv_like``'s
    device. ``dst`` or ``src`` None leaves that side out. The compute enqueued between the two overlaps the transfer."""

    def __init__(self, send: Sequence[torch.Tensor], dst: Optional[int], recv_like: Sequence[torch.Tensor],
                 src: Optional[int], group=None):
        with _span("exchange"):
            self._like = list(recv_like) if src is not None else []
            self._send = [_wire(t) for t in send] if dst is not None else []
            self._recv = [_wire_shape(t) for t in self._like]
            ops = [dist.P2POp(dist.isend, w, dst, group) for w in self._send]
            ops += [dist.P2POp(dist.irecv, w, src, group) for w in self._recv]
            self._works = dist.batch_isend_irecv(ops) if ops else []

    def wait(self):
        with torch.profiler.record_function("comm::exchange_wait"):
            for w in self._works:
                w.wait()
            return [_unwire(w, t) for w, t in zip(self._recv, self._like)]


class _ReduceFrom(torch.autograd.Function):
    "The sum over ``group`` forward; the identity backward: each rank's partial product gets the whole gradient."

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    "The identity forward; the sum over ``group`` backward: the input's gradient adds every rank's share."

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's output: the sum of the ranks' partial products over ``group``. Its gradient is the
    identity (every rank's partial product gets the whole output gradient)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _ReduceFrom.apply(t, group)
    return all_reduce(t, "sum", group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel layer's input: the tensor itself forward; backward its gradient summed over ``group`` (each
    rank's output features give a share of it). Without a gradient to carry it returns ``t`` and calls nothing."""
    if torch.is_grad_enabled() and t.requires_grad and group is not SOLO:
        return _CopyTo.apply(t, group)
    return t


def _wire_shape(t: torch.Tensor) -> torch.Tensor:
    "An empty tensor of the wire dtype, shape and placement that :func:`_wire` gives for ``t`` (its data unset)."
    dt, shape = t.dtype, t.shape
    if dt in _AS_BYTES:
        dt, shape = torch.uint8, (t.numel() * t.element_size(),)
    if _staged(t):
        return torch.empty(shape, dtype=dt, pin_memory=True)
    return torch.empty(shape, dtype=dt, device=t.device)


def _free_port() -> int:
    "A TCP port on localhost that nothing listens on now."
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy_tree(x):
    "Torch tensors inside nested lists, tuples and dicts as numpy arrays (bf16 widened to fp32)."
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy_tree(v) for v in x)
    return x


def _rank_main(fn, rank_id, world, address, backend_name, dev, threads, args, queue):
    "One rank process: join the world, run ``fn(*args)``, put (rank, ok, result or traceback) on the queue."
    try:
        if threads:
            torch.set_num_threads(threads)
        from uniception_tpu_torch.parallel.multihost import initialize_multihost

        initialize_multihost(address, world, rank_id, backend=backend_name, device=dev)
        out = _numpy_tree(fn(*args))
        queue.put((rank_id, True, out))
    except BaseException:  # the parent raises it
        queue.put((rank_id, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass


def spawn(fn: Callable, world: int, *args, backend: Optional[str] = None, device: str = "cuda", threads: int = 0,
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` new rank processes of this host (multiprocessing's ``spawn``, so ``fn`` and
    ``args`` pickle; ``fn`` lives in a module the ranks import), each joined to one process group over
    ``tcp://localhost:<free port>`` with ``backend`` and ``device``. ``device`` "cuda" (the default) puts rank r on
    card r % count and raises here without a card; "cpu" keeps the ranks on the CPU. ``backend`` None follows the
    device, as ``initialize_multihost`` does. Returns the ranks' results in rank order, tensors as numpy arrays. A
    rank that raises, or a world that outlasts ``timeout`` seconds, stops every rank and raises here. ``threads`` > 0
    sets each rank's torch CPU threads."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn: no CUDA device (pass device='cpu' to run the ranks on the CPU)")

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    address = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, address, backend, device, threads, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                r, ok, out = q.get(timeout=max(0.1, min(5.0, deadline - time.monotonic())))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"rank processes failed or timed out (exit codes {dead}, "
                                       f"{len(results)}/{world} results)")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{out}")
            results[r] = out
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
    return [results[r] for r in range(world)]
