"""
Ring attention: sequence-parallel exact attention over a mesh axis
(counterpart of uniception_tpu/parallel/ring_attention.py).

The token axis of q, k and v is split over the ranks of one mesh axis. Each
rank keeps its queries, and the key/value chunks rotate around the ring: at
step s rank i holds chunk (i - s) mod n, sends it to rank i + 1 and receives
the next from rank i - 1 (``batch_isend_irecv``, started before the step's
attention so the transfer overlaps it). Each chunk runs K1 with its logsumexp
(ops/flash_attention.py ``flash_attention_fwd(..., with_lse=True)``; a CPU
tensor takes the plain ``flash_attention_lse_ref``), and the partial results
are combined in fp32 by their logsumexps:

    lse = logaddexp(lse_a, lse_b),  out = out_a exp(lse_a - lse) + out_b exp(lse_b - lse)

which is the function of the JAX package's (acc, m, l) online-softmax
recurrence (its :57-69): both are softmax over every key. What differs is the
rounding: each chunk's output leaves K1 in q's dtype (bf16 rounds it once
more) before the fp32 combine. The full (V*T)^2 score matrix never exists on
one rank, and no einsum runs on the card's path.

Gradients (:class:`RingAttentionFunction`): the forward saves the combined
output (in q's dtype) and the global logsumexp, and the backward is a second
ring. At each step the rank runs K3 (``flash_attention_bwd``; a CPU tensor
takes ``flash_attention_bwd_ref``) on its queries and the chunk it holds, with
the global output and logsumexp: K3 takes delta from O . dO and p from the
global logsumexp, so each call gives exactly that chunk's share of dq, dk and
dv. dq adds up on the rank; the dk/dv partials travel with their K/V chunk and
reach their home rank after the last step. The partials leave K3 in q's dtype
and are added in fp32 (one more rounding of each partial in bf16), then
rounded once to q's dtype.
"""

from typing import Optional

import torch

from uniception_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_lse_ref,
)
from uniception_tpu_torch.parallel import comm

__all__ = ["ring_attention", "ring_attention_sharded", "combine_lse", "RingAttentionFunction"]


def combine_lse(out_a: torch.Tensor, lse_a: torch.Tensor, out_b: torch.Tensor, lse_b: torch.Tensor):
    """Attention over two key sets from each one's (out (B, N, H, D), lse (B, H, N)): (fp32 out, fp32 lse)."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse).transpose(1, 2).unsqueeze(-1)
    wb = torch.exp(lse_b - lse).transpose(1, 2).unsqueeze(-1)
    return out_a.float() * wa + out_b.float() * wb, lse


def _ring_forward(q, k, v, scale, mesh, axis_name, impl):
    "(out in q's dtype, fp32 lse (B, H, N_local)) of this rank's queries against every rank's chunk."
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    nxt, prv = mesh.peer(axis_name, 1), mesh.peer(axis_name, -1)
    kc, vc = k, v
    out = lse = None
    for step in range(n):
        pending = comm.Exchange([kc, vc], nxt, [kc, vc], prv, group) if step < n - 1 else None
        if impl == "naive":
            o, l = flash_attention_lse_ref(q, kc, vc, scale)
        else:
            o, l = flash_attention_fwd(q, kc, vc, scale, with_lse=True)
        out, lse = (o.float(), l) if out is None else combine_lse(out, lse, o, l)
        if pending is not None:
            kc, vc = pending.wait()
    return out.to(q.dtype), lse.contiguous()


def _ring_backward(q, k, v, out, lse, dout, scale, mesh, axis_name, impl):
    """(dq, dk, dv) of this rank's shards: K3 on each chunk from the global out and lse; dq summed here, each chunk's
    dk/dv partials summed in fp32 as they travel with it, home after the last step."""
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    nxt, prv = mesh.peer(axis_name, 1), mesh.peer(axis_name, -1)
    bwd = flash_attention_bwd_ref if impl == "naive" else flash_attention_bwd
    dout = dout.contiguous()
    kc, vc = k, v
    dq = dk = dv = None
    for step in range(n):
        gq, gk, gv = bwd(q, kc, vc, out, lse, dout, scale)
        dq = gq.float() if dq is None else dq + gq.float()
        dk = gk.float() if dk is None else dk + gk.float()
        dv = gv.float() if dv is None else dv + gv.float()
        if n == 1:
            break
        # the chunk and its partials go on to the next rank; after the last step only the partials, home
        send = [kc, vc, dk, dv] if step < n - 1 else [dk, dv]
        kc, vc, dk, dv = ([None, None] if step == n - 1 else []) + comm.Exchange(send, nxt, send, prv, group).wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttentionFunction(torch.autograd.Function):
    """:func:`ring_attention` with its gradient: the forward (K1 with its logsumexp on each chunk, the fp32 combine)
    saves the output in q's dtype and the global logsumexp; the backward is the second ring of K3 calls."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mesh, axis_name, impl):
        out, lse = _ring_forward(q, k, v, scale, mesh, axis_name, impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, mesh, axis_name, impl)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, axis_name: str, scale: Optional[float] = None, *, mesh, impl: str = "kernel"):
    """Exact attention with the token axis split over ``axis_name`` of ``mesh``.

    q, k, v: this rank's (B, N_local, H, D) shards (the token chunk of its coordinate on the axis). Returns its
    (B, N_local, H, D) output shard in q's dtype. ``impl`` "naive" runs the plain versions on every chunk. The
    gradients (:class:`RingAttentionFunction`) of the shards are those of the sum of every rank's loss, as JAX's
    ``shard_map`` gives them (each rank's dk/dv adds every rank's queries' share)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return RingAttentionFunction.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale, mesh, axis_name, impl)


class _ShardedRing(torch.autograd.Function):
    """The whole q, k, v on every rank -> the whole output on every rank. Backward: every rank computes the same
    loss, so its output gradient is one copy of dO, not a sum: the rank takes its slice of dO, runs the ring's
    backward, and the chunks' dq, dk and dv are gathered over the axis."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mesh, axis_name, impl):
        n, i = mesh.shape[axis_name], mesh.coords[axis_name]
        nq, nk = q.shape[1] // n, k.shape[1] // n
        ql, kl, vl = (t[:, i * m : (i + 1) * m].contiguous() for t, m in ((q, nq), (k, nk), (v, nk)))
        out, lse = _ring_forward(ql, kl, vl, scale, mesh, axis_name, impl)
        ctx.save_for_backward(ql, kl, vl, out, lse)
        ctx.args = (scale, mesh, axis_name, impl)
        return comm.all_gather(out, dim=1, group=mesh.group(axis_name))

    @staticmethod
    def backward(ctx, dout):
        ql, kl, vl, out, lse = ctx.saved_tensors
        scale, mesh, axis_name, impl = ctx.args
        n, i = mesh.shape[axis_name], mesh.coords[axis_name]
        nq = ql.shape[1]
        dq, dk, dv = _ring_backward(ql, kl, vl, out, lse, dout[:, i * nq : (i + 1) * nq], scale, mesh, axis_name,
                                    impl)
        group = mesh.group(axis_name)
        return (*(comm.all_gather(g, dim=1, group=group) for g in (dq, dk, dv)), None, None, None, None)


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "data", scale: Optional[float] = None,
                           impl: str = "kernel"):
    """Every rank passes the whole (B, N, H, D) q, k and v (the same on every rank of the axis) and gets the whole
    output: each takes its token chunk, runs the ring (:class:`_ShardedRing`), and the chunks are gathered over the
    axis. With a gradient, each rank gets the whole dq, dk and dv of its (replicated) loss."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _ShardedRing.apply(q, k, v, scale, mesh, axis_name, impl)
