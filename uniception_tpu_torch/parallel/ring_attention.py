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

Gradients through the ring are the training half of multi-GPU (ROADMAP queue 1
item 12): a call that needs one raises.
"""

from typing import Optional

import torch

from uniception_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_lse_ref
from uniception_tpu_torch.parallel import comm

__all__ = ["ring_attention", "ring_attention_sharded", "combine_lse"]


def combine_lse(out_a: torch.Tensor, lse_a: torch.Tensor, out_b: torch.Tensor, lse_b: torch.Tensor):
    """Attention over two key sets from each one's (out (B, N, H, D), lse (B, H, N)): (fp32 out, fp32 lse)."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse).transpose(1, 2).unsqueeze(-1)
    wb = torch.exp(lse_b - lse).transpose(1, 2).unsqueeze(-1)
    return out_a.float() * wa + out_b.float() * wb, lse


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def ring_attention(q, k, v, axis_name: str, scale: Optional[float] = None, *, mesh, impl: str = "kernel"):
    """Exact attention with the token axis split over ``axis_name`` of ``mesh``.

    q, k, v: this rank's (B, N_local, H, D) shards (the token chunk of its coordinate on the axis). Returns its
    (B, N_local, H, D) output shard in q's dtype. ``impl`` "naive" runs the plain version on every chunk."""
    if _needs_grad(q, k, v):
        raise NotImplementedError("gradients through ring attention are the training half of multi-GPU: "
                                  "ROADMAP queue 1 item 12")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    nxt, prv = mesh.peer(axis_name, 1), mesh.peer(axis_name, -1)
    q, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
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
    return out.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "data", scale: Optional[float] = None,
                           impl: str = "kernel"):
    """Every rank passes the whole (B, N, H, D) q, k and v (the same on every rank of the axis) and gets the whole
    output: each takes its token chunk, runs :func:`ring_attention`, and the chunks are gathered over the axis."""
    n, i = mesh.shape[axis_name], mesh.coords[axis_name]
    nq, nk = q.shape[1] // n, k.shape[1] // n
    local = ring_attention(q[:, i * nq : (i + 1) * nq], k[:, i * nk : (i + 1) * nk], v[:, i * nk : (i + 1) * nk],
                           axis_name, scale, mesh=mesh, impl=impl)
    return comm.all_gather(local, dim=1, group=mesh.group(axis_name))
