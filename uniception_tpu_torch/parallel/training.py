"""
Training (counterpart of uniception_tpu/parallel/training.py): on one device, or across the ranks of a process group.

    * :func:`normalize_pointmaps_nview`, :func:`normalize_pointmaps`,
      :func:`dust3r_confidence_loss`, :func:`multiview_confidence_loss` and
      :func:`flow_confidence_loss` — confidence-weighted pointmap and flow
      regression with valid masks (NaN/inf target sentinels masked twice)
      and ``norm_mode="avg_dis"``; inside :func:`global_batch` each rank's
      share of the global batch's loss;
    * :func:`make_train_step` — the JAX ``make_train_step``: AdamW with optax's
      numerics (:class:`AdamW`, a float or a schedule such as
      :func:`warmup_cosine_decay_schedule` as its learning rate), global-norm
      clipping, the non-finite guard, gradient accumulation, frozen parameters
      and the grad-norm metric, composed in the JAX package's order:
      accumulation outside the non-finite guard, outside the (trainable-only)
      clip + AdamW chain; under a process group over a ("data", "model") mesh
      with data parallelism, tensor parallelism (``use_tp``), ZeRO-1 and FSDP;
    * :func:`save_train_state` / :func:`restore_train_state` — the whole
      train state (parameters, moments, counters, step) in one directory,
      written synchronously or in a thread after a device-to-host snapshot;
      a sharded state is gathered and written by rank 0, and re-sharded when
      read;
    * :class:`PreemptionGuard` — SIGTERM/SIGINT as a flag polled at step
      boundaries, ORed over the ranks;
    * :func:`ema_init` / :func:`ema_update` — an exponential moving average
      of the parameters (of the rank's parts under TP and FSDP, saved whole).

The step updates the model's parameters and the optimizer state in place.
Across ranks the gradients are summed over "data" in flat buckets by one
collective per bucket, whatever the mode, so ZeRO-1 and FSDP (which cut the
reduced gradients to this rank's blocks) are plain data parallelism bit for
bit: AdamW is elementwise.
"""

import contextlib
import math
import os
import signal
import threading
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

__all__ = [
    "normalize_pointmaps_nview",
    "normalize_pointmaps",
    "dust3r_confidence_loss",
    "multiview_confidence_loss",
    "flow_confidence_loss",
    "global_norm",
    "global_batch",
    "warmup_cosine_decay_schedule",
    "AdamW",
    "TrainContext",
    "make_train_step",
    "save_train_state",
    "restore_train_state",
    "PreemptionGuard",
    "ema_init",
    "ema_update",
]


def normalize_pointmaps_nview(pts, valids=None, eps: float = 1e-8):
    """Joint avg-distance normalization over N views: every view is divided
    by the per-batch-element mean distance to the origin over the (valid)
    pixels of all views.

    pts: list of (B, H, W, 3); valids: None or a list of (B, H, W) bool masks
    (entries may be None). Returns (list of pts / s, s) with s (B, 1, 1, 1).
    """
    num = den = 0.0
    for i, p in enumerate(pts):
        valid = None if valids is None else valids[i]
        if valid is not None:
            # mask BEFORE the norm: a NaN/inf sentinel at an invalid pixel would poison the scale
            p = torch.where(valid[..., None], p, 0.0)
        d = torch.linalg.vector_norm(p, dim=-1)
        v = torch.ones_like(d) if valid is None else valid.to(d.dtype)
        num = num + (d * v).sum(dim=(1, 2))
        den = den + v.sum(dim=(1, 2))
    scale = torch.clamp(num / torch.clamp(den, min=1.0), min=eps)[:, None, None, None]
    return [p / scale for p in pts], scale


def normalize_pointmaps(p1, p2, valid1=None, valid2=None, eps: float = 1e-8):
    "Two-view :func:`normalize_pointmaps_nview` (DUSt3R's ``norm_mode='avg_dis'``). Returns (p1 / s, p2 / s, s)."
    (n1, n2), scale = normalize_pointmaps_nview([p1, p2], [valid1, valid2], eps=eps)
    return n1, n2, scale


def _check_norm_mode(norm_mode):
    if norm_mode is not None and norm_mode != "avg_dis":
        raise ValueError(f"unknown norm_mode: {norm_mode!r} (supported: 'avg_dis')")


def _confidence_loss(conf, pred, target, valid, alpha):
    """mean(conf * ||pred - target|| - alpha * log conf) over the (valid) pixels. conf (B, H, W); pred and target
    (B, H, W, C); valid None or (B, H, W) bool.

    Double-where: masking the per-pixel loss alone is not enough, a NaN/inf target sentinel would reach the backward
    through the norm's gradient, so the difference is masked first."""
    diff = pred - target
    if valid is not None:
        diff = torch.where(valid[..., None], diff, 0.0)
    per_px = conf * torch.linalg.vector_norm(diff, dim=-1) - alpha * torch.log(conf)
    if _GLOBAL_BATCH is not None:  # this rank's share of the global batch's mean (global_batch)
        from uniception_tpu_torch.parallel import comm

        _GLOBAL_BATCH.used = True
        group, size = _GLOBAL_BATCH.group, _GLOBAL_BATCH.size
        if valid is None:
            return per_px.sum() / (per_px.numel() * size)
        count = comm.all_reduce(valid.sum().reshape(1), "sum", group)[0]
        return torch.where(valid, per_px, 0.0).sum() / torch.clamp(count, min=1)
    if valid is None:
        return per_px.mean()
    return torch.where(valid, per_px, 0.0).sum() / torch.clamp(valid.sum(), min=1)


def dust3r_confidence_loss(
    res1, res2, target1, target2, alpha: float = 0.2, valid1=None, valid2=None, norm_mode: Optional[str] = None
):
    """DUSt3R confidence-weighted pointmap regression loss.

    L = mean(conf * ||pts - gt|| - alpha * log conf) per view, summed over
    the two views; with a valid mask the mean runs over the valid pixels.
    ``norm_mode="avg_dis"`` normalizes predictions and targets each by their
    own joint mean distance first (scale-invariant). Targets are (B, H, W, 3).
    """
    _check_norm_mode(norm_mode)
    pts1, pts2 = res1["pts3d"], res2["pts3d_in_other_view"]
    if norm_mode is not None:
        pts1, pts2, _ = normalize_pointmaps(pts1, pts2, valid1, valid2)
        target1, target2, _ = normalize_pointmaps(target1, target2, valid1, valid2)
    return (_confidence_loss(res1["conf"][..., 0], pts1, target1, valid1, alpha)
            + _confidence_loss(res2["conf"][..., 0], pts2, target2, valid2, alpha))


def multiview_confidence_loss(results, targets, alpha: float = 0.2, valids=None, norm_mode: Optional[str] = None):
    """N-view :func:`dust3r_confidence_loss` over ``MultiViewPointmapModel``
    outputs, summed over the views.

    results: per-view dicts with ``pts3d`` (B, H, W, 3) and ``conf`` (B, H, W, 1);
    targets: per-view (B, H, W, 3); valids: None or per-view (B, H, W) masks.
    ``norm_mode="avg_dis"``: predictions and targets each normalized by their
    own joint mean distance over all views.
    """
    _check_norm_mode(norm_mode)
    pts = [r["pts3d"] for r in results]
    if norm_mode is not None:
        pts, _ = normalize_pointmaps_nview(pts, valids)
        targets, _ = normalize_pointmaps_nview(list(targets), valids)
    return sum(_confidence_loss(r["conf"][..., 0], p, t, None if valids is None else valids[i], alpha)
               for i, (r, p, t) in enumerate(zip(results, pts, targets)))


def flow_confidence_loss(out, target_flow, alpha: float = 0.2, valid=None):
    """Confidence-weighted dense-flow regression loss for ``UFMFlow`` outputs:
    mean(conf * ||flow - gt|| - alpha * log conf).

    out: ``forward_pair``'s dict with ``flow`` (B, H, W, 2) and ``flow_conf``
    (B, H, W, 1); target_flow (B, H, W, 2) in pixels; valid: None or a
    (B, H, W) mask (occlusions, out of frame; their targets may be NaN/inf).
    """
    return _confidence_loss(out["flow_conf"][..., 0], out["flow"], target_flow, valid, alpha)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    "The L2 norm of all tensors together (``optax.global_norm``), as a 0-d fp32 tensor."
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` (end value 0, exponent 1) in
    float32, as a function of the update count: a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to 0 at ``decay_steps`` (the warmup included), held there after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    f32 = np.float32
    span = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax's linear_schedule, joined below the boundary
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = min(f32(count - warmup_steps), span)
        return float(f32(peak_value) * (f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / span))))

    return schedule


class AdamW:
    """``optax.adamw`` over a list of parameters, updated in place.

    b1 0.9, b2 0.999, eps 1e-8 added to sqrt(nu_hat), bias corrections in
    fp32, decoupled weight decay on every parameter (no mask):
    ``p += -lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)``.
    ``learning_rate`` is a float or a schedule, a function of the update
    count: as in optax it is evaluated at the 0-based count of the updates
    applied before this one (``count - 1`` after the increment; accumulation
    mini-steps and skipped non-finite steps do not count).
    ``mu_dtype`` stores the first moment in that dtype (e.g. bfloat16): as
    in optax, ``b1 * mu`` is taken in that dtype (b1 too is rounded to it)
    and the update uses the new moment before it is rounded to it.
    """

    def __init__(self, params: List[torch.Tensor], learning_rate: Union[float, Callable[[int], float]],
                 weight_decay: float = 0.05, mu_dtype: Optional[torch.dtype] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr, self.weight_decay, self.b1, self.b2, self.eps = learning_rate, weight_decay, b1, b2, eps
        self.mu_dtype = mu_dtype
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        self.count += 1
        lr = self.lr(self.count - 1) if callable(self.lr) else self.lr
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(self.count)) for b in (self.b1, self.b2))
        if self.mu_dtype is None:  # the moment in the parameters' dtype, updated in place
            mu = self.mu
            torch._foreach_mul_(mu, self.b1)
        else:  # b1 * mu in mu_dtype with b1 rounded to it, as optax multiplies a weakly typed scalar
            b1 = torch.tensor(self.b1, dtype=self.mu_dtype).item()
            mu = [m.to(p.dtype) for m, p in zip(torch._foreach_mul(self.mu, b1), self.params)]
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        if self.mu_dtype is not None:
            torch._foreach_copy_(self.mu, mu)  # rounded to mu_dtype


class TrainContext:
    """The model, its trainable parameters (``names`` their dotted names, as the unsharded model holds them), the
    optimizer and the step's state; under a process group also the mesh and how each parameter is split.

    ``step(img1, img2, target1, target2)`` runs the loss and its backward on this rank's rows, reduces the gradients
    over the "data" axis, updates the parameters and the optimizer in place and returns the loss of the global batch
    (a 0-d tensor, the same on every rank), or ``(loss, {"grad_norm": ...})`` with ``metrics``. The four arguments go
    to ``loss_fn`` as they are (tensors, dicts, stacks).
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, names: List[str], params: List[torch.Tensor],
                 optimizer: AdamW, grad_accum: int, clip_grad_norm: Optional[float], max_skips: Optional[int],
                 metrics: bool, mesh=None, tp=None, data_dims=None, gathers=None, zero1: bool = False,
                 layouts=None):
        self.model, self.loss_fn, self.names, self.params, self.optimizer = model, loss_fn, names, params, optimizer
        self.grad_accum, self.clip_grad_norm, self.max_skips, self.metrics = grad_accum, clip_grad_norm, max_skips, metrics
        self.mesh = mesh
        n = len(params)
        self.tp = tp or [None] * n  # per parameter: (dim, rows of the whole tensor each "model" rank holds) or None
        self.data_dims = data_dims or [None] * n  # per parameter: the dim its optimizer state splits over "data"
        self.gathers = gathers or [None] * n  # per parameter: FSDP's gather (the autograd leaf is the block) or None
        self.zero1 = zero1  # the parameters are whole and the optimizer holds blocks of them
        # under a process group, every parameter of the model (trainable or not) by name: (tp, data dim) of the part
        # this rank holds, which an EMA of the parameters shares (save_train_state(..., ctx=))
        self.layouts = layouts or {}
        self.blocks = list(optimizer.params)  # under ZeRO-1: this rank's block of each parameter (a view)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in optimizer.params] if grad_accum > 1 else None
        self.notfinite_count = 0  # consecutive non-finite updates skipped

    @property
    def data_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["data"]

    def step(self, img1, img2, target1, target2):
        with contextlib.ExitStack() as scope:
            shares = None
            if self.data_size > 1:  # the module's losses give this rank's share of the global batch's loss
                shares = scope.enter_context(global_batch(self.mesh.group("data"), self.data_size))
            if any(g is not None for g in self.gathers):
                from uniception_tpu_torch.parallel.mesh import fsdp_release

                scope.enter_context(fsdp_release())
            loss = self.loss_fn(self.model, img1, img2, target1, target2)
            if shares is not None and not shares.used:
                # the gradients are summed over "data": a per-rank mean would count data_size times
                raise ValueError(f"make_train_step over a data axis of {self.data_size} ranks: loss_fn went through "
                                 "none of this module's losses (dust3r_confidence_loss, multiview_confidence_loss, "
                                 "flow_confidence_loss), so it is not this rank's share of the global batch's loss")
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = self._reduce(grads)
        if self.data_size > 1:
            from uniception_tpu_torch.parallel import comm

            loss = comm.all_reduce(loss.detach(), "sum", self.mesh.group("data"))
        aux = {"grad_norm": self._global_norm(grads)} if self.metrics else None  # of this batch, before clipping
        self._update(grads)
        loss = loss.detach()
        return (loss, aux) if self.metrics else loss

    def _reduce(self, grads) -> List[torch.Tensor]:
        """The gradients the optimizer takes: each parameter's whole (rank-local under TP) gradient, summed over the
        "data" axis in buckets, then under ZeRO-1 and FSDP the block of it this rank's optimizer holds."""
        out = []
        for i, (g, p) in enumerate(zip(grads, self.params)):
            gm = self.gathers[i]
            if gm is not None:  # FSDP: the whole tensor's gradient, from the step's gathers
                g, gm.grad = gm.grad, None
                if g is None:
                    shape = list(p.shape)
                    shape[gm.dim] *= self.data_size
                    g = torch.zeros(shape, dtype=p.dtype, device=p.device)
            out.append(torch.zeros_like(p) if g is None else g)
        if self.data_size == 1:
            return out
        from uniception_tpu_torch.parallel import comm
        from uniception_tpu_torch.parallel.mesh import data_slice

        out = _bucketed(out, lambda flat: comm.all_reduce(flat, "sum", self.mesh.group("data")))
        # contiguous blocks: AdamW's foreach kernels then take the fast route they take on whole tensors
        return [g if d is None else data_slice(g, d, self.mesh).contiguous() for g, d in zip(out, self.data_dims)]

    def _split(self, i: int) -> int:
        "How many ranks hold distinct parts of parameter i's optimizer state."
        return ((self.mesh.shape["model"] if self.tp[i] is not None else 1)
                * (self.data_size if self.data_dims[i] is not None else 1))

    def _global_norm(self, grads) -> torch.Tensor:
        """The L2 norm of the whole gradient: each split parameter's parts summed over the ranks that hold them, each
        replicated one counted once (one all-reduce over the world when anything is split)."""
        if self.mesh is None or all(self._split(i) == 1 for i in range(len(grads))):
            return global_norm(grads)
        from uniception_tpu_torch.parallel import comm

        world = comm.world_size()
        sq = sum(torch.linalg.vector_norm(g.float()) ** 2 * (self._split(i) / world) for i, g in enumerate(grads))
        return torch.sqrt(comm.all_reduce(sq.reshape(1), "sum")[0])

    def _all_finite(self, grads) -> bool:
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if self.mesh is not None and torch.distributed.get_world_size() > 1:  # one decision on every rank
            from uniception_tpu_torch.parallel import comm

            finite = comm.all_reduce((~finite).to(torch.int32).reshape(1), "max")[0] == 0
        return bool(finite)

    @torch.no_grad()
    def _update(self, grads):
        if self.acc is not None:  # optax.MultiSteps: a running (Welford) mean, applied every grad_accum steps
            n = self.mini_step
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step = (n + 1) % self.grad_accum
            if self.mini_step:
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.max_skips is not None:  # optax.apply_if_finite
            finite = self._all_finite(grads)
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= self.max_skips:
                return
        if self.clip_grad_norm is not None:  # optax.clip_by_global_norm: (g / ||g||) * max, no epsilon
            norm = float(self._global_norm(grads))
            if not norm < self.clip_grad_norm:
                torch._foreach_div_(grads, norm)
                torch._foreach_mul_(grads, self.clip_grad_norm)
        if self.zero1:  # AdamW on contiguous copies of the blocks (a column block is a strided view)
            self.optimizer.params = [b if b.is_contiguous() else b.contiguous() for b in self.blocks]
        self.optimizer.step(grads)
        if self.zero1:  # every rank's updated blocks make the whole parameters again
            for i, whole in enumerate(self._gather_data(self.optimizer.params)):
                if self.data_dims[i] is not None:
                    self.params[i].copy_(whole)

    def _gather_data(self, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each parameter's whole (rank-local under TP) tensor from every data rank's block of it: ``blocks`` one per
        parameter, split as its ``data_dims`` entry (a None entry's tensor is already whole and passes)."""
        idx = [i for i, d in enumerate(self.data_dims) if d is not None]
        out = list(blocks)
        if not idx:
            return out
        wholes = _bucketed_gather([blocks[i] for i in idx], [self.data_dims[i] for i in idx],
                                  self.mesh.group("data"), self.data_size)
        for i, whole in zip(idx, wholes):
            out[i] = whole
        return out


def _buckets(tensors: List[torch.Tensor], cap: int):
    "Consecutive runs of ``tensors`` of one dtype and device, each at most ``cap`` elements (or one tensor)."
    run, size = [], 0
    for i, t in enumerate(tensors):
        if run and (size + t.numel() > cap or t.dtype != tensors[run[0]].dtype or t.device != tensors[run[0]].device):
            yield run
            run, size = [], 0
        run.append(i)
        size += t.numel()
    if run:
        yield run


BUCKET_ELEMENTS = 1 << 24  # 64 MB of fp32 a collective: few calls, and a staging buffer the pinned allocator keeps


def _bucketed(tensors: List[torch.Tensor], reduce: Callable) -> List[torch.Tensor]:
    "``reduce`` (an elementwise collective) on the tensors packed in flat buckets, unpacked in their shapes."
    out = list(tensors)
    for run in _buckets(tensors, BUCKET_ELEMENTS):
        flat = reduce(torch.cat([tensors[i].reshape(-1) for i in run]))
        for i, part in zip(run, flat.split([tensors[i].numel() for i in run])):
            out[i] = part.view(tensors[i].shape)
    return out


def _bucketed_gather(blocks: List[torch.Tensor], dims: List[int], group, n: int) -> List[torch.Tensor]:
    "Each tensor whole from the n ranks' equal blocks of it along its dim, gathered over ``group`` in flat buckets."
    from uniception_tpu_torch.parallel import comm

    out = [None] * len(blocks)
    for run in _buckets(blocks, BUCKET_ELEMENTS):
        sizes = [blocks[i].numel() for i in run]
        flat = comm.all_gather(torch.cat([blocks[i].reshape(-1) for i in run]), 0, group).view(n, -1)
        for i, parts in zip(run, flat.split(sizes, dim=1)):
            out[i] = torch.cat([p.reshape(blocks[i].shape) for p in parts], dim=dims[i])
    return out


class _Shares:
    "An open :func:`global_batch`: its group and size, and whether one of this module's losses took its share."

    def __init__(self, group, size: int):
        self.group, self.size, self.used = group, size, False


_GLOBAL_BATCH = None  # the open _Shares while a sharded step computes its loss


@contextlib.contextmanager
def global_batch(group, size: int):
    """While open, this module's losses are each rank's share of the global batch's loss over ``group`` (the "data"
    axis of ``size`` ranks, each holding its rows): a mean over pixels is divided by the global pixel or valid count
    (the valid counts summed over the group), so the shares add up to the global batch's loss and their gradients
    to its gradient, as JAX's losses divide by the global count of a sharded batch. The train step opens it, and
    raises when its loss took no share. Yields the record whose ``used`` says whether a loss did."""
    global _GLOBAL_BATCH
    prev, _GLOBAL_BATCH = _GLOBAL_BATCH, _Shares(group, size)
    try:
        yield _GLOBAL_BATCH
    finally:
        _GLOBAL_BATCH = prev


def _default_loss(m, img1, img2, target1, target2):
    res1, res2 = m.forward_pair(img1, img2)
    return dust3r_confidence_loss(res1, res2, target1, target2)


def make_train_step(
    model: nn.Module,
    loss_fn: Optional[Callable] = None,
    learning_rate: Union[float, Callable[[int], float]] = 1e-4,
    weight_decay: float = 0.05,
    data: int = -1,
    model_axis: int = 1,
    use_tp: bool = False,
    grad_accum: int = 1,
    zero1: bool = False,
    fsdp: bool = False,
    mu_dtype: Optional[torch.dtype] = None,
    clip_grad_norm: Optional[float] = None,
    skip_nonfinite=False,
    metrics: bool = False,
    trainable: Optional[Callable[[str], bool]] = None,
) -> TrainContext:
    """Build a train step for a DUSt3R-style model: on one device, or under a process group over a ("data", "model")
    mesh of the world's ranks (parallel/multihost.py ``initialize_multihost``), every rank calling it.

    loss_fn: ``(model, img1, img2, target1, target2) -> scalar``; default
        :func:`dust3r_confidence_loss` over ``model.forward_pair``. Under a data axis it gets this rank's rows, and
        the module's losses give this rank's share of the global batch's loss (:func:`global_batch`); a loss that
        goes through none of them raises ValueError at its first step there.
    learning_rate, weight_decay, mu_dtype: :class:`AdamW` (a float or a
        schedule of the update count).
    data, model_axis: the mesh (``parallel.mesh.make_mesh``; data=-1 takes the ranks that remain). The model's
        parameters become rank 0's on every rank; the caller passes each rank its rows (``mesh.shard_batch`` or
        ``multihost.shard_local_batch``), and the gradients are summed over "data" in 64 MB buckets.
    use_tp: with ``model_axis`` > 1, shard the model by tensor parallelism (``parallel.mesh.tp_shard_state``): each
        rank holds its heads and hidden columns, and the column- and row-parallel layers' collectives carry the
        gradients. The replicated parameters' gradients are the same on every rank of the "model" axis.
    zero1: the optimizer holds only this rank's block of each parameter's moments over "data"
        (``parallel.mesh.zero1_shard_state``); after the update the blocks are all-gathered into the whole
        parameters. The update is plain data parallelism's, bit for bit.
    fsdp: the rank holds only its block of each parameter (and so of its moments) over "data"
        (``parallel.mesh.fsdp_shard_state``): each layer gathers its weights when it runs, the backward gathers
        again what it needs, and the gradients are reduced as plain data parallelism reduces them, then cut to the
        blocks. Composes with ``use_tp`` (the "model" axis is kept; "data" lands on the largest free axis).
    grad_accum: average the gradients of this many steps and update once
        (``optax.MultiSteps``); the steps in between return their loss and
        change no parameter.
    clip_grad_norm: scale the (trainable) gradients by max / ||g|| when
        ||g|| exceeds it (``optax.clip_by_global_norm``); the norm sums every rank's part of a split parameter and
        counts a replicated one once.
    skip_nonfinite: a step whose (accumulated) gradients hold NaN/inf leaves
        the parameters, the moments and the step count untouched, up to the
        max-consecutive-skips budget (default 100; an int sets it), after
        which the update is applied (``optax.apply_if_finite``). Under a process group every rank takes the same
        decision (the finiteness is reduced over the world).
    metrics: the step also returns ``{"grad_norm": ...}``, the global norm of
        this step's gradients before clipping.
    trainable: ``(dotted name) -> bool`` over ``model.named_parameters()``;
        parameters where it is False get ``requires_grad_(False)`` (no
        weight gradient is computed) and no optimizer state.
    """
    from uniception_tpu_torch.parallel import mesh as pmesh

    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dist = torch.distributed
    mesh = None
    if dist.is_available() and dist.is_initialized():
        mesh = pmesh.make_mesh(data=data, model=model_axis)
        pmesh.replicate_state(model, mesh)
        if use_tp and model_axis > 1:
            pmesh.tp_shard_state(model, mesh)
    elif data not in (-1, 1) or model_axis != 1:
        raise ValueError(f"make_train_step(data={data}, model_axis={model_axis}) needs a process group over the "
                         f"ranks: call parallel.multihost.initialize_multihost first")
    owners = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            owners[pmesh.canonical_name(f"{mname}.{pname}" if mname else pname)] = (m, pname)
    names = []
    for name, p in model.named_parameters():
        name = pmesh.canonical_name(name)
        if trainable is not None and not trainable(name):
            p.requires_grad_(False)
        elif p.requires_grad:
            names.append(name)
    if not names:
        raise ValueError("make_train_step: no trainable parameter")
    tp = [getattr(owners[n][0], "tp_layout", {}).get(owners[n][1]) for n in names]
    data_dims, gathers = [None] * len(names), [None] * len(names)
    if mesh is not None and fsdp:
        pmesh.fsdp_shard_state(model, mesh)
        for i, n in enumerate(names):
            if n in model.fsdp_leaves:
                gathers[i], data_dims[i] = model.fsdp_leaves[n]
    by_name = {pmesh.canonical_name(k): p for k, p in model.named_parameters()}
    params = [by_name[n] for n in names]
    layouts = {}
    if mesh is not None:
        fsdp_dims = {n: d for n, (_, d) in getattr(model, "fsdp_leaves", {}).items()} if fsdp else {}
        layouts = {n: (getattr(m, "tp_layout", {}).get(pname), fsdp_dims.get(n)) for n, (m, pname) in owners.items()}
    opt_params = params
    if mesh is not None and zero1 and not fsdp:
        specs = {n: pmesh.P(*["model" if t is not None and d == t[0] else None for d in range(p.ndim)])
                 for n, p, t in zip(names, params, tp)}
        blocks = pmesh.zero1_shard_state(dict(zip(names, params)), mesh, specs)
        opt_params = [blocks[n][0] for n in names]
        data_dims = [blocks[n][1] for n in names]
    max_skips = None
    if skip_nonfinite:
        max_skips = skip_nonfinite if isinstance(skip_nonfinite, int) and not isinstance(skip_nonfinite, bool) else 100
    optimizer = AdamW(opt_params, learning_rate, weight_decay=weight_decay, mu_dtype=mu_dtype)
    return TrainContext(model, loss_fn or _default_loss, names, params, optimizer, grad_accum, clip_grad_norm,
                        max_skips, metrics, mesh=mesh, tp=tp, data_dims=data_dims, gathers=gathers,
                        zero1=mesh is not None and zero1 and not fsdp, layouts=layouts)


# --- train-state checkpoints ------------------------------------------------------

STATE_FILE = "train_state.pt"


def _state_tensors(state, ctx=None):
    """({key: tensor}, {counter: int}, {key: (tp, data dim)}, mesh) of a TrainContext (parameters, moments,
    accumulator and counters; the layouts of the rank's tensors under a process group, else {}) or of a {name: tensor}
    mapping (an EMA; with ``ctx``, a TrainContext under a process group, the rank's parts of its parameters)."""
    if isinstance(state, TrainContext):
        opt = state.optimizer
        tensors, layouts = {}, {}
        for i, name in enumerate(state.names):
            tensors[f"params.{name}"], tensors[f"mu.{name}"], tensors[f"nu.{name}"] = state.params[i], opt.mu[i], opt.nu[i]
            if state.acc is not None:
                tensors[f"acc.{name}"] = state.acc[i]
            if state.mesh is not None:  # the parameter is a block only under FSDP; its optimizer state under ZeRO-1 too
                d = state.data_dims[i]
                layouts.update({f"{k}.{name}": (state.tp[i], d) for k in ("mu", "nu", "acc")})
                layouts[f"params.{name}"] = (state.tp[i], d if state.gathers[i] is not None else None)
        counters = {"count": opt.count, "mini_step": state.mini_step, "notfinite_count": state.notfinite_count}
        return tensors, counters, layouts, state.mesh
    if isinstance(state, Mapping):
        layouts, mesh = {}, None
        if ctx is not None and ctx.mesh is not None:
            unknown = sorted(set(state) - set(ctx.layouts))
            if unknown:
                raise ValueError(f"not parameters of the train context's model (by their unsharded names): {unknown[:5]}")
            layouts, mesh = {f"params.{k}": ctx.layouts[k] for k in state}, ctx.mesh
        return {f"params.{k}": v for k, v in state.items()}, {}, layouts, mesh
    raise TypeError(f"a TrainContext or a mapping of tensors, got {type(state).__name__}")


def _whole(mesh, t: torch.Tensor, layout) -> torch.Tensor:
    "The unsharded tensor from every rank's part: gathered over the data axis (its block), then over the model axis."
    from uniception_tpu_torch.parallel import comm

    tp, d = layout
    if d is not None:
        t = comm.all_gather(t.detach().contiguous(), d, mesh.group("data"))
    if tp is not None:
        dim, parts = tp
        g = comm.all_gather(t.detach().contiguous(), dim, mesh.group("model"))
        t = torch.empty_like(g).index_copy_(dim, torch.cat(parts).to(g.device), g)
    return t


def _part(mesh, full: torch.Tensor, layout) -> torch.Tensor:
    "This rank's part of an unsharded tensor (the inverse of :func:`_whole`)."
    from uniception_tpu_torch.parallel.mesh import data_slice

    tp, d = layout
    if tp is not None:
        full = full.index_select(tp[0], tp[1][mesh.coords["model"]])
    return full if d is None else data_slice(full, d, mesh)


def _snapshot(tensors: Dict[str, torch.Tensor]):
    """Host copies of ``tensors``, and the event after the last device copy (None: all on the CPU, copied now).

    A device tensor is copied into pinned memory on its device's current stream, the stream the train step runs
    on, so a later step's in-place update of it is queued after the copy has read it."""
    out, device = {}, None
    for key, t in tensors.items():
        t = t.detach()
        if t.device.type == "cpu":
            out[key] = t.clone()
            continue
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        out[key], device = host, t.device
    if device is None:
        return out, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return out, event


def _write_state(path: str, payload: dict):
    """Write ``payload`` under a temporary name, then rename it over ``path``/STATE_FILE: a write cut short leaves
    the previous checkpoint whole."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STATE_FILE)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


class PendingSave:
    "An asynchronous :func:`save_train_state`: the write runs in a thread; ``wait_until_finished`` joins it."

    def __init__(self, write: Callable[[], None]):
        self._error = None
        self._thread = threading.Thread(target=self._run, args=(write,), name="save_train_state")
        self._thread.start()

    def _run(self, write):
        try:
            write()
        except BaseException as e:  # re-raised in the caller's thread by wait_until_finished
            self._error = e

    def wait_until_finished(self):
        self._thread.join()
        if self._error is not None:
            raise self._error


def save_train_state(path: str, state, step: int = 0, wait: bool = True, ctx=None) -> Optional[PendingSave]:
    """Save the train state to the directory ``path`` (one file, ``STATE_FILE``).

    state: a :class:`TrainContext` (its parameters, AdamW's ``count``, ``mu``
    in ``mu_dtype`` and ``nu``, the accumulation mini-step and accumulator,
    the non-finite counter) or a ``{name: tensor}`` mapping such as an EMA.
    The tensors are snapshotted to the host before this returns (device
    copies queued on the current stream ahead of any later step), so the
    caller may keep training. ``wait=False`` writes in a thread and returns
    a :class:`PendingSave`; call its ``wait_until_finished()`` before the
    next save, before reading the checkpoint and before exiting.
    ``wait=True`` writes before returning and returns None.

    A sharded train state (tensor parallelism, ZeRO-1, FSDP) is gathered tensor by tensor on every rank, and rank 0
    writes the file a single-device run of the same model writes; the other ranks write nothing and return None.
    So is a mapping of the rank's parts of the parameters, keyed by their unsharded names (an EMA of a sharded run),
    given the :class:`TrainContext` they belong to as ``ctx``.
    """
    tensors, counters, layouts, mesh = _state_tensors(state, ctx)
    if layouts:  # a sharded train state: gathered one tensor at a time (every rank), rank 0 keeps the host copies
        from uniception_tpu_torch.parallel import comm

        host, event = {}, None
        for key, t in tensors.items():
            whole = _whole(mesh, t, layouts[key])
            if comm.rank() == 0:
                part, ev = _snapshot({key: whole})
                host.update(part)
                event = ev or event
        if comm.rank() != 0:
            return None
    else:
        host, event = _snapshot(tensors)
    payload = {"step": int(step), "tensors": host, **counters}

    def write():
        if event is not None:
            event.synchronize()
        _write_state(path, payload)

    if wait:
        write()
        return None
    return PendingSave(write)


def restore_train_state(path: str, state, ctx=None) -> int:
    """Restore what :func:`save_train_state` wrote to ``path`` into ``state`` (a
    :class:`TrainContext` or a ``{name: tensor}`` mapping) in place; returns
    the saved step. Every name, shape and dtype must match (a checkpoint of
    another model, ``mu_dtype`` or ``grad_accum`` raises ValueError), and
    they are all checked before anything is written. A sharded train state
    takes this rank's part of each tensor (every rank reads the file); so does a mapping given its ``ctx``, as in
    :func:`save_train_state`."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    tensors, counters, layouts, mesh = _state_tensors(state, ctx)
    saved = payload["tensors"]
    if layouts:  # each rank's part of the unsharded state
        saved = {k: (_part(mesh, v, layouts[k]) if k in layouts else v) for k, v in saved.items()}
    missing, unexpected = sorted(set(tensors) - set(saved)), sorted(set(saved) - set(tensors))
    if missing or unexpected:
        raise ValueError(f"train state at {path} does not match: missing {missing[:5]}, unexpected {unexpected[:5]}")
    for key, t in tensors.items():
        if saved[key].shape != t.shape or saved[key].dtype != t.dtype:
            raise ValueError(f"train state at {path}: {key} is {saved[key].dtype} {tuple(saved[key].shape)}, "
                             f"want {t.dtype} {tuple(t.shape)}")
    with torch.no_grad():
        for key, t in tensors.items():
            t.copy_(saved[key])
    if isinstance(state, TrainContext):
        state.optimizer.count = int(payload["count"])
        state.mini_step = int(payload["mini_step"])
        state.notfinite_count = int(payload["notfinite_count"])
    return int(payload["step"])


class PreemptionGuard:
    """SIGTERM/SIGINT (a spot reclaim, a maintenance event, Ctrl-C) as a flag:
    the handler only sets it, and the training loop polls :meth:`should_stop`
    at step boundaries, saves and exits. With :func:`save_train_state` and the
    step-indexed ``data.pipeline.DeterministicSampler`` a preempted and
    resumed run is bit-identical to an uninterrupted one.

    Several processes (``torch.distributed`` initialised): a signal may reach
    only some ranks, or reach them at different step boundaries, so
    :meth:`should_stop` ORs the flags over the world (an all-reduce MAX of
    each rank's flag) every ``sync_every`` calls, as the JAX package's
    ``PreemptionGuard`` does over hosts, and every rank stops at the same step.
    Whether a call joins the collective is decided by the call counter alone,
    which is the same on every rank: a signalled rank waits for the next sync
    boundary like the others (a rank that joined a collective the others skip
    would deadlock).
    """

    def __init__(self, signals=None, sync_every: int = 1):
        self._requested = False
        self._prev = {}
        self._sync_every = max(1, int(sync_every))
        self._calls = 0
        self._synced_stop = False
        for s in signals if signals is not None else (signal.SIGTERM, signal.SIGINT):
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def requested(self) -> bool:
        "This process's flag (no cross-process sync)."
        return self._requested

    def should_stop(self) -> bool:
        "True once a stop signal has arrived at any participating process."
        if self._synced_stop:
            return True
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return self._requested
        self._calls += 1
        if self._calls % self._sync_every:
            return False
        from uniception_tpu_torch.parallel import comm

        flag = torch.tensor([int(self._requested)], dtype=torch.int32, device=comm.device())
        self._synced_stop = bool(comm.all_reduce(flag, "max").item())
        return self._synced_stop

    def close(self):
        "Restore the signal handlers installed before."
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A fresh EMA: detached copies of ``params`` (e.g. ``dict(model.named_parameters())``). Under a process group,
    the rank's parts keyed by their unsharded names (``parallel.mesh.canonical_name``): the EMA is elementwise, and
    ``save_train_state(..., ctx=)`` writes it whole."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float = 0.999):
    "One EMA step in place: ``ema = decay * ema + (1 - decay) * params``."
    for k, e in ema.items():
        e.copy_(e * decay + params[k].to(e.dtype) * (1.0 - decay))
    return ema
