"""
Single-device training (counterpart of uniception_tpu/parallel/training.py).

    * :func:`normalize_pointmaps_nview`, :func:`normalize_pointmaps` and
      :func:`dust3r_confidence_loss` — DUSt3R's confidence-weighted pointmap
      regression with valid masks and ``norm_mode="avg_dis"``;
    * :func:`make_train_step` — the single-device subset of the JAX
      ``make_train_step``: AdamW with optax's numerics (:class:`AdamW`),
      global-norm clipping, the non-finite guard, gradient accumulation,
      frozen parameters and the grad-norm metric, composed in the JAX
      package's order: accumulation outside the non-finite guard, outside
      the (trainable-only) clip + AdamW chain;
    * :func:`ema_init` / :func:`ema_update` — an exponential moving average
      of the parameters.

The step updates the model's parameters and the optimizer state in place.
"""

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "normalize_pointmaps_nview",
    "normalize_pointmaps",
    "dust3r_confidence_loss",
    "global_norm",
    "AdamW",
    "TrainContext",
    "make_train_step",
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


def dust3r_confidence_loss(
    res1, res2, target1, target2, alpha: float = 0.2, valid1=None, valid2=None, norm_mode: Optional[str] = None
):
    """DUSt3R confidence-weighted pointmap regression loss.

    L = mean(conf * ||pts - gt|| - alpha * log conf) per view, summed over
    the two views; with a valid mask the mean runs over the valid pixels.
    ``norm_mode="avg_dis"`` normalizes predictions and targets each by their
    own joint mean distance first (scale-invariant). Targets are (B, H, W, 3).
    """
    pts1, pts2 = res1["pts3d"], res2["pts3d_in_other_view"]
    if norm_mode is not None:
        if norm_mode != "avg_dis":
            raise ValueError(f"unknown norm_mode: {norm_mode!r} (supported: 'avg_dis')")
        pts1, pts2, _ = normalize_pointmaps(pts1, pts2, valid1, valid2)
        target1, target2, _ = normalize_pointmaps(target1, target2, valid1, valid2)

    def view_loss(res, pts, target, valid):
        conf = res["conf"][..., 0]
        diff = pts - target
        if valid is not None:
            # double-where: masking per_px alone is not enough, a NaN/inf target
            # sentinel would reach the backward through the norm's gradient
            diff = torch.where(valid[..., None], diff, 0.0)
        per_px = conf * torch.linalg.vector_norm(diff, dim=-1) - alpha * torch.log(conf)
        if valid is not None:
            per_px = torch.where(valid, per_px, 0.0)
            return per_px.sum() / torch.clamp(valid.sum(), min=1)
        return per_px.mean()

    return view_loss(res1, pts1, target1, valid1) + view_loss(res2, pts2, target2, valid2)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    "The L2 norm of all tensors together (``optax.global_norm``), as a 0-d fp32 tensor."
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class AdamW:
    """``optax.adamw`` over a list of parameters, updated in place.

    b1 0.9, b2 0.999, eps 1e-8 added to sqrt(nu_hat), bias corrections in
    fp32, decoupled weight decay on every parameter (no mask):
    ``p += -lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)``.
    ``mu_dtype`` stores the first moment in that dtype (e.g. bfloat16): as
    in optax, ``b1 * mu`` is taken in that dtype (b1 too is rounded to it)
    and the update uses the new moment before it is rounded to it.
    """

    def __init__(self, params: List[torch.Tensor], learning_rate: float, weight_decay: float = 0.05,
                 mu_dtype: Optional[torch.dtype] = None, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr, self.weight_decay, self.b1, self.b2, self.eps = learning_rate, weight_decay, b1, b2, eps
        self.mu_dtype = mu_dtype
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        self.count += 1
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
        torch._foreach_add_(self.params, update, alpha=-self.lr)
        if self.mu_dtype is not None:
            torch._foreach_copy_(self.mu, mu)  # rounded to mu_dtype


class TrainContext:
    """The model, its trainable parameters, the optimizer and the step's state.

    ``step(img1, img2, target1, target2)`` runs the loss and its backward,
    updates the parameters and the optimizer in place and returns the loss
    (a 0-d tensor), or ``(loss, {"grad_norm": ...})`` with ``metrics``.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, params: List[torch.Tensor], optimizer: AdamW,
                 grad_accum: int, clip_grad_norm: Optional[float], max_skips: Optional[int], metrics: bool):
        self.model, self.loss_fn, self.params, self.optimizer = model, loss_fn, params, optimizer
        self.grad_accum, self.clip_grad_norm, self.max_skips, self.metrics = grad_accum, clip_grad_norm, max_skips, metrics
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in params] if grad_accum > 1 else None
        self.notfinite_count = 0  # consecutive non-finite updates skipped

    def step(self, img1, img2, target1, target2):
        loss = self.loss_fn(self.model, img1, img2, target1, target2)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        aux = {"grad_norm": global_norm(grads)} if self.metrics else None  # of this batch, before clipping
        self._update(grads)
        loss = loss.detach()
        return (loss, aux) if self.metrics else loss

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
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= self.max_skips:
                return
        if self.clip_grad_norm is not None:  # optax.clip_by_global_norm: (g / ||g||) * max, no epsilon
            norm = float(global_norm(grads))
            if not norm < self.clip_grad_norm:
                torch._foreach_div_(grads, norm)
                torch._foreach_mul_(grads, self.clip_grad_norm)
        self.optimizer.step(grads)


def _default_loss(m, img1, img2, target1, target2):
    res1, res2 = m.forward_pair(img1, img2)
    return dust3r_confidence_loss(res1, res2, target1, target2)


def make_train_step(
    model: nn.Module,
    loss_fn: Optional[Callable] = None,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.05,
    grad_accum: int = 1,
    mu_dtype: Optional[torch.dtype] = None,
    clip_grad_norm: Optional[float] = None,
    skip_nonfinite=False,
    metrics: bool = False,
    trainable: Optional[Callable[[str], bool]] = None,
) -> TrainContext:
    """Build a single-device train step for a DUSt3R-style model.

    loss_fn: ``(model, img1, img2, target1, target2) -> scalar``; default
        :func:`dust3r_confidence_loss` over ``model.forward_pair``.
    learning_rate, weight_decay, mu_dtype: :class:`AdamW`.
    grad_accum: average the gradients of this many steps and update once
        (``optax.MultiSteps``); the steps in between return their loss and
        change no parameter.
    clip_grad_norm: scale the (trainable) gradients by max / ||g|| when
        ||g|| exceeds it (``optax.clip_by_global_norm``).
    skip_nonfinite: a step whose (accumulated) gradients hold NaN/inf leaves
        the parameters, the moments and the step count untouched, up to the
        max-consecutive-skips budget (default 100; an int sets it), after
        which the update is applied (``optax.apply_if_finite``).
    metrics: the step also returns ``{"grad_norm": ...}``, the global norm of
        this step's gradients before clipping.
    trainable: ``(dotted name) -> bool`` over ``model.named_parameters()``;
        parameters where it is False get ``requires_grad_(False)`` (no
        weight gradient is computed) and no optimizer state.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    params = []
    for name, p in model.named_parameters():
        if trainable is not None and not trainable(name):
            p.requires_grad_(False)
        elif p.requires_grad:
            params.append(p)
    if not params:
        raise ValueError("make_train_step: no trainable parameter")
    max_skips = None
    if skip_nonfinite:
        max_skips = skip_nonfinite if isinstance(skip_nonfinite, int) and not isinstance(skip_nonfinite, bool) else 100
    optimizer = AdamW(params, learning_rate, weight_decay=weight_decay, mu_dtype=mu_dtype)
    return TrainContext(model, loss_fn or _default_loss, params, optimizer, grad_accum, clip_grad_norm, max_skips, metrics)


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    "A fresh EMA: detached copies of ``params`` (e.g. ``dict(model.named_parameters())``)."
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float = 0.999):
    "One EMA step in place: ``ema = decay * ema + (1 - decay) * params``."
    for k, e in ema.items():
        e.copy_(e * decay + params[k].to(e.dtype) * (1.0 - decay))
    return ema
