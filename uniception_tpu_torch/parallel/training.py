"""
Single-device training (counterpart of uniception_tpu/parallel/training.py).

    * :func:`normalize_pointmaps_nview`, :func:`normalize_pointmaps`,
      :func:`dust3r_confidence_loss`, :func:`multiview_confidence_loss` and
      :func:`flow_confidence_loss` — confidence-weighted pointmap and flow
      regression with valid masks (NaN/inf target sentinels masked twice)
      and ``norm_mode="avg_dis"``;
    * :func:`make_train_step` — the single-device subset of the JAX
      ``make_train_step``: AdamW with optax's numerics (:class:`AdamW`, a
      float or a schedule such as :func:`warmup_cosine_decay_schedule` as its
      learning rate), global-norm clipping, the non-finite guard, gradient
      accumulation, frozen parameters and the grad-norm metric, composed in
      the JAX package's order: accumulation outside the non-finite guard,
      outside the (trainable-only) clip + AdamW chain;
    * :func:`save_train_state` / :func:`restore_train_state` — the whole
      train state (parameters, moments, counters, step) in one directory,
      written synchronously or in a thread after a device-to-host snapshot;
    * :class:`PreemptionGuard` — SIGTERM/SIGINT as a flag polled at step
      boundaries;
    * :func:`ema_init` / :func:`ema_update` — an exponential moving average
      of the parameters.

The step updates the model's parameters and the optimizer state in place.
"""

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
    """The model, its trainable parameters (``names`` their dotted names), the
    optimizer and the step's state.

    ``step(img1, img2, target1, target2)`` runs the loss and its backward,
    updates the parameters and the optimizer in place and returns the loss
    (a 0-d tensor), or ``(loss, {"grad_norm": ...})`` with ``metrics``. The
    four arguments go to ``loss_fn`` as they are (tensors, dicts, stacks).
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, names: List[str], params: List[torch.Tensor],
                 optimizer: AdamW, grad_accum: int, clip_grad_norm: Optional[float], max_skips: Optional[int],
                 metrics: bool):
        self.model, self.loss_fn, self.names, self.params, self.optimizer = model, loss_fn, names, params, optimizer
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
    learning_rate: Union[float, Callable[[int], float]] = 1e-4,
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
    learning_rate, weight_decay, mu_dtype: :class:`AdamW` (a float or a
        schedule of the update count).
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
    names, params = [], []
    for name, p in model.named_parameters():
        if trainable is not None and not trainable(name):
            p.requires_grad_(False)
        elif p.requires_grad:
            names.append(name)
            params.append(p)
    if not params:
        raise ValueError("make_train_step: no trainable parameter")
    max_skips = None
    if skip_nonfinite:
        max_skips = skip_nonfinite if isinstance(skip_nonfinite, int) and not isinstance(skip_nonfinite, bool) else 100
    optimizer = AdamW(params, learning_rate, weight_decay=weight_decay, mu_dtype=mu_dtype)
    return TrainContext(model, loss_fn or _default_loss, names, params, optimizer, grad_accum, clip_grad_norm,
                        max_skips, metrics)


# --- train-state checkpoints ------------------------------------------------------

STATE_FILE = "train_state.pt"


def _state_tensors(state):
    """({key: tensor}, {counter: int}) of a TrainContext (parameters, moments, accumulator and counters) or of a
    {name: tensor} mapping (an EMA)."""
    if isinstance(state, TrainContext):
        opt = state.optimizer
        tensors = {}
        for i, name in enumerate(state.names):
            tensors[f"params.{name}"], tensors[f"mu.{name}"], tensors[f"nu.{name}"] = opt.params[i], opt.mu[i], opt.nu[i]
            if state.acc is not None:
                tensors[f"acc.{name}"] = state.acc[i]
        counters = {"count": opt.count, "mini_step": state.mini_step, "notfinite_count": state.notfinite_count}
        return tensors, counters
    if isinstance(state, Mapping):
        return {f"params.{k}": v for k, v in state.items()}, {}
    raise TypeError(f"a TrainContext or a mapping of tensors, got {type(state).__name__}")


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


def save_train_state(path: str, state, step: int = 0, wait: bool = True) -> Optional[PendingSave]:
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
    """
    tensors, counters = _state_tensors(state)
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


def restore_train_state(path: str, state) -> int:
    """Restore what :func:`save_train_state` wrote to ``path`` into ``state`` (a
    :class:`TrainContext` or a ``{name: tensor}`` mapping) in place; returns
    the saved step. Every name, shape and dtype must match (a checkpoint of
    another model, ``mu_dtype`` or ``grad_accum`` raises ValueError), and
    they are all checked before anything is written."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    tensors, counters = _state_tensors(state)
    saved = payload["tensors"]
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

    One process only: agreeing on a stop across processes needs a collective
    (JAX ``parallel/training.py`` ORs the flags over hosts), so
    :meth:`should_stop` raises once ``torch.distributed`` is initialised.
    """

    def __init__(self, signals=None):
        self._requested = False
        self._prev = {}
        for s in signals if signals is not None else (signal.SIGTERM, signal.SIGINT):
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def requested(self) -> bool:
        "This process's flag."
        return self._requested

    def should_stop(self) -> bool:
        "True once a stop signal has arrived."
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            raise NotImplementedError("PreemptionGuard across processes (a collective OR of the stop flags) is "
                                      "multi-GPU work: ROADMAP queue 1 item 12")
        return self._requested

    def close(self):
        "Restore the signal handlers installed before."
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    "A fresh EMA: detached copies of ``params`` (e.g. ``dict(model.named_parameters())``)."
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float = 0.999):
    "One EMA step in place: ``ema = decay * ema + (1 - decay) * params``."
    for k, e in ema.items():
        e.copy_(e * decay + params[k].to(e.dtype) * (1.0 - decay))
    return ema
