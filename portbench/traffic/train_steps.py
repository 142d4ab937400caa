"""Training steps: the program's train step over synthetic pairs fed as its trainer feeds them, for the window.

Parameters (``traffic/<mix>.json``): ``pairs_per_step``; ``distinct_batches`` (at least 3) drawn from the seed as
host arrays, uint8 frames and fp32 target pointmaps N(0, 1), served in turn through the program's
``prefetch_to_device``; ``learning_rate``, ``weight_decay`` and ``alpha`` of AdamW and the confidence loss
(norm_mode 'avg_dis'); ``traced_steps`` (the traced window of a ``--trace 1`` run, after the measured window);
``reference_block`` (pairs per block of the reference's forward and backward).

Set-up builds one train step and drives it through its first three steps, on the first three draws, which
warms every shape; those steps are the ones the reference follows. The window then runs steps on the same
object until its seconds are up, and a synchronise ends it; the objects set-up made are frozen out of the
garbage collector's generations for the window. End-to-end metrics: ``setup_s`` (process start to
the window) and ``train_pairs_per_s`` (pairs of every step of the window over the window's seconds).

The numbers compared (portbench/models/<family>.py ``training_errors``): the three steps' losses, each
parameter's first gradient as the optimizer holds it (its first moment over 1 - b1), and each parameter's
change over the three steps.
"""

import gc
import itertools
import time

import numpy as np

from portbench.core.record import Laps, Record
from portbench.core.spans import Spans
from portbench.core.trace import trace_window

__all__ = ["run", "draw_batches", "STEPS_CHECKED"]

STEPS_CHECKED = 3


def draw_batches(traffic: dict, img_hw, seed: int):
    "The distinct host batches {img1, img2 uint8 (P, H, W, 3); pts1, pts2 fp32 (P, H, W, 3)} of the seed."
    if traffic["distinct_batches"] < STEPS_CHECKED:
        raise ValueError(f"distinct_batches must be at least {STEPS_CHECKED}: the checked steps' rows all differ")
    rng = np.random.default_rng([seed, 2])
    P, (H, W) = traffic["pairs_per_step"], img_hw
    return [{"img1": rng.integers(0, 256, (P, H, W, 3), dtype=np.uint8),
             "img2": rng.integers(0, 256, (P, H, W, 3), dtype=np.uint8),
             "pts1": rng.standard_normal((P, H, W, 3), dtype=np.float32),
             "pts2": rng.standard_normal((P, H, W, 3), dtype=np.float32)} for _ in range(traffic["distinct_batches"])]


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_steps(torch, fam, trainer, prep, feed):
    "The first three steps on the program: (losses, first-gradient norms, change norms), by parameter name."
    start = [p.detach().clone() for p in trainer.params]
    losses, grads = [], None
    for k in range(STEPS_CHECKED):
        b = next(feed)
        losses.append(trainer.step(prep(b["img1"]), prep(b["img2"]), b["pts1"], b["pts2"]))
        if k == 0:
            grads = fam.first_gradient_norms(trainer)
    change = [float(t) for t in torch._foreach_norm(torch._foreach_sub([p.detach() for p in trainer.params], start))]
    del start
    return [float(x) for x in losses], grads, dict(zip(trainer.names, change))


def run(ctx) -> Record:
    torch, cell, device = ctx.torch, ctx.cell, ctx.device
    laps = Laps(ctx.t_start)
    laps.lap("start_s")
    fam, arch, tr = cell.family(), cell.config["arch"], cell.traffic
    P = tr["pairs_per_step"]
    pool = draw_batches(tr, arch["img_size"], ctx.seed)
    laps.lap("traffic_s")
    if ctx.control:  # the reference one precision below the configured trunk, in the program's place
        return _control_run(ctx, fam, arch, tr, pool)
    model = fam.build_trainable(arch, cell.config["precision"], fam.draw_weights(arch, ctx.seed, device), device)
    trainer = fam.make_trainer(model, tr)
    if ctx.fault is not None:
        trainer = ctx.fault(trainer)
    laps.lap("model_s")
    fam.prepare_kernels(device)
    laps.lap("kernels_s")
    prep = fam.frame_normalizer(model, device)
    feed = fam.prefetch(itertools.cycle(pool), device)
    counts0 = fam.launch_counters()
    first = _first_steps(torch, fam, trainer, prep, feed)
    _sync(torch, device)
    laps.lap("first_steps_s")
    per_step = {k: (v - counts0[k]) // STEPS_CHECKED for k, v in fam.launch_counters().items()}
    notes = {"launches_per_step": per_step, "setup_laps": laps}
    # set-up's objects (the model, the host batches) leave the collector's generations: a full collection in the
    # window would walk them all, a host stall of 200-280 ms a few times a run, the card idle behind it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - ctx.t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans = Spans(torch)

    def one_step(sp):
        with sp("h2d"):
            b = next(feed)
        with sp("step"):
            trainer.step(prep(b["img1"]), prep(b["img2"]), b["pts1"], b["pts2"])

    start = time.perf_counter()
    n_steps = 0
    while time.perf_counter() - start < ctx.seconds:
        one_step(spans)
        n_steps += 1
    with spans("sync"):
        _sync(torch, device)
    window_s = time.perf_counter() - start

    trace, traced = None, 0
    if ctx.trace:
        traced, traced_spans = tr["traced_steps"], Spans(torch)
        trace = trace_window(torch, lambda: [one_step(traced_spans) for _ in range(traced)])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gc.unfreeze()
    feed.close()
    del model, trainer, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    values = fam.training_errors(first, _reference_readings(ctx, fam, arch, tr, pool, lowp=None))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    notes["steps"] = n_steps
    return Record(arch=arch, family=fam, device_kind=kind, window_s=window_s, units=n_steps * P,
                  spans=spans, peak_bytes=peak,
                  end_to_end={"setup_s": setup_s, "train_pairs_per_s": n_steps * P / window_s}, values=values,
                  attempted=n_steps * P, pairs_per_unit=P, trace=trace, traced_units=traced, notes=notes)


def _reference_readings(ctx, fam, arch, tr, pool, lowp):
    "The reference's three steps from the seed's weights on the first three draws, as _first_steps gives them."
    trainer = fam.reference_trainer(arch, fam.draw_weights(arch, ctx.seed, ctx.device), ctx.device, tr, lowp)
    with ctx.torch.profiler.record_function("reference"):
        for k in range(STEPS_CHECKED):
            trainer.step(pool[k])
    return trainer.losses, trainer.first_grad_norms, trainer.change_norms()


def _control_run(ctx, fam, arch, tr, pool) -> Record:
    "The control's readings: the reference with its trunk's products in fp8, against the fp32 reference."
    low = _reference_readings(ctx, fam, arch, tr, pool, lowp="fp8")
    gc.collect()
    ctx.torch.cuda.empty_cache()
    values = fam.training_errors(low, _reference_readings(ctx, fam, arch, tr, pool, lowp=None))
    return Record(arch=arch, family=fam, device_kind="control", window_s=1.0, units=0,
                  spans=Spans(ctx.torch), peak_bytes=0, end_to_end={}, values=values,
                  attempted=0)
