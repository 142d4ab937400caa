"""Closed-loop serving: one client sends a batch of image pairs, waits until the outputs are complete on the
device, then sends the next, for the whole window.

Parameters (``traffic/<mix>.json``): ``pairs_per_batch``; ``distinct_batches`` drawn from the seed as uint8
host arrays (batch i serves draw i mod distinct_batches, so every seed has the same sizes and the same
amount of work); ``warmup_batches``; ``sample_from_first`` (one batch drawn from the seed among the window's
first this many is kept for the check with the batch after it, which serves another draw, and the window's last
batch); ``traced_batches`` (the traced window
of a ``--trace 1`` run, after the measured window); ``reference_block`` (pairs per reference call). The frames'
size is the configuration's ``img_size``.

Each batch is timed on the host clock from the moment it is handed to the program until a synchronise
returns after it. The end-to-end metrics: ``setup_s`` (process start to the first timed batch),
``pairs_per_s`` (pairs of every batch of the window over the window's seconds) and ``batch_p95_ms`` (the
95th percentile of every batch's time).
"""

import gc
import time

import numpy as np

from portbench.core.record import Laps, Record
from portbench.core.spans import Spans
from portbench.core.stats import percentile_all
from portbench.core.trace import trace_window

__all__ = ["run", "draw_traffic"]


def draw_traffic(traffic: dict, img_hw, seed: int):
    "(pool of (frames1, frames2) uint8 (P, H, W, 3) host arrays, index of the sampled batch) from the seed."
    rng = np.random.default_rng([seed, 1])
    P, (H, W) = traffic["pairs_per_batch"], img_hw
    pool = [tuple(rng.integers(0, 256, (P, H, W, 3), dtype=np.uint8) for _ in range(2))
            for _ in range(traffic["distinct_batches"])]
    return pool, int(rng.integers(0, traffic["sample_from_first"]))


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> Record:
    torch, cell, device = ctx.torch, ctx.cell, ctx.device
    laps = Laps(ctx.t_start)
    laps.lap("start_s")
    fam, arch, tr = cell.family(), cell.config["arch"], cell.traffic
    P = tr["pairs_per_batch"]
    pool, sampled = draw_traffic(tr, arch["img_size"], ctx.seed)
    laps.lap("traffic_s")
    trunk_dtype = fam.DTYPES[cell.config["precision"]["trunk"]]  # serving holds the trunk's parameters in it
    weights = fam.draw_weights(arch, ctx.seed, device, trunk_dtype)
    model = fam.build_program(arch, cell.config["precision"], weights, device, control=ctx.control)
    del weights
    serve = fam.make_server(model, device)
    if ctx.fault is not None:
        serve = ctx.fault(serve)
    laps.lap("model_s")
    fam.prepare_kernels(device)
    laps.lap("kernels_s")
    counts0 = fam.launch_counters()
    for i in range(tr["warmup_batches"]):
        out = serve(*pool[i % len(pool)])
        _sync(torch, device)
    per_batch = {k: (v - counts0[k]) // max(1, tr["warmup_batches"]) for k, v in fam.launch_counters().items()}
    del out
    laps.lap("warmup_s")
    setup_s = time.perf_counter() - ctx.t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans = Spans(torch)
    latencies, kept = [], {}
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        with spans("serve"):
            out = serve(*pool[i % len(pool)])
        with spans("sync"):
            _sync(torch, device)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if i in (sampled, sampled + 1):
            kept[i] = out
        i += 1
        if t1 - start >= ctx.seconds:
            break
    window_s = t1 - start
    kept[i - 1] = out
    n_batches = i

    trace, traced = None, 0
    if ctx.trace:
        traced, traced_spans = tr["traced_batches"], Spans(torch)

        def body():
            for j in range(traced):
                with traced_spans("serve"):
                    serve(*pool[(n_batches + j) % len(pool)])
                with traced_spans("sync"):
                    _sync(torch, device)

        trace = trace_window(torch, body)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model, serve, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    values = check_against_reference(ctx, fam, arch, tr, pool, kept)
    e2e = {"setup_s": setup_s, "pairs_per_s": n_batches * P / window_s,
           "batch_p95_ms": percentile_all(latencies, 95) * 1e3}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return Record(arch=arch, family=fam, device_kind=kind, window_s=window_s, units=n_batches * P,
                  spans=spans, peak_bytes=peak, end_to_end=e2e, values=values,
                  attempted=n_batches * P, pairs_per_unit=P, trace=trace, traced_units=traced,
                  notes={"launches_per_batch": per_batch, "setup_laps": laps, "batches": n_batches,
                         "checked_batches": sorted(kept)})


def check_against_reference(ctx, fam, arch, tr, pool, kept) -> dict:
    """The plain reference over every pair of the kept batches, in blocks of ``reference_block`` pairs, from the
    same seed's weights: for each number the family compares, its worst reading over the pairs."""
    torch, device = ctx.torch, ctx.device
    trunk_dtype = fam.DTYPES[ctx.cell.config["precision"]["trunk"]]
    ref = fam.build_reference(arch, fam.draw_weights(arch, ctx.seed, device, trunk_dtype))
    worst = {}
    blk = tr["reference_block"]
    with torch.no_grad(), fam.reference_scope(), ctx.torch.profiler.record_function("reference"):
        for b, outs in sorted(kept.items()):
            f1, f2 = pool[b % len(pool)]
            for r in range(0, len(f1), blk):
                rows = slice(r, r + blk)
                want = ref(torch.from_numpy(f1[rows]).to(device), torch.from_numpy(f2[rows]).to(device))
                for name, errs in fam.output_errors([o[rows] for o in outs], want).items():
                    worst[name] = max([worst.get(name, 0.0)] + errs)
    return worst
