"""
Times the host side of the port's eager calls on the card, with the package
imported from ``--root``: this checkout or an unpacked earlier commit, so that
two trees are compared on one card in one call (run them in turns: a, b, b,
a). Three readings, the serving one first
(each process then reads the same host at the same point of its life):

    * ``calls_us``: the wall microseconds of one eager call of each kernel's
      wrapper (K2, K1 with and without its logsumexp, K6 and its prep, K4,
      K7, K5 self and cross) at a small shape, over a loop of calls after a
      warm-up; at these shapes the host, not the card, bounds the loop;
    * ``serve_pairs_per_s``: pairs/s of ``serve.make_serving_fn`` at DUSt3R ViT-L 512,
      batch 2 pairs, in chip_smoke.py's bf16-linear (phase 6), int8-linear
      (phase 15) and "fused" (phase 17) configurations, over 10 batches after
      one warm-up (CUDA events);
    * ``op_route`` (a tree whose kernels are ``uniception::`` custom ops,
      ops/serving_operands.py ``kernel_op``): in this one process, an eager
      call's route (the implementation called directly) against the op's
      dispatch (every call through ``torch.ops.uniception``, as under
      ``torch.export``), in turns: each wrapper's microseconds a call (median
      of ROUNDS rounds each) and each configuration's pairs/s (ROUNDS
      readings each).

Prints the card's name and power limit, then one JSON object.

    python3 uniception_tpu_torch/utils/host_times.py [--root DIR]
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CALLS, WARMUP, BATCHES, ROUNDS = 400, 40, 10, 4


def _call_us(torch, fn):
    "Wall microseconds per call of ``fn`` over CALLS calls after WARMUP, synchronised at both ends."
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e6


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO, help="the checkout whose uniception_tpu_torch is timed")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("host_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # chip_smoke.py main()'s settings
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from uniception_tpu_torch import serve
    from uniception_tpu_torch.models.utils import config
    from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
    from uniception_tpu_torch.ops import conv3x3, rope
    from uniception_tpu_torch.ops import flash_attention as fa
    from uniception_tpu_torch.ops import fused_attention as fused
    from uniception_tpu_torch.ops import int8_matmul as i8

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    bf = torch.bfloat16
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(bf)  # noqa: E731
    q, k, v = (rnd(1, 64, 2, 64) for _ in range(3))
    pos = make_patch_positions(1, 8, 8, device="cuda").to(torch.int32)
    x, xkv = rnd(1, 64, 128), rnd(1, 64, 128)
    w_q = torch.randint(-127, 128, (256, 256), device="cuda", generator=gen, dtype=torch.int8)
    w_scale = torch.rand(1, 256, device="cuda", generator=gen) * 1e-2 + 1e-4
    img, w3, b3 = rnd(1, 8, 8, 64), rnd(3, 3, 64, 64) * 0.05, torch.randn(64, device="cuda", generator=gen)
    wqkv, bqkv = rnd(384, 128) * 0.1, torch.randn(384, device="cuda", generator=gen)
    wq, wk, wv = (rnd(128, 128) * 0.1 for _ in range(3))
    x4 = rnd(1, 64, 256)
    cases = {
        "K2 rope2d": lambda: rope.rope_2d_kernel(q, pos),
        "K1": lambda: fa.flash_attention_fwd(q, k, v),
        "K1 lse": lambda: fa.flash_attention_fwd(q, k, v, with_lse=True),
        "K6 int8pv": lambda: fa.flash_attention_int8(q, k, v, mode="int8pv"),
        "K6 prep": lambda: fa.flash_attention_int8_prep(k, v, "int8pv"),
        "K4": lambda: i8.int8_matmul_dynamic(x4, w_q.t(), w_scale),
        "K7": lambda: conv3x3.conv3x3_nhwc(img, w3, b3),
        "K5 self": lambda: fused.fused_qkv_rope_attention(x, wqkv, bqkv, pos, 2, 0.125),
        "K5 cross": lambda: fused.fused_cross_rope_attention(x, xkv, wq, wk, wv, None, None, None, pos, pos, 2, 0.125),
    }
    out = {"root": os.path.relpath(root, REPO), "calls_us": {}, "serve_pairs_per_s": {}}
    try:
        from uniception_tpu_torch.ops import serving_operands as so
    except ImportError:  # a tree before the custom ops
        so = None
    routes = {"direct": lambda: False, "op": lambda: True}

    def turns(measure):
        "{route: [ROUNDS readings]}: ``measure()`` under each route in turns (direct, op, op, direct, ...)."
        got = {r: [] for r in routes}
        for k in range(ROUNDS):
            for r in (("direct", "op") if k % 2 == 0 else ("op", "direct")):
                so.traced = routes[r]
                try:
                    got[r].append(measure())
                finally:
                    so.traced = traced
        return got

    if so is not None:
        traced = so.traced
        out["op_route"] = {"calls_us_median": {}, "serve_pairs_per_s": {}}
    rungs = [("bf16-linear", dict(head="linear"), "kernel"), ("int8-linear", dict(head="linear", int8=True), "kernel"),
             ("fused", dict(head="linear"), "fused")]
    dims = (cs.IMG, cs.ENC_DEPTH, cs.ENC_DIM, cs.ENC_HEADS, cs.DEC_DEPTH, cs.DEC_DIM, cs.DEC_HEADS)
    rng = np.random.RandomState(cs.SEED)
    frames = [torch.from_numpy(rng.randint(0, 256, (cs.BATCH, cs.IMG, cs.IMG, 3), np.uint8)) for _ in range(2)]

    def each_rung(measure):
        "{rung: measure(pps)}, ``pps()`` the rung's pairs/s; each model built from seed SEED and dropped after."
        got = {}
        for name, opts, impl in rungs:
            config.set_attention_impl(impl)
            try:
                model = serve.build_model(*dims, device="cuda", seed=cs.SEED, **opts)
                fn = serve.make_serving_fn(model, "cuda")
                got[name] = measure(lambda: cs._events_pairs_per_s(torch, lambda: fn(*frames), cs.BATCH, BATCHES))
            finally:
                config.set_attention_impl("kernel")
            del model, fn
            torch.cuda.empty_cache()
        return got

    out["serve_pairs_per_s"] = each_rung(lambda pps: pps())
    if so is not None:
        out["op_route"]["serve_pairs_per_s"] = each_rung(turns)
    with torch.inference_mode():
        for name, fn in cases.items():
            out["calls_us"][name] = _call_us(torch, fn)
            if so is not None:
                got = turns(lambda: _call_us(torch, fn))
                out["op_route"]["calls_us_median"][name] = {r: float(np.median(v)) for r, v in got.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
