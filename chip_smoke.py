#!/usr/bin/env python3
"""
On-card smoke test of the PyTorch/CUDA port (``uniception_tpu_torch``).

Phases, in order; any failure raises and the script exits non-zero:
    1. card:   the GPU's name and power limit (nvidia-smi);
    2. build:  nvcc builds the kernels of uniception_tpu_torch/csrc;
    3. K1:     the flash-attention kernel against its plain version at the
               main-path shapes, N = 196, and Nq != Nk, on strided q/k/v views;
    4. K2:     the RoPE2D kernel against its plain version, and its inverse;
    5. model:  two-view DUSt3R at full width (ViT-L encoder, 768-wide decoder),
               512x512, fp32 heads, random weights from a seed: forward_pair
               through the kernels against the plain path, with an fp32 trunk
               and then with the serving bf16 trunk;
    6. serve:  the serving loop on 8 uint8 pairs of 512x512 at batch 2;
    7. K1+LSE: the forward kernel with its logsumexp output at the phase-3
               shapes: the same output as without it, the LSE against its
               plain version;
    8. K3:     the flash-attention backward kernels at the phase-3 shapes
               against the plain backward and against autograd through the
               plain forward;
    9. K2 bwd: the RoPE gradient through the kernel (-F0) against autograd
               through the plain version;
   10. train:  the same DUSt3R, fp32 parameters and optimizer state: one
               step's loss and every parameter's gradient through the kernels
               against the plain path (fp32 trunk, then bf16 trunk), the
               exact launches per step, 10 AdamW steps through
               make_train_step, and ms/step against the plain path;
   11. K4:     the int8 matmul kernel at the nine trunk shapes, bf16 and fp32
               x, against its plain version: the share of equal int8 codes and
               the output's max ulp;
   12. K6:     the int8 attention kernel, both modes, at the main-path shapes,
               N = 196 and Nq != Nk, against its plain version and against
               exact attention, with K1 and the other mode as controls that
               must fail the same check;
   13. K7:     the 3x3 conv kernel at the DPT head's shapes against its plain
               version;
   14. int8-DPT: DUSt3R 512 with DPT heads at the int8 rung (int8 trunk,
               int8 attention, bf16 heads with the conv kernel):
               forward_pair through the kernels against the plain path with
               exact launches per forward and every K6 call held against its
               plain version on the same inputs; again with K6 on its plain
               version, which must give the plain path's trunk bit for bit;
               and the int8 bill against the bf16 plain path;
   15. serving: pairs/s and peak memory of four serving configurations
               (bf16-linear from phase 6, int8-linear, bf16-DPT with fp32
               heads, the int8-DPT rung) and a profile of the int8-DPT run.

The line before the last is a JSON object with each kernel's launches on the
serving and training runs, its error against the plain version and both
times; the last line is ``{"ok": true, "device": {...}}``. Needs one CUDA
GPU; exits non-zero without one.

Usage:
    python3 chip_smoke.py
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances (max abs unless stated). bf16 kernels are held against the plain
# version computed in fp32 from the same bf16 inputs; fp32 kernels against
# the plain fp32 version with TF32 off.
K1_BF16_TOL = 2e-2   # output rounding to bf16 (half an ulp is 7.8e-3 at |o| ~ 2-4) plus p rounded to bf16
K1_FP32_TOL = 2e-5   # fp32 sums in another order
K2_FP32_TOL = 1e-5   # the same fp32 products; only sin/cos may differ in the last bit
K2_BF16_ULPS = 1     # per element, in bf16 ulps of the plain output's magnitude
K2_INVERSE_TOL = 1e-5
MODEL_REL_TOL = 2e-2  # ||kernel path - plain path|| / ||plain path|| per output, both bf16 trunks
# The same with fp32 trunks; measured 1.0e-6 to 1.7e-6 on an H100 (700 W): fp32 sums in another order
# through 36 blocks. The bf16 gap (measured 0.7e-2 to 1.2e-2) is bf16 rounding amplified by the depth.
MODEL_FP32_REL_TOL = 1e-4
LSE_TOL = {"bf16": 1e-4, "fp32": 1e-5}  # max abs: fp32 max and sum in another order, from the same inputs
# K3, max |kernel - plain| / max |plain| per gradient. bf16: p and ds rounded to bf16 before their products
# (2^-9 relative each) and bf16 outputs; fp32 (TF32 off): sums over up to 1030 rows in another order.
K3_REL_TOL = {"bf16": 2e-2, "fp32": 1e-5}
# Training step, kernels vs plain path, ||g_kernel - g_plain|| / ||g_plain|| per parameter gradient and
# |loss_kernel - loss_plain| / |loss_plain|. fp32 trunk: the bar of phase 5.
TRAIN_FP32_REL_TOL = 1e-4
# bf16 trunk, set from what this phase prints (measured on an H100 80GB HBM3, 700 W): per parameter, the
# bf16-plain vs fp32-plain gap has median 1.3e-2 and worst 0.135, the kernels vs plain path 2.5e-3 and 0.29.
# The worst are the cross-attention projk biases: RoPE makes their gradient a near-cancelling sum over tokens,
# and K3 rounds ds to bf16 before dk = ds^T q as the Pallas kernel does. So a loose per-parameter bound, and a
# tight one on all gradients together (measured 2.6e-3 kernels vs plain, 1.4e-2 bf16-plain vs fp32-plain).
TRAIN_BF16_REL_TOL = 0.5
TRAIN_BF16_GLOBAL_TOL = 2e-2
TRAIN_BF16_LOSS_TOL = 2e-3  # measured 9.2e-5 kernels vs plain, 1.4e-3 bf16-plain vs fp32-plain
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
# K4: the kernel's int8 codes and int32 sums are the plain version's, and so is the epilogue's order of
# roundings: at most 1 ulp of the output (bf16 or fp32).
K4_ULPS = 1
# K6 against its plain version, in bf16 ulps of max(|plain|, 1/64): the same int8 codes and fp32 products; the sums
# of p and P.V run in another order before o is rounded to bf16 (measured at most 1 ulp, max abs 4.9e-4 to 1.95e-3,
# on an H100 80GB HBM3, 700 W). The whole int8 cost is 1.1e-2 to 3.1e-2 relative to exact attention, which puts
# exact attention, or the other int8 mode, tens of ulps away: both are run through the same check as controls.
K6_ULPS, K6_ULP_FLOOR = 2, 1 / 64
# ||int8 - exact|| / ||exact||: the JAX package's test bound, set at N = 64 (tests/ops/test_flash_attention_int8.py),
# printed beside the gap; at N = 1024 the int8pv scheme itself reaches 3.0e-2 (its plain version too: p8 = round(p * 127)
# flattens a flat softmax). The gate is that the kernel's gap is its plain version's within K6_EXACT_SLACK, both ways.
K6_EXACT_REL_TOL = {"int8": 2e-2, "int8pv": 3e-2}
K6_EXACT_SLACK = 1e-3
K7_ULPS = 1  # fp32 sums in another order, one bf16 rounding; counted at |ref| >= 1/16
# int8-DPT forward_pair (phase 14), set from what the phase measures on an H100 80GB HBM3 (700 W). What holds the
# kernels to the int8 rung: each K6 call on the path within K6_ULPS of its plain version on the same activations
# (exact attention, the control, is over it on 45 of the 72 calls, up to 12 ulp), and with K6 on its plain version
# the decoder features equal the plain path's bit for bit (K4 is exact), the outputs then moved by K7 alone (1-ulp
# conv differences through the bf16 heads and the exp adaptor). With every kernel the int8 rung is chaotic: K6's
# 1-ulp differences re-draw the int8 rounding of every later layer, so the whole path lands as far from the plain
# path (decoder features 1.72e-2, outputs 3.07e-2 to 6.33e-2) as the int8 rung lands from bf16 (features 2.29e-2,
# outputs 5.2e-2 to 9.2e-2). Those bounds catch a broken path, not a missing quantization: the checks above do that.
INT8_TRUNK_REL_TOL = 3e-2
INT8_MODEL_REL_TOL = 8e-2
K7_HEADS_REL_TOL = 5e-2
SERVE_BATCHES = 4

ENC_DEPTH, ENC_DIM, ENC_HEADS = 24, 1024, 16
DEC_DEPTH, DEC_DIM, DEC_HEADS = 12, 768, 12
IMG, BATCH, PAIRS, SEED = 512, 2, 8, 0


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def graph_ms(torch, fn, iters=20):
    """Device milliseconds per call of fn: ``iters`` calls captured in one CUDA
    graph, replayed once after a warm-up replay and timed with CUDA events, so
    the host's launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up outside the capture: library handles, allocator
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_ms(torch, fn, warmup=3, iters=20):
    """Milliseconds per call of fn from CUDA events around back-to-back calls
    after warm-up: device time, or the host's time where the host cannot keep
    the device busy."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_card():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print("[1 card] nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(card)
    return card


def phase_build(kernel_lib):
    t0 = time.perf_counter()
    path = kernel_lib.build()
    kernel_lib.library()
    print(f"[2 build] {path.relative_to(REPO)} in {time.perf_counter() - t0:.1f}s")
    for line in kernel_lib.BUILD_LOG.splitlines():
        if "Function properties" in line or "Used" in line or "spill" in line:
            print(f"    {line.strip()}")


def phase_flash_attention(torch, fa):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # (name, B, Nq, Nk, H)
        ("encoder 512", 4, 1024, 1024, 16),
        ("decoder 512", 2, 1024, 1024, 12),
        ("encoder 224", 4, 196, 196, 16),
        ("Nq != Nk", 2, 300, 1000, 12),
    ]
    worst_bf16, main_ms, main_plain_ms = 0.0, None, None
    for name, B, Nq, Nk, H in cases:
        # q/k/v are strided views of (B, N, 3, H, D) tensors, as the qkv projection makes them
        xq = torch.randn(B, Nq, 3, H, 64, device="cuda", generator=gen)
        xkv = xq if Nq == Nk else torch.randn(B, Nk, 3, H, 64, device="cuda", generator=gen)
        q, k, v = xq[:, :, 0], xkv[:, :, 1], xkv[:, :, 2]
        err32 = (fa.flash_attention(q, k, v) - fa.flash_attention_ref(q, k, v)).abs().max().item()
        qb, kb, vb = (t.to(torch.bfloat16) for t in (xq, xkv, xkv))
        qb, kb, vb = qb[:, :, 0], kb[:, :, 1], vb[:, :, 2]
        out = fa.flash_attention(qb, kb, vb)
        ref = fa.flash_attention_ref(qb.float(), kb.float(), vb.float())
        require(torch.isfinite(out).all().item(), f"K1 {name}: non-finite output")
        err16 = (out.float() - ref).abs().max().item()
        ms = graph_ms(torch, lambda: fa.flash_attention(qb, kb, vb))
        plain_ms = graph_ms(torch, lambda: fa.flash_attention_ref(qb, kb, vb))
        print(
            f"[3 K1] {name:12s} B={B} Nq={Nq} Nk={Nk} H={H} D=64: max|err| bf16 {err16:.3e} (tol {K1_BF16_TOL})"
            f" fp32 {err32:.3e} (tol {K1_FP32_TOL}); bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA graph)"
        )
        require(err16 <= K1_BF16_TOL, f"K1 {name}: bf16 error {err16} > {K1_BF16_TOL}")
        require(err32 <= K1_FP32_TOL, f"K1 {name}: fp32 error {err32} > {K1_FP32_TOL}")
        worst_bf16 = max(worst_bf16, err16)
        if main_ms is None:
            main_ms, main_plain_ms = ms, plain_ms
    return worst_bf16, main_ms, main_plain_ms


def phase_rope(torch, rope, make_patch_positions):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst_bf16, main_ms, main_plain_ms = 0.0, None, None
    for B, H in ((4, 16), (2, 12)):
        pos = make_patch_positions(B, 32, 32, device="cuda")
        x = torch.randn(B, 1024, 3, H, 64, device="cuda", generator=gen)
        t32 = x[:, :, 0]  # a strided q view
        err32 = (rope.rope_2d_kernel(t32, pos) - rope.rope_2d(t32, pos)).abs().max().item()
        back = rope.rope_2d_kernel(rope.rope_2d_kernel(t32, pos), pos, f0=-1.0)
        err_inv = (back - t32).abs().max().item()
        tb = x.to(torch.bfloat16)[:, :, 0]
        out, ref = rope.rope_2d_kernel(tb, pos).float(), rope.rope_2d(tb, pos).float()
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)  # bf16 ulp at |ref|
        ulps = ((out - ref).abs() / ulp).max().item()
        err16 = (out - ref).abs().max().item()
        ms = graph_ms(torch, lambda: rope.rope_2d_kernel(tb, pos))
        plain_ms = graph_ms(torch, lambda: rope.rope_2d(tb, pos))
        print(
            f"[4 K2] B={B} N=1024 H={H} D=64: fp32 max|err| {err32:.3e} (tol {K2_FP32_TOL}), inverse {err_inv:.3e}"
            f" (tol {K2_INVERSE_TOL}), bf16 {ulps:.2f} ulp (tol {K2_BF16_ULPS}) max|err| {err16:.3e};"
            f" bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        )
        require(err32 <= K2_FP32_TOL, f"K2: fp32 error {err32} > {K2_FP32_TOL}")
        require(err_inv <= K2_INVERSE_TOL, f"K2: inverse error {err_inv} > {K2_INVERSE_TOL}")
        require(ulps <= K2_BF16_ULPS, f"K2: bf16 error {ulps} ulp > {K2_BF16_ULPS}")
        worst_bf16 = max(worst_bf16, err16)
        if main_ms is None:
            main_ms, main_plain_ms = ms, plain_ms
    return worst_bf16, main_ms, main_plain_ms


def phase_model(torch, np, serve, model, config, fa, rope, tol):
    "forward_pair (through the serving fn) with the kernels, then with the plain versions, on the same inputs."
    frames = np.random.RandomState(SEED).randint(0, 256, size=(2 * BATCH, IMG, IMG, 3), dtype=np.uint8)
    img1, img2 = frames[0::2], frames[1::2]
    fn = serve.make_serving_fn(model, "cuda")  # uint8 -> normalize -> forward_pair
    trunk = str(model.encoder.enc_norm.weight.dtype).replace("torch.", "")

    def forward():
        return fn(img1, img2)

    fa.flash_attention.launches = rope.rope_2d_kernel.launches = 0
    res_k = forward()
    torch.cuda.synchronize()
    k1, k2 = fa.flash_attention.launches, rope.rope_2d_kernel.launches
    config.set_attention_impl("naive")
    try:
        res_n = forward()
        torch.cuda.synchronize()
        naive_ms = cuda_ms(torch, forward, warmup=1, iters=5)
        require(
            (fa.flash_attention.launches, rope.rope_2d_kernel.launches) == (k1, k2),
            "the naive path launched a kernel",
        )
    finally:
        config.set_attention_impl("kernel")
    kernel_ms = cuda_ms(torch, forward, warmup=1, iters=5)

    want_k1 = ENC_DEPTH + DEC_DEPTH * 2 * 2  # encoder self + per view and depth: self and cross
    want_k2 = 2 * ENC_DEPTH + DEC_DEPTH * 2 * 4  # q and k of each of those attentions
    print(f"[5 model {trunk}] launches per forward_pair: K1 {k1} (want {want_k1}), K2 {k2} (want {want_k2})")
    require(k1 == want_k1, f"K1 launched {k1} times per forward, want {want_k1}")
    require(k2 == want_k2, f"K2 launched {k2} times per forward, want {want_k2}")
    for name, a, b in zip(("pts3d", "conf1", "pts3d_in_other_view", "conf2"), res_k, res_n):
        require(torch.isfinite(a).all().item() and torch.isfinite(b).all().item(), f"{name}: non-finite output")
        rel = ((a - b).norm() / b.norm()).item()
        print(f"[5 model {trunk}] {name:20s} {tuple(a.shape)} rel err {rel:.3e} (tol {tol}), |max| {a.abs().max().item():.3e}")
        require(rel <= tol, f"{name}: kernel vs plain relative error {rel} > {tol} ({trunk} trunk)")
    print(f"[5 model {trunk}] forward_pair at batch {BATCH}: kernels {kernel_ms:.2f} ms, plain path {naive_ms:.2f} ms")


def phase_serve(torch, np, serve, model, fa, rope, card):
    frames = np.random.RandomState(SEED).randint(0, 256, size=(2 * PAIRS, IMG, IMG, 3), dtype=np.uint8)
    fn = serve.make_serving_fn(model, "cuda")
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = rope.rope_2d_kernel.launches = 0
    out, pairs, seconds = serve.serve_frames(fn, frames, BATCH, "cuda")
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": fa.flash_attention.launches, "rope2d": rope.rope_2d_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"[6 serve] {pairs} pairs in {seconds:.4f}s = {pairs / seconds:.3f} pairs/s at {IMG}x{IMG} batch {BATCH} "
          f"(CUDA events, after one warm-up batch) on {card}")
    print(f"[6 serve] max_memory_allocated {peak} bytes ({peak / 2**30:.3f} GiB); launches {launches}")
    shapes = [tuple(o.shape) for o in out]
    print(f"[6 serve] output shapes {shapes}")
    require(shapes == [(BATCH, IMG, IMG, 3), (BATCH, IMG, IMG, 1)] * 2, f"unexpected output shapes {shapes}")
    require(all(torch.isfinite(o).all().item() for o in out), "non-finite serving output")
    require(all(n > 0 for n in launches.values()), f"a kernel of the path was never launched: {launches}")
    return launches, {"pairs_per_s": pairs / seconds, "peak": peak}


def _bwd_cases(torch, gen):
    "The phase-3 shapes with strided q/k/v views and an output gradient, in fp32."
    for name, B, Nq, Nk, H in (
        ("encoder 512", 4, 1024, 1024, 16),
        ("decoder 512", 2, 1024, 1024, 12),
        ("encoder 224", 4, 196, 196, 16),
        ("Nq != Nk", 2, 300, 1000, 12),
    ):
        xq = torch.randn(B, Nq, 3, H, 64, device="cuda", generator=gen)
        xkv = xq if Nq == Nk else torch.randn(B, Nk, 3, H, 64, device="cuda", generator=gen)
        dout = torch.randn(B, Nq, H, 64, device="cuda", generator=gen)
        yield name, xq, xkv, dout


def phase_lse(torch, fa):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for name, xq, xkv, _ in _bwd_cases(torch, gen):
        for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q, k, v = xq.to(dt)[:, :, 0], xkv.to(dt)[:, :, 1], xkv.to(dt)[:, :, 2]
            out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
            same = torch.equal(out, fa.flash_attention_fwd(q, k, v)[0])
            err = (lse - fa.flash_attention_lse_ref(q.float(), k.float(), v.float())[1]).abs().max().item()
            line = f"[7 K1+LSE] {name:12s} {label}: output equals the no-LSE kernel's: {same}; LSE max|err| {err:.3e}"
            if label == "bf16":
                ms = graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, with_lse=True))
                plain_ms = graph_ms(torch, lambda: fa.flash_attention_lse_ref(q, k, v))
                line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA graph)"
            print(line + f" (tol {LSE_TOL[label]})")
            require(same, f"K1+LSE {name} {label}: the LSE write changed the output")
            require(err <= LSE_TOL[label], f"K1+LSE {name} {label}: LSE error {err} > {LSE_TOL[label]}")


def phase_flash_bwd(torch, fa):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst_abs, main_ms, main_plain_ms = 0.0, None, None
    for name, xq, xkv, dout32 in _bwd_cases(torch, gen):
        for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q, k, v = xq.to(dt)[:, :, 0], xkv.to(dt)[:, :, 1], xkv.to(dt)[:, :, 2]
            dout = dout32.to(dt)
            out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, dout)
            refs = fa.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, lse, dout)))
            qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
            auto = torch.autograd.grad(fa.flash_attention_ref(qf, kf, vf), (qf, kf, vf), dout.float())
            rels, rels_auto = [], []
            for g, r, a in zip(grads, refs, auto):
                require(torch.isfinite(g).all().item(), f"K3 {name} {label}: non-finite gradient")
                rels.append(((g.float() - r).abs().max() / r.abs().max()).item())
                rels_auto.append(((g.float() - a).abs().max() / a.abs().max()).item())
                if label == "bf16":
                    worst_abs = max(worst_abs, (g.float() - r).abs().max().item())
            line = (f"[8 K3] {name:12s} {label}: max|err|/max|ref| dq dk dv {rels[0]:.2e} {rels[1]:.2e} {rels[2]:.2e}"
                    f" (vs autograd of the plain forward {max(rels_auto):.2e}; tol {K3_REL_TOL[label]})")
            if label == "bf16":
                ms = graph_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout))
                plain_ms = graph_ms(torch, lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, dout))
                line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA graph)"
                if main_ms is None:
                    main_ms, main_plain_ms = ms, plain_ms
            print(line)
            require(max(rels + rels_auto) <= K3_REL_TOL[label], f"K3 {name} {label}: error {max(rels + rels_auto)}")
    return worst_abs, main_ms, main_plain_ms


def phase_rope_bwd(torch, rope, make_patch_positions):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst_abs = 0.0
    for B, H in ((4, 16), (2, 12)):
        pos = make_patch_positions(B, 32, 32, device="cuda")
        x = torch.randn(B, 1024, 3, H, 64, device="cuda", generator=gen)
        g32 = torch.randn(B, 1024, H, 64, device="cuda", generator=gen)
        line = f"[9 K2 bwd] B={B} N=1024 H={H} D=64:"
        for label, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            t = x.to(dt)[:, :, 0].requires_grad_()
            g = g32.to(dt)
            (got,) = torch.autograd.grad(rope.rope_2d_kernel(t, pos), t, g)
            (ref,) = torch.autograd.grad(rope.rope_2d(t, pos), t, g)
            err = (got.float() - ref.float()).abs().max().item()
            if label == "fp32":
                line += f" fp32 max|err| {err:.3e} (tol {K2_FP32_TOL}),"
                require(err <= K2_FP32_TOL, f"K2 bwd: fp32 error {err} > {K2_FP32_TOL}")
            else:
                ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)
                ulps = ((got.float() - ref.float()).abs() / ulp).max().item()
                worst_abs = max(worst_abs, err)
                # the backward's launch (rotation by -F0) against the plain rotation by -F0
                ms = graph_ms(torch, lambda: rope.rope_2d_kernel(g, pos, f0=-1.0))
                plain_ms = graph_ms(torch, lambda: rope.rope_2d(g, pos, f0=-1.0))
                line += f" bf16 {ulps:.2f} ulp (tol {K2_BF16_ULPS}); bf16 backward kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                require(ulps <= K2_BF16_ULPS, f"K2 bwd: bf16 error {ulps} ulp > {K2_BF16_ULPS}")
        print(line)
    return worst_abs


def _train_batch(torch, train, serve_mod, model):
    "One batch of BATCH synthetic pairs from SEED, through the trainer's sampler and normalizer."
    sampler = iter(train.DeterministicSampler(train.synthetic_dataset(2 * BATCH, IMG, SEED), BATCH, seed=SEED))
    prep = serve_mod.make_frame_normalizer(model.data_norm_type, "cuda")
    b = next(sampler)
    return prep(b["img1"]), prep(b["img2"]), torch.from_numpy(b["pts1"]).cuda(), torch.from_numpy(b["pts2"]).cuda()


def _loss_and_grads(torch, training, config, model, batch, impl):
    config.set_attention_impl(impl)
    try:
        params = [p for p in model.parameters()]
        res1, res2 = model.forward_pair(batch[0], batch[1])
        loss = training.dust3r_confidence_loss(res1, res2, batch[2], batch[3])
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
    finally:
        config.set_attention_impl("kernel")
    return loss.detach(), grads


def phase_train_grads(torch, train, serve_mod, training, config, build):
    """One step's loss and gradients through the kernels against the plain path, fp32 trunk then bf16 trunk.
    Returns the bf16 model (fp32 parameters) for the training phases."""
    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    def flat(gs):
        return torch.cat([g.float().flatten() for g in gs])

    model32 = build(None)
    names = [n for n, _ in model32.named_parameters()]
    batch = _train_batch(torch, train, serve_mod, model32)
    lk, gk = _loss_and_grads(torch, training, config, model32, batch, "kernel")
    ln32, gn32 = _loss_and_grads(torch, training, config, model32, batch, "naive")
    worst = max(zip((rel(a, b) for a, b in zip(gk, gn32)), names))
    loss_rel = abs(lk.item() - ln32.item()) / abs(ln32.item())
    print(f"[10 train fp32] loss kernels {lk.item():.6f} plain {ln32.item():.6f} (rel {loss_rel:.2e}); worst gradient "
          f"rel err over {len(names)} parameters {worst[0]:.3e} ({worst[1]}) (tol {TRAIN_FP32_REL_TOL})")
    require(torch.isfinite(lk).item() and all(torch.isfinite(g).all().item() for g in gk), "fp32 step: non-finite")
    require(loss_rel <= TRAIN_FP32_REL_TOL and worst[0] <= TRAIN_FP32_REL_TOL, f"fp32 step: kernels vs plain {worst}")
    del model32, gk
    torch.cuda.empty_cache()

    model = build(torch.bfloat16)
    lk, gk = _loss_and_grads(torch, training, config, model, batch, "kernel")
    ln, gn = _loss_and_grads(torch, training, config, model, batch, "naive")
    loss_rel = abs(lk.item() - ln.item()) / abs(ln.item())
    print(f"[10 train bf16] loss kernels {lk.item():.6f} plain {ln.item():.6f} (rel {loss_rel:.2e}; bf16-plain vs "
          f"fp32-plain {abs(ln.item() - ln32.item()) / abs(ln32.item()):.2e}) (tol {TRAIN_BF16_LOSS_TOL})")
    for label, xs, ys in (("kernels vs plain", gk, gn), ("bf16-plain vs fp32-plain", gn, gn32),
                          ("kernels vs fp32-plain", gk, gn32)):
        r = sorted(zip((rel(a, b) for a, b in zip(xs, ys)), names), reverse=True)
        vals = sorted(x for x, _ in r)
        print(f"[10 train bf16] gradients, {label}: all together {rel(flat(xs), flat(ys)):.3e}; per parameter median "
              f"{vals[len(vals) // 2]:.3e}, p90 {vals[int(len(vals) * 0.9)]:.3e}, worst {[(f'{x:.3e}', n) for x, n in r[:3]]}")
    worst = max(zip((rel(a, b) for a, b in zip(gk, gn)), names))
    glob = rel(flat(gk), flat(gn))
    print(f"[10 train bf16] kernels vs plain: worst parameter {worst[0]:.3e} (tol {TRAIN_BF16_REL_TOL}), all gradients "
          f"together {glob:.3e} (tol {TRAIN_BF16_GLOBAL_TOL})")
    require(torch.isfinite(lk).item() and all(torch.isfinite(g).all().item() for g in gk), "bf16 step: non-finite")
    require(loss_rel <= TRAIN_BF16_LOSS_TOL, f"bf16 step: loss kernels vs plain {loss_rel} > {TRAIN_BF16_LOSS_TOL}")
    require(worst[0] <= TRAIN_BF16_REL_TOL, f"bf16 step: kernels vs plain {worst}")
    require(glob <= TRAIN_BF16_GLOBAL_TOL, f"bf16 step: all gradients kernels vs plain {glob} > {TRAIN_BF16_GLOBAL_TOL}")
    del gk, gn, gn32
    torch.cuda.empty_cache()
    return model


def phase_train(torch, train, serve_mod, training, config, fa, rope, model, card):
    "make_train_step on the bf16 model: exact launches per step, finite losses, ms/step against the plain path."
    ctx = training.make_train_step(model, learning_rate=1e-4)
    batch = _train_batch(torch, train, serve_mod, model)
    before = [p.detach().clone() for p in ctx.params[:4]]
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = fa.flash_attention.lse_launches = fa.flash_attention_bwd.launches = 0
    rope.rope_2d_kernel.launches = rope.rope_2d_kernel.backward_launches = 0
    losses = [ctx.step(*batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = {
        "flash_attention_fwd": fa.flash_attention.launches, "flash_attention_lse": fa.flash_attention.lse_launches,
        "flash_attention_bwd": fa.flash_attention_bwd.launches, "rope2d_fwd": rope.rope_2d_kernel.launches,
        "rope2d_bwd": rope.rope_2d_kernel.backward_launches,
    }
    peak = torch.cuda.max_memory_allocated()
    attn = ENC_DEPTH + DEC_DEPTH * 2 * 2
    want = {"flash_attention_fwd": attn, "flash_attention_lse": attn, "flash_attention_bwd": attn,
            "rope2d_fwd": 2 * attn, "rope2d_bwd": 2 * attn}  # per step; K2 on q and k of every attention
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"[10 train] launches per step {per_step} (want {want}) over {TRAIN_STEPS} steps")
    require(per_step == want, f"training launches per step {per_step}, want {want}")
    losses = [x.item() for x in losses]
    print(f"[10 train] {TRAIN_STEPS} AdamW steps at batch {BATCH}, lr 1e-4: losses {['%.4f' % x for x in losses]}")
    require(all(map(math.isfinite, losses)), f"non-finite training loss: {losses}")
    moved = [not torch.equal(a, p) for a, p in zip(before, ctx.params)]
    require(all(moved), "a parameter did not move")
    state = {t.dtype for t in ctx.optimizer.mu + ctx.optimizer.nu} | {p.dtype for p in ctx.params}
    require(state == {torch.float32}, f"parameters and optimizer state must be fp32, got {state}")

    def timed(impl):
        config.set_attention_impl(impl)
        try:
            return cuda_ms(torch, lambda: ctx.step(*batch), warmup=TRAIN_WARMUP, iters=5)
        finally:
            config.set_attention_impl("kernel")

    plain_ms = timed("naive")
    kernel_ms = timed("kernel")
    print(f"[10 train] ms/step at batch {BATCH} (CUDA events, after {TRAIN_WARMUP} warm-up steps): kernels "
          f"{kernel_ms:.2f} ms = {BATCH * 1e3 / kernel_ms:.3f} training pairs/s, plain path {plain_ms:.2f} ms = "
          f"{BATCH * 1e3 / plain_ms:.3f} pairs/s; max_memory_allocated over the {TRAIN_STEPS} kernel steps {peak} "
          f"bytes ({peak / 2**30:.3f} GiB) on {card}")
    require(all(v > 0 for v in launches.values()), f"a kernel of the training path was never launched: {launches}")
    return launches


def _ulps(out, ref, mantissa_bits, floor=2.0**-126):
    "Max |out - ref| in units of the last place of max(|ref|, floor) (bf16: 7 mantissa bits, fp32: 23)."
    import torch

    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(floor))) - mantissa_bits)
    return ((out.float() - ref.float()).abs() / ulp).max().item()


K4_SHAPES = [  # (layer, M tokens, K, N): encoder at batch 2 pairs (4 images), decoder per view (2 images)
    ("enc qkv", 4096, 1024, 3072), ("enc proj", 4096, 1024, 1024), ("enc fc1", 4096, 1024, 4096),
    ("enc fc2", 4096, 4096, 1024), ("dec proj_embed", 2048, 1024, 768), ("dec qkv", 2048, 768, 2304),
    ("dec proj", 2048, 768, 768), ("dec fc1", 2048, 768, 3072), ("dec fc2", 2048, 3072, 768),
]


def phase_int8_matmul(torch, i8):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst_abs, main_ms, main_plain_ms, probed = 0.0, None, None, {}
    for name, M, K, N in K4_SHAPES:
        x32 = torch.randn(M, K, device="cuda", generator=gen)
        w_q = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8).t()  # (K, N) view
        w_scale = torch.rand(1, N, device="cuda", generator=gen) * 1e-3 + 1e-5
        bias = torch.randn(N, device="cuda", generator=gen)
        line = f"[11 K4] {name:15s} M={M} K={K} N={N}:"
        for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            x = x32.to(dt)
            out, ref = i8.int8_matmul_dynamic(x, w_q, w_scale, bias), i8.int8_matmul_dynamic_ref(x, w_q, w_scale, bias)
            require(torch.isfinite(out).all().item(), f"K4 {name} {label}: non-finite output")
            if (M, K, label) not in probed:
                # the kernel's int8 codes, read back through an identity weight: y = code * a_scale
                eye = torch.eye(K, device="cuda", dtype=torch.int8)
                x_q, a_scale = i8.quantize_rows(x)
                codes = torch.round(i8.int8_matmul_dynamic(x, eye, torch.ones(1, K, device="cuda"),
                                                           out_dtype=torch.float32) / a_scale)
                probed[(M, K, label)] = (codes == x_q.float()).float().mean().item()
            ulps = _ulps(out, ref, 7 if label == "bf16" else 23)
            line += f" {label} codes equal {probed[(M, K, label)]:.6f}, max {ulps:.1f} ulp (tol {K4_ULPS});"
            require(probed[(M, K, label)] == 1.0, f"K4 {name} {label}: the kernel's int8 codes differ")
            require(ulps <= K4_ULPS, f"K4 {name} {label}: {ulps} ulp > {K4_ULPS}")
            if label == "bf16":
                worst_abs = max(worst_abs, (out.float() - ref.float()).abs().max().item())
                ms = graph_ms(torch, lambda: i8.int8_matmul_dynamic(x, w_q, w_scale, bias))
                plain_ms = graph_ms(torch, lambda: i8.int8_matmul_dynamic_ref(x, w_q, w_scale, bias))
                line += f" bf16 kernel {ms:.4f} ms ({2 * M * K * N / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms;"
                if main_ms is None:
                    main_ms, main_plain_ms = ms, plain_ms
        print(line)
    return worst_abs, main_ms, main_plain_ms


def k6_check(out, ref, exact):
    """K6's check of ``out`` against its plain version's ``ref``: (ulps, gap to exact attention, the plain
    version's gap, the reasons it fails, empty when it passes)."""
    ulps = _ulps(out, ref, 7, floor=K6_ULP_FLOOR)
    rel = ((out.float() - exact).norm() / exact.norm()).item()
    rel_plain = ((ref.float() - exact).norm() / exact.norm()).item()
    fails = [f"{ulps:.1f} ulp > {K6_ULPS}"] if ulps > K6_ULPS else []
    if abs(rel - rel_plain) > K6_EXACT_SLACK:
        fails.append(f"{rel:.3e} from exact attention, the plain version {rel_plain:.3e}")
    return ulps, rel, rel_plain, fails


def phase_int8_attention(torch, fa):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst, main_ms, main_plain_ms = 0.0, None, None
    for name, B, Nq, Nk, H in (("encoder 512", 4, 1024, 1024, 16), ("decoder 512", 2, 1024, 1024, 12),
                               ("encoder 224", 4, 196, 196, 16), ("Nq != Nk", 2, 300, 1000, 12)):
        xq = torch.randn(B, Nq, 3, H, 64, device="cuda", generator=gen).bfloat16()
        xkv = xq if Nq == Nk else torch.randn(B, Nk, 3, H, 64, device="cuda", generator=gen).bfloat16()
        q, k, v = xq[:, :, 0], xkv[:, :, 1], xkv[:, :, 2]
        exact = fa.flash_attention_ref(q.float(), k.float(), v.float())
        k1_out = fa.flash_attention(q, k, v)
        k1_ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v))
        outs = {mode: fa.flash_attention_int8(q, k, v, mode=mode) for mode in ("int8", "int8pv")}
        for mode, other in (("int8", "int8pv"), ("int8pv", "int8")):
            out, ref = outs[mode], fa.flash_attention_int8_ref(q, k, v, mode=mode)
            require(torch.isfinite(out).all().item(), f"K6 {name} {mode}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            ulps, rel, rel_plain, fails = k6_check(out, ref, exact)
            # controls: the bf16 kernel K1 and the kernel in the other mode must fail the same check
            ctrl_k1, ctrl_other = k6_check(k1_out, ref, exact)[3], k6_check(outs[other], ref, exact)[3]
            ms = graph_ms(torch, lambda: fa.flash_attention_int8(q, k, v, mode=mode))
            plain_ms = graph_ms(torch, lambda: fa.flash_attention_int8_ref(q, k, v, mode=mode))
            print(f"[12 K6] {name:12s} B={B} Nq={Nq} Nk={Nk} H={H} {mode:6s}: vs plain {ulps:.2f} ulp (tol {K6_ULPS}), "
                  f"max|err| {err:.3e}; vs exact attention {rel:.3e} (plain version {rel_plain:.3e}, tol +- "
                  f"{K6_EXACT_SLACK}; the JAX test's bound {K6_EXACT_REL_TOL[mode]}: "
                  f"{'within' if rel <= K6_EXACT_REL_TOL[mode] else 'over'}); controls fail: K1 {ctrl_k1}, {other} "
                  f"{ctrl_other}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, K1 bf16 {k1_ms:.4f} ms (CUDA graph)")
            require(not fails, f"K6 {name} {mode}: {fails}")
            require(ctrl_k1 and ctrl_other, f"K6 {name} {mode}: a control passed the check (K1 {ctrl_k1}, {other} "
                                            f"{ctrl_other})")
            worst = max(worst, err)
            if main_ms is None:
                main_ms, main_plain_ms = ms, plain_ms
    return worst, main_ms, main_plain_ms


K7_SHAPES = [  # (convs at 512 per head, H = W, C, Co), batch 2: the eligible convs of one DPT head
    ("layer3_rn", 32, 384, 256), ("layer4_rn", 16, 768, 256), ("refinenet4 RCU", 16, 256, 256),
    ("refinenet3 RCU", 32, 256, 256), ("refinenet2 RCU", 64, 256, 256), ("refinenet1 RCU", 128, 256, 256),
    ("regressor conv1", 256, 256, 128),
]


def phase_conv3x3(torch, F, c3):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst, main = 0.0, None
    for name, hw, C, Co in K7_SHAPES:
        x = torch.randn(BATCH, hw, hw, C, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(3, 3, C, Co, device="cuda", generator=gen) * (9 * C) ** -0.5).bfloat16()
        b = torch.randn(Co, device="cuda", generator=gen) * 0.1
        out, ref = c3.conv3x3_nhwc(x, w, b), c3.conv3x3_reference(x, w, b)
        require(torch.isfinite(out).all().item(), f"K7 {name}: non-finite output")
        ulps = _ulps(out, ref, 7, floor=1 / 16)
        ms = graph_ms(torch, lambda: c3.conv3x3_nhwc(x, w, b))
        plain_ms = graph_ms(torch, lambda: c3.conv3x3_reference(x, w, b))
        # what the stock path runs: the bf16 conv (cuDNN) of a channels_last NCHW view
        xc, wc, bc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), b.bfloat16()
        stock_ms = graph_ms(torch, lambda: F.conv2d(xc, wc, bc, padding=1))
        flops = 2 * BATCH * hw * hw * C * Co * 9
        print(f"[13 K7] {name:16s} {BATCH}x{hw}x{hw}x{C} -> {Co}: {ulps:.2f} ulp (tol {K7_ULPS}); kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain (fp32 conv) {plain_ms:.4f} ms, stock bf16 conv {stock_ms:.4f} ms")
        require(ulps <= K7_ULPS, f"K7 {name}: {ulps} ulp > {K7_ULPS}")
        worst = max(worst, (out.float() - ref.float()).abs().max().item())
        if name == "refinenet1 RCU":
            main = (ms, plain_ms)
    return worst, main[0], main[1]


def k7_convs_per_forward(img):
    """The DPT convs the K7 rule (nn/dpt_parts.py Conv2dTorch.takes_conv3x3) sends to the kernel in one
    forward_pair at img x img: 3x3 / stride 1 with C and Co multiples of 128 at H * W <= 256^2, per head."""
    g = img // 16  # the token grid
    convs = [  # (H = W of the conv's input, C, Co) of every 3x3 / stride-1 conv (act_4's conv has stride 2)
        (4 * g, 96, 256), (2 * g, 192, 256), (g, 384, 256), (g // 2, 768, 256),  # layer1_rn .. layer4_rn
        *[(g // 2, 256, 256)] * 2, *[(g, 256, 256)] * 4, *[(2 * g, 256, 256)] * 4, *[(4 * g, 256, 256)] * 4,  # RCUs
        (8 * g, 256, 128), (img, 128, 128),  # regressor conv1, conv2
    ]
    return 2 * sum(hw * hw <= 256 * 256 and C % 128 == 0 and Co % 128 == 0 for hw, C, Co in convs)


def _kernel_counters(fa, rope, i8, c3):
    return {"K1": fa.flash_attention, "K2": rope.rope_2d_kernel, "K4": i8.int8_matmul_dynamic,
            "K6": fa.flash_attention_int8, "K7": c3.conv3x3_nhwc}


def _reset(counters):
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    return {name: fn.launches for name, fn in counters.items()}


def phase_int8_dpt(torch, np, serve, config, quant, fa, counters):
    """DUSt3R 512 DPT: the bf16 plain path, then the same weights quantized, three ways: every kernel (K4, K6, K7;
    each K6 call held against its plain version on the same inputs), K6 on its plain version (K4 and K7 still the
    kernels), and the plain path. Exact launches per forward_pair, the trunk and the outputs against the plain path,
    and the int8 bill (int8 plain vs bf16 plain)."""
    import uniception_tpu_torch.ops.attention as attention

    frames = np.random.RandomState(SEED).randint(0, 256, size=(2 * BATCH, IMG, IMG, 3), dtype=np.uint8)
    img1, img2 = frames[0::2], frames[1::2]
    model = serve.build_model(IMG, ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, device="cuda",
                              seed=SEED, head="dpt", head_dtype=torch.bfloat16)
    fn = serve.make_serving_fn(model, "cuda")
    trunk = []  # the decoder's final features of both views, per forward
    trunk_hook = model.info_sharing.register_forward_hook(
        lambda mod, inp, out: trunk.append(torch.cat([f.float().flatten() for f in out[0].features])))

    def forward(impl="kernel", k6=fa.flash_attention_int8):
        config.set_attention_impl(impl)
        attention.flash_attention_int8 = k6
        try:
            res = fn(img1, img2)
            torch.cuda.synchronize()
            return res, trunk.pop()
        finally:
            config.set_attention_impl("kernel")
            attention.flash_attention_int8 = fa.flash_attention_int8

    res_bf16, trunk_bf16 = forward("naive")  # the bf16-DPT rung's plain path
    n_q = quant.quantize_trunk(model, "all")
    calls = [0]
    hooks = [m.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
             for m in model.modules() if isinstance(m, quant.Int8Linear)]
    k6_ulps, k6_ctrl = [], []

    def k6_checked(q, k, v, scale=None, mode="int8"):
        "K6, held against its plain version on the same inputs; exact attention through the same check as a control."
        out = fa.flash_attention_int8(q, k, v, scale, mode)
        ref = fa.flash_attention_int8_ref(q, k, v, scale, mode)
        k6_ulps.append(_ulps(out, ref, 7, floor=K6_ULP_FLOOR))
        k6_ctrl.append(_ulps(fa.flash_attention_ref(q, k, v, scale), ref, 7, floor=K6_ULP_FLOOR))
        return out

    config.set_attention_quant("int8")
    config.set_conv3x3_impl("kernel")
    try:
        _reset(counters)
        res_k, trunk_k = forward(k6=k6_checked)
        launches, k4_calls = _read(counters), calls[0]
        for h in hooks:
            h.remove()
        _reset(counters)
        res_s, trunk_s = forward(k6=fa.flash_attention_int8_ref)  # K6 on its plain version
        split_launches = _read(counters)
        _reset(counters)
        res_n, trunk_n = forward("naive")
        naive_launches = _read(counters)
        trunk_hook.remove()
        config.set_attention_impl("naive")
        try:
            naive_ms = cuda_ms(torch, lambda: fn(img1, img2), warmup=1, iters=3)
        finally:
            config.set_attention_impl("kernel")
        kernel_ms = cuda_ms(torch, lambda: fn(img1, img2), warmup=1, iters=3)
    finally:
        config.set_attention_quant("none")
        config.set_conv3x3_impl("torch")
    attn = ENC_DEPTH + DEC_DEPTH * 2 * 2
    # K4: qkv, proj, fc1, fc2 of each encoder block; proj_embed once per view; 8 linears per decoder block and view
    k4 = ENC_DEPTH * 4 + (2 if ENC_DIM != DEC_DIM else 0) + DEC_DEPTH * 2 * 8
    want = {"K1": 0, "K2": 2 * attn, "K4": k4, "K6": attn, "K7": k7_convs_per_forward(IMG)}
    print(f"[14 int8-DPT] {n_q} trunk linears quantized; launches per forward_pair {launches} (want {want}); calls into "
          f"quantized layers {k4_calls}; with K6 on its plain version {split_launches}; the naive path's "
          f"{naive_launches}")
    require(launches == want, f"int8-DPT launches {launches}, want {want}")
    require(k4_calls == want["K4"], f"{k4_calls} calls into quantized layers, want {want['K4']}")
    require(split_launches == dict(want, K6=0), f"int8-DPT with K6 on its plain version: launches {split_launches}")
    require(not any(naive_launches.values()), "the naive path launched a kernel")

    ctrl = sorted(k6_ctrl)
    print(f"[14 int8-DPT] K6 on the path, each of {len(k6_ulps)} calls against its plain version on the same inputs: "
          f"max {max(k6_ulps):.2f} ulp (tol {K6_ULPS}); exact attention on the same inputs (the control): "
          f"{sum(c > K6_ULPS for c in ctrl)} calls over the tol, ulps min {ctrl[0]:.2f} median {ctrl[len(ctrl) // 2]:.2f} "
          f"max {ctrl[-1]:.2f}")
    require(max(k6_ulps) <= K6_ULPS, f"int8-DPT: a K6 call is {max(k6_ulps)} ulp from its plain version")
    require(max(k6_ctrl) > K6_ULPS, f"int8-DPT: exact attention passed K6's check ({max(k6_ctrl)} ulp)")

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    trunk_split_equal = torch.equal(trunk_s, trunk_n)
    trunk_rel, trunk_bill = rel(trunk_k, trunk_n), rel(trunk_n, trunk_bf16)
    print(f"[14 int8-DPT] decoder features: with K6 on its plain version equal to the plain path: {trunk_split_equal}; "
          f"every kernel vs plain {trunk_rel:.3e} (tol {INT8_TRUNK_REL_TOL}); the int8 bill, int8 plain vs bf16 plain "
          f"{trunk_bill:.3e}")
    require(trunk_split_equal, "int8-DPT: with K6 on its plain version the trunk is not the plain path's (K4 moved it)")
    require(trunk_rel <= INT8_TRUNK_REL_TOL, f"int8-DPT trunk features: kernel vs plain {trunk_rel} > {INT8_TRUNK_REL_TOL}")
    for name, a, s_, b, c in zip(("pts3d", "conf1", "pts3d_in_other_view", "conf2"), res_k, res_s, res_n, res_bf16):
        require(all(torch.isfinite(t).all().item() for t in (a, s_, b, c)), f"{name}: non-finite output")
        r_k, r_s, bill = rel(a, b), rel(s_, b), rel(b, c)
        print(f"[14 int8-DPT] {name:20s} {tuple(a.shape)} vs plain: every kernel {r_k:.3e} (tol {INT8_MODEL_REL_TOL}), "
              f"K7 alone (K6 plain) {r_s:.3e} (tol {K7_HEADS_REL_TOL}); the int8 bill {bill:.3e}; kernels vs bf16 "
              f"plain {rel(a, c):.3e}")
        require(r_s <= K7_HEADS_REL_TOL, f"int8-DPT {name}: K7 alone moves the output by {r_s} > {K7_HEADS_REL_TOL}")
        require(r_k <= INT8_MODEL_REL_TOL, f"int8-DPT {name}: kernel vs plain {r_k} > {INT8_MODEL_REL_TOL}")
    print(f"[14 int8-DPT] forward_pair at batch {BATCH}: kernels {kernel_ms:.2f} ms, plain path {naive_ms:.2f} ms")
    del model, fn
    torch.cuda.empty_cache()
    return launches


def phase_serving_rungs(torch, np, serve, config, counters, card, bf16_linear):
    "Pairs/s and peak memory of the int8-linear, bf16-DPT (fp32 heads) and int8-DPT serving runs, and a profile."
    frames = np.random.RandomState(SEED).randint(0, 256, size=(2 * BATCH * (SERVE_BATCHES + 1), IMG, IMG, 3),
                                                 dtype=np.uint8)
    rungs = [  # (name, build_model options, attention quant, conv3x3 impl); bench.py's default is int8-linear
        ("int8-linear", dict(head="linear", int8=True), "none", "torch"),
        ("bf16-DPT fp32 heads", dict(head="dpt"), "none", "torch"),
        ("int8-DPT", dict(head="dpt", head_dtype=torch.bfloat16, int8=True), "int8", "kernel"),
    ]
    results = {"bf16-linear": bf16_linear}
    print(f"[15 serve] bf16-linear: {bf16_linear['pairs_per_s']:.3f} pairs/s, peak {bf16_linear['peak']} bytes "
          f"(phase 6)")
    for name, options, attn_quant, conv in rungs:
        model = serve.build_model(IMG, ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, device="cuda",
                                  seed=SEED, **options)
        fn = serve.make_serving_fn(model, "cuda")
        config.set_attention_quant(attn_quant)
        config.set_conv3x3_impl(conv)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(counters)
            out, pairs, seconds = serve.serve_frames(fn, frames, BATCH, "cuda")
            torch.cuda.synchronize()
            launches, peak = _read(counters), torch.cuda.max_memory_allocated()
            if name == "int8-DPT":
                profile_serving(torch, fn, frames)
        finally:
            config.set_attention_quant("none")
            config.set_conv3x3_impl("torch")
        shapes = [tuple(o.shape) for o in out]
        require(shapes == [(BATCH, IMG, IMG, 3), (BATCH, IMG, IMG, 1)] * 2, f"{name}: output shapes {shapes}")
        require(all(torch.isfinite(o).all().item() for o in out), f"{name}: non-finite serving output")
        print(f"[15 serve] {name}: {pairs} pairs in {seconds:.4f}s = {pairs / seconds:.3f} pairs/s at {IMG}x{IMG} batch "
              f"{BATCH} (CUDA events, after one warm-up batch); max_memory_allocated {peak} bytes ({peak / 2**30:.3f} "
              f"GiB); launches {launches} on {card}")
        results[name] = {"pairs_per_s": pairs / seconds, "peak": peak, "launches": launches}
        del model, fn, out
        torch.cuda.empty_cache()
    require(results["int8-DPT"]["launches"]["K1"] == 0, "the int8-DPT rung launched the bf16 attention kernel")
    require(all(results["int8-DPT"]["launches"][k] > 0 for k in ("K2", "K4", "K6", "K7")),
            f"a kernel of the int8-DPT path was never launched: {results['int8-DPT']['launches']}")
    require(results["int8-linear"]["launches"]["K4"] > 0, "the int8-linear rung never launched K4")
    return results


def profile_serving(torch, fn, frames):
    "Device time by kernel over 3 serving batches (torch.profiler), the top entries and the device-busy share."
    from torch.profiler import ProfilerActivity, profile

    batches = [(frames[2 * i : 2 * i + 2 * BATCH : 2], frames[2 * i + 1 : 2 * i + 2 * BATCH : 2]) for i in range(3)]
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for img1, img2 in batches:
            fn(img1, img2)
        stop.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(stop)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[15 profile int8-DPT] 3 batches: {total:.2f} ms of device time in a {window:.2f} ms window "
          f"(busy share {total / window:.3f}, profiler overhead included)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms / 3:8.3f} ms/batch {100 * ms / total:5.1f}% {e.count // 3:5d} calls/batch  {e.key[:90]}")


def main():
    if not os.path.isfile(os.path.join(REPO, "uniception_tpu_torch", "csrc", "flash_attention.cu")):
        print("chip_smoke: run from a checkout that holds uniception_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references are full fp32
    torch.backends.cudnn.allow_tf32 = False

    from uniception_tpu_torch import serve, train
    from uniception_tpu_torch.models.factory.dust3r import DUSt3R
    from uniception_tpu_torch.models.utils import config
    from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
    from uniception_tpu_torch.nn import quant
    from uniception_tpu_torch.ops import conv3x3 as c3
    from uniception_tpu_torch.ops import flash_attention as fa
    from uniception_tpu_torch.ops import int8_matmul as i8
    from uniception_tpu_torch.ops import kernel_lib, rope
    from uniception_tpu_torch.parallel import training

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    card = phase_card()
    phase_build(kernel_lib)
    k1_err, k1_ms, k1_plain_ms = phase_flash_attention(torch, fa)
    k2_err, k2_ms, k2_plain_ms = phase_rope(torch, rope, make_patch_positions)

    def build(dtype):
        return serve.build_model(
            IMG, ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, device="cuda", dtype=dtype, seed=SEED
        )

    phase_model(torch, np, serve, build(torch.float32), config, fa, rope, MODEL_FP32_REL_TOL)
    torch.cuda.empty_cache()
    model = build(torch.bfloat16)
    phase_model(torch, np, serve, model, config, fa, rope, MODEL_REL_TOL)
    launches, bf16_linear = phase_serve(torch, np, serve, model, fa, rope, card)
    require(fa.flash_attention.lse_launches == 0, "the serving path wrote a logsumexp")
    del model
    torch.cuda.empty_cache()

    phase_lse(torch, fa)
    k3_err, k3_ms, k3_plain_ms = phase_flash_bwd(torch, fa)
    k2_err = max(k2_err, phase_rope_bwd(torch, rope, make_patch_positions))

    def build_train(dtype):  # bench_train.py's configuration: fp32 parameters, compute in dtype
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return DUSt3R(name="dust3r_train", img_size=(IMG, IMG), patch_embed_cls="ManyAR_PatchEmbed",
                      dtype=dtype, device="cuda", generator=gen)

    model = phase_train_grads(torch, train, serve, training, config, build_train)
    trained = phase_train(torch, train, serve, training, config, fa, rope, model, card)
    del model
    torch.cuda.empty_cache()

    import torch.nn.functional as F

    k4_err, k4_ms, k4_plain_ms = phase_int8_matmul(torch, i8)
    k6_err, k6_ms, k6_plain_ms = phase_int8_attention(torch, fa)
    k7_err, k7_ms, k7_plain_ms = phase_conv3x3(torch, F, c3)
    counters = _kernel_counters(fa, rope, i8, c3)
    dpt = phase_int8_dpt(torch, np, serve, config, quant, fa, counters)
    rungs = phase_serving_rungs(torch, np, serve, config, counters, card, bf16_linear)
    served = {k: sum(rungs[r]["launches"][k] for r in ("int8-linear", "bf16-DPT fp32 heads", "int8-DPT")) + dpt[k]
              for k in counters}

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": "uniception_tpu_torch/csrc/flash_attention.cu",
         "replaces": "uniception_tpu/ops/flash_attention.py:194",
         "launches": launches["flash_attention_fwd"] + trained["flash_attention_fwd"] + served["K1"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "flash_attention_bwd", "route": "cuda", "source": "uniception_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "uniception_tpu/ops/flash_attention.py:436", "launches": trained["flash_attention_bwd"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "rope2d", "route": "cuda", "source": "uniception_tpu_torch/csrc/rope.cu",
         "replaces": "uniception_tpu/ops/rope.py:126",
         "launches": launches["rope2d"] + trained["rope2d_fwd"] + trained["rope2d_bwd"] + served["K2"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "int8_matmul_dynamic", "route": "cuda", "source": "uniception_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "uniception_tpu/ops/int8_matmul.py:50", "launches": served["K4"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms},
        {"name": "flash_attention_int8", "route": "cuda", "source": "uniception_tpu_torch/csrc/flash_attention_int8.cu",
         "replaces": "uniception_tpu/ops/flash_attention.py:130", "launches": served["K6"],
         "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms},
        {"name": "conv3x3_nhwc", "route": "cuda", "source": "uniception_tpu_torch/csrc/conv3x3.cu",
         "replaces": "uniception_tpu/ops/conv3x3.py:47", "launches": served["K7"],
         "max_abs_err": k7_err, "ms": k7_ms, "plain_ms": k7_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
