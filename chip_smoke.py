#!/usr/bin/env python3
"""
On-card smoke test of the PyTorch/CUDA port (``uniception_tpu_torch``).

Phases, in order; any failure raises and the script exits non-zero:
    1. card:   the GPU's name and power limit (nvidia-smi);
    2. build:  nvcc builds the kernels of uniception_tpu_torch/csrc;
    3. K1:     the flash-attention kernel against its plain version at the
               main-path shapes, N = 196, Nq != Nk and the ragged edges of
               its TMA boxes (one query, one key, 7 keys), on strided q/k/v
               views; its time, TFLOP/s and share of the bound, and the
               wrapper's host time per call and per tensor-map encoding;
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
               plain forward; its time, TFLOP/s and share of the bound beside
               SDPA's backward alone (CUDA graphs);
    9. K2 bwd: the RoPE gradient through the kernel (-F0) against autograd
               through the plain version;
   10. train:  the same DUSt3R, fp32 parameters and optimizer state: one
               step's loss and every parameter's gradient through the kernels
               against the plain path (fp32 trunk, then bf16 trunk), the
               exact launches per step, 10 AdamW steps through
               make_train_step, and ms/step against the plain path;
   11. K4:     the int8 matmul kernel at the nine trunk shapes, bf16 and fp32
               x, against its plain version: the share of equal int8 codes and
               the output's max ulp; the planner's tile and split, the call's
               and its GEMM launch's time and TOP/s beside the planner's
               alternatives, torch._int_mm alone, a bf16 F.linear of the same
               shape and torch._int_mm with eager quantization; then the GEMM
               at three shapes of few tiles and a long K loop under the
               planner's split and others, each bit for bit the unsplit one;
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
               heads, the int8-DPT rung) and a profile of the int8-DPT run
               with each kernel's device ms per batch.
   16. K5:     the fused qkv + RoPE + attention kernel, self and cross, at the
               main-path shapes, N = 196 and Nq != Nk, with and without RoPE,
               bf16 and fp32: its projection launch alone and its output
               against the plain version, with the positions dropped and with
               -F0 as controls that must fail the same check, and its
               attention launch (K1's kernel) alone on the projection's
               scratch; its time beside the plain version, the unfused kernel
               path (the qkv matmul, two K2, K1) and cuBLAS + SDPA, and the
               projection launch's beside cuBLAS's GEMMs of the same shape;
   17. fused:  DUSt3R 512 in the "fused" implementation: forward_pair against
               the plain path (fp32 and bf16 trunks) with exact launches and
               every K5 call held against its plain version on the same
               activations; the int8 rung under "fused" (no K5, no K6); the
               serving loop's pairs/s and peak memory, and the device ms per
               batch of the fused and unfused rungs beside the int8-DPT
               rung's (phase 15);
   18. K8:     the S.V diagnostic (K1's kernel with the softmax compiled
               out) at the sweep script's shape and K1's four phase-3 shapes,
               against its plain version; its time beside K1's, SDPA's, two
               bf16 torch.matmul and the bound, the share of K1's time that
               its softmax costs, (K1 - K8) / K1, and the exponentials' count
               with an estimate of their time alone on the MUFU at the max
               SM clock and at the clock nvidia-smi reads under K1's load.

The line before the last is a JSON object with each kernel's launches on the
serving, training and diagnostic runs, its error against the plain version,
its time, the plain version's, the least time the card could take for the
same work (``bound_ms``, from the card's published peaks) and one PyTorch
call's time where one computes the same function (``library_ms``, else
null); the last line is ``{"ok": true, "device": {...}}``. Needs one CUDA
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
# K5 against its plain version (phase 16 and the path's calls in phase 17). The projection: v is one rounding of fp32
# sums taken in another order, so at most 1 ulp; q and k are then rotated, and a 1-ulp step of u or v moves both outputs
# of the pair by up to 1 ulp of the pair's norm, so they are counted in ulps of it. fp32: sums over C in another order.
K5_PROJ_ULPS = {"v": 1, "qk": 2}
K5_PROJ_FP32_TOL = 1e-5
# The output: bf16 in ulps of max(|plain|, 1/64), as K6's check. The tensor cores sum q.k in another order than the
# plain version's fp32 product, so a p (or a projected element) may round to the other bf16 neighbour and move its
# row by up to ~1e-3; measured 4 to 10.7 ulps over the phase-16 cases on an H100 80GB HBM3 (700 W), the controls
# (positions dropped, -F0) 2,800 to 6,400. fp32: the bar of K1.
K5_ULPS, K5_ULP_FLOOR = 16, 1 / 64
K5_FP32_TOL = 2e-5
# K8: against the same function with cuBLAS's tensor-core scores (a bf16 torch.matmul, then S.V in fp32), which round
# q.k from the same kind of fp32 sums, in ulps of max(|out|, 1): measured 1.00. Against the plain version's IEEE fp32 scores, 4.2e-5
# of the scores round to the other bf16 neighbour, each moving its row by up to ulp(s) |v| (max abs 4.0 at the
# sweep's shape): ||kernel - plain|| / ||plain||, measured 1.04e-4.
K8_ULPS, K8_ULP_FLOOR = 2, 1.0
K8_REL_TOL = 1e-3
# Published peaks of the H100 SXM (dense) and its memory rate: the bound of each kernel's work.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
# exp2 results per clock per SM on the MUFU at compute capability 9.0 (the CUDA C++ Programming Guide's table of
# arithmetic instruction throughputs): with the card's SM count and an SM clock, an estimate of the time K1's
# exponentials (one per score) take alone.
MUFU_EXP2_PER_CLOCK = 16

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


def bound(ops, nbytes):
    """The least time the card could take for the work: ``ops`` {"bf16" | "int8" | "fp32": operations} at the
    published peak of each type, and ``nbytes`` (each input read once, each output written once) at the memory
    rate. Returns (ms, "operations" or "bytes"), whichever bounds it."""
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(B, Nq, Nk, H):
    "Attention's two products (4 Nq Nk D per (b, h)) in bf16 against q, k, v and o."
    return bound({"bf16": 4 * B * H * Nq * Nk * 64}, (2 * Nq + 2 * Nk) * B * H * 64 * 2)


def sdpa(q, k, v, scale=None):
    "torch's scaled_dot_product_attention on (B, N, H, D) views: the library yardstick, never on the port's path."
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)


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


K1_RAGGED = [("Nq=1 Nk=7", 1, 1, 7, 12), ("Nq=300 Nk=1", 1, 300, 1, 16), ("Nq=1 Nk=1024", 1, 1, 1024, 16)]


def phase_flash_attention(torch, fa, kernel_lib):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # (name, B, Nq, Nk, H)
        ("encoder 512", 4, 1024, 1024, 16),
        ("decoder 512", 2, 1024, 1024, 12),
        ("encoder 224", 4, 196, 196, 16),
        ("Nq != Nk", 2, 300, 1000, 12),
    ]
    worst_bf16, main = 0.0, None
    for name, B, Nq, Nk, H in cases + K1_RAGGED:
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
        line = (f"[3 K1] {name:12s} B={B} Nq={Nq} Nk={Nk} H={H} D=64: max|err| bf16 {err16:.3e} (tol {K1_BF16_TOL})"
                f" fp32 {err32:.3e} (tol {K1_FP32_TOL})")
        if (name, B, Nq, Nk, H) in cases:
            ms = graph_ms(torch, lambda: fa.flash_attention(qb, kb, vb))
            plain_ms = graph_ms(torch, lambda: fa.flash_attention_ref(qb, kb, vb))
            lib_ms = graph_ms(torch, lambda: sdpa(qb, kb, vb))
            k1_bound = attention_bound(B, Nq, Nk, H)
            flops = 4 * B * H * Nq * Nk * 64
            line += (f"; bf16 kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {k1_bound[0] / ms:.3f} of the bound), "
                     f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), bound "
                     f"{k1_bound[0]:.4f} ms ({k1_bound[1]}) (CUDA graph)")
            if main is None:
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=k1_bound)
                host_us = host_us_per_call(torch, lambda: fa.flash_attention(qb, kb, vb))
                encode_ns = kernel_lib.library().uc_tensor_map_encode_ns(qb.data_ptr(), fa._layouts((qb, fa.FWD_ROWS)),
                                                                         100000)
                line += (f"; wrapper host time {host_us:.2f} us per call (wall clock over 200 calls enqueued without a "
                         f"synchronize), one tensor-map encoding {encode_ns:.1f} ns (3 per call)")
        print(line)
        require(err16 <= K1_BF16_TOL, f"K1 {name}: bf16 error {err16} > {K1_BF16_TOL}")
        require(err32 <= K1_FP32_TOL, f"K1 {name}: fp32 error {err32} > {K1_FP32_TOL}")
        worst_bf16 = max(worst_bf16, err16)
    return worst_bf16, main


def host_us_per_call(torch, fn, calls=200):
    "Host microseconds per call of fn: wall clock over ``calls`` calls enqueued without a synchronize."
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_rope(torch, rope, make_patch_positions):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst_bf16, main = 0.0, None
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
        # bytes: the tokens read and written, the positions read; ops: a sincos and 6 flops per (u, v) pair
        k2_bound = bound({"fp32": 2 * tb.numel() * 3 + B * 1024 * 32 * 20}, 2 * tb.numel() * 2 + pos.numel() * 4)
        print(
            f"[4 K2] B={B} N=1024 H={H} D=64: fp32 max|err| {err32:.3e} (tol {K2_FP32_TOL}), inverse {err_inv:.3e}"
            f" (tol {K2_INVERSE_TOL}), bf16 {ulps:.2f} ulp (tol {K2_BF16_ULPS}) max|err| {err16:.3e};"
            f" bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]}); no single "
            f"library call computes it (the plain version is its eager composition)"
        )
        require(err32 <= K2_FP32_TOL, f"K2: fp32 error {err32} > {K2_FP32_TOL}")
        require(err_inv <= K2_INVERSE_TOL, f"K2: inverse error {err_inv} > {K2_INVERSE_TOL}")
        require(ulps <= K2_BF16_ULPS, f"K2: bf16 error {ulps} ulp > {K2_BF16_ULPS}")
        worst_bf16 = max(worst_bf16, err16)
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound=k2_bound)
    return worst_bf16, main


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
        *K1_RAGGED,
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
    worst_abs, main = 0.0, None
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
            for gname, g, r, a in zip(("dq", "dk", "dv"), grads, refs, auto):
                require(torch.isfinite(g).all().item(), f"K3 {name} {label}: non-finite gradient")
                if k.shape[1] == 1 and gname != "dv":
                    # a softmax over one key passes no gradient to q or k: both are rounding noise of dp - delta,
                    # held to the gradients' bar at the scale of dv
                    noise = max(g.float().abs().max().item(), r.abs().max().item())
                    bar = K3_REL_TOL[label] * refs[2].abs().max().item()
                    require(noise <= bar, f"K3 {name} {label}: {gname} of one key is {noise}, over {bar}")
                    continue
                rels.append(((g.float() - r).abs().max() / r.abs().max()).item())
                rels_auto.append(((g.float() - a).abs().max() / a.abs().max()).item())
                if label == "bf16":
                    worst_abs = max(worst_abs, (g.float() - r).abs().max().item())
            line = (f"[8 K3] {name:12s} {label}: max|err|/max|ref| {'dq dk dv' if len(rels) == 3 else 'dv'} "
                    + " ".join(f"{x:.2e}" for x in rels)
                    + f" (vs autograd of the plain forward {max(rels_auto):.2e}; tol {K3_REL_TOL[label]})")
            if label == "bf16" and name not in [c[0] for c in K1_RAGGED]:
                ms = graph_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout))
                plain_ms = graph_ms(torch, lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, dout))
                B, Nq, H, _ = q.shape
                Nk = k.shape[1]
                # five products of 2 Nq Nk D (S, dP, dV, dQ, dK); q, k, v, o, dO, lse read, dq, dk, dv written
                flops = 10 * B * H * Nq * Nk * 64
                k3_bound = bound({"bf16": flops}, (4 * Nq + 5 * Nk) * B * H * 64 * 2 + B * H * Nq * 4)
                lib_ms, fwd_bwd_ms, fwd_ms, events_ms = sdpa_bwd_ms(torch, q, k, v, dout)
                line += (f"; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the five products, "
                         f"{k3_bound[0] / ms:.3f} of the bound), plain {plain_ms:.4f} ms, SDPA backward alone "
                         f"{lib_ms:.4f} ms (CUDA graphs: forward + backward {fwd_bwd_ms:.4f} - forward {fwd_ms:.4f}; "
                         f"the old yardstick, forward + backward by CUDA events around eager calls, "
                         f"{events_ms:.4f} ms), bound {k3_bound[0]:.4f} ms ({k3_bound[1]})")
                if main is None:
                    main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=k3_bound)
            print(line)
            require(max(rels + rels_auto) <= K3_REL_TOL[label], f"K3 {name} {label}: error {max(rels + rels_auto)}")
    return worst_abs, main


def sdpa_bwd_ms(torch, q, k, v, dout):
    """K3's yardstick: torch's SDPA backward alone on the same inputs, as CUDA-graph time of its forward and
    backward minus that of its forward (both captured, so the host is in neither). Also returns both graph
    times and the forward + backward by CUDA events around eager calls (the yardstick before)."""
    import torch.nn.functional as F

    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    g = dout.transpose(1, 2)

    def step():
        torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), g)

    def forward():  # the same forward as in step, saving what its backward needs
        F.scaled_dot_product_attention(qs, ks, vs)

    fwd_bwd, fwd = graph_ms(torch, step), graph_ms(torch, forward)
    return fwd_bwd - fwd, fwd_bwd, fwd, cuda_ms(torch, step, warmup=3, iters=20)


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
    profile_device(torch, lambda: [ctx.step(*batch) for _ in range(3)], 3, "step", "10 profile train", 16)
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
K4_SPLIT_PROBES = [(129, 4096, 768), (300, 4096, 200), (1, 4096, 768)]  # (M, K, N): few tiles, a long K loop


def k4_split_probe(torch, i8, gemm, gen, sms):
    """K4's GEMM launch where the planner may split the K loop (few tiles, long K): the planner's plan beside the
    unsplit ones and splits of 2, 4 and 16, each bit for bit the unsplit result."""
    for M, K, N in K4_SPLIT_PROBES:
        x_q = torch.randint(-127, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
        a_scale = torch.rand(M, device="cuda", generator=gen) * 1e-2
        w_nk = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8)
        w_scale = torch.rand(N, device="cuda", generator=gen) * 1e-3
        plan = gemm.gemm_plan(M, N, K, 1, sms)
        want = i8.int8_gemm(x_q, a_scale, w_nk, w_scale, plan=(128, 1))
        times = {}
        for p in dict.fromkeys([plan, (128, 1), (256, 1), (128, 2), (128, 4), (128, 16)]):
            require(torch.equal(i8.int8_gemm(x_q, a_scale, w_nk, w_scale, plan=p), want), f"K4 probe {M, K, N} {p}")
            times[p] = graph_ms(torch, lambda: i8.int8_gemm(x_q, a_scale, w_nk, w_scale, plan=p))
        print(f"[11 K4] split probe M={M} K={K} N={N}: the planner's 128x{plan[0]} split {plan[1]} {times[plan]:.4f} "
              f"ms; " + ", ".join(f"128x{b} split {k} {t:.4f} ms" for (b, k), t in times.items() if (b, k) != plan)
              + " (each plan bit for bit the unsplit result; CUDA graph)")


def phase_int8_matmul(torch, F, i8, gemm):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst_abs, main, probed = 0.0, None, {}
    for name, M, K, N in K4_SHAPES:
        x32 = torch.randn(M, K, device="cuda", generator=gen)
        w_q = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8).t()  # (K, N) view
        w_scale = torch.rand(1, N, device="cuda", generator=gen) * 1e-3 + 1e-5
        bias = torch.randn(N, device="cuda", generator=gen)
        bn, split = gemm.gemm_plan(M, N, K, 1, sms)
        line = f"[11 K4] {name:15s} M={M} K={K} N={N} plan {gemm.TILE_M}x{bn} split {split}:"
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
                x_q, a_scale = i8.quantize_rows(x)
                w_nk, w_bf16 = w_q.t(), w_q.t().bfloat16()
                ms = graph_ms(torch, lambda: i8.int8_matmul_dynamic(x, w_q, w_scale, bias))
                gemm_ms = graph_ms(torch, lambda: i8.int8_gemm(x_q, a_scale, w_nk, w_scale, bias))
                plain_ms = graph_ms(torch, lambda: i8.int8_matmul_dynamic_ref(x, w_q, w_scale, bias))
                int_mm_ms = graph_ms(torch, lambda: torch._int_mm(x_q, w_q))  # cuBLASLt's int8 product alone
                linear_ms = graph_ms(torch, lambda: F.linear(x, w_bf16))  # the bf16 product of the same shape

                def library():  # eager row quantization, then cuBLASLt's int8 product through torch._int_mm
                    x_q, a_scale = i8.quantize_rows(x)
                    return (torch._int_mm(x_q, w_q).float() * (a_scale * w_scale) + bias).to(x.dtype)

                lib_ms = graph_ms(torch, library)
                # the planner's alternatives: the other tile width, and its own with the K loop split in two
                others = [(384 - bn, 1), (bn, 2)]
                other_ms = [graph_ms(torch, lambda: i8.int8_gemm(x_q, a_scale, w_nk, w_scale, bias, plan=p)) for p in others]
                k4_bound = bound({"int8": 2 * M * K * N}, M * K * 2 + K * N + 4 * N + 4 * N + M * N * 2)
                tops = 2 * M * K * N / 1e9
                line += (f" bf16 kernel {ms:.4f} ms ({tops / ms:.1f} TOP/s), its GEMM launch alone {gemm_ms:.4f} ms "
                         f"({tops / gemm_ms:.1f} TOP/s; "
                         + ", ".join(f"128x{b} split {k} {t:.4f} ms" for (b, k), t in zip(others, other_ms))
                         + f"), plain {plain_ms:.4f} ms; torch._int_mm alone {int_mm_ms:.4f} ms "
                         f"({tops / int_mm_ms:.1f} TOP/s), bf16 F.linear {linear_ms:.4f} ms, torch._int_mm + eager "
                         f"quantization {lib_ms:.4f} ms; bound {k4_bound[0]:.4f} ms;")
                if main is None:
                    main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=k4_bound)
        print(line)
    k4_split_probe(torch, i8, gemm, gen, sms)
    return worst_abs, main


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
    worst, main = 0.0, None
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
            prep_ms = graph_ms(torch, lambda: fa.flash_attention_int8_prep(k, v, mode))
            plain_ms = graph_ms(torch, lambda: fa.flash_attention_int8_ref(q, k, v, mode=mode))
            # QK^T at the int8 rate; P.V at the bf16 rate ("int8") or the int8 rate ("int8pv")
            pv_kind = "int8" if mode == "int8pv" else "bf16"
            ops = {"int8": 2 * B * H * Nq * Nk * 64}
            ops[pv_kind] = ops.get(pv_kind, 0) + 2 * B * H * Nq * Nk * 64
            k6_bound = bound(ops, (2 * Nq + 2 * Nk) * B * H * 64 * 2)
            print(f"[12 K6] {name:12s} B={B} Nq={Nq} Nk={Nk} H={H} {mode:6s}: vs plain {ulps:.2f} ulp (tol {K6_ULPS}), "
                  f"max|err| {err:.3e}; vs exact attention {rel:.3e} (plain version {rel_plain:.3e}, tol +- "
                  f"{K6_EXACT_SLACK}; the JAX test's bound {K6_EXACT_REL_TOL[mode]}: "
                  f"{'within' if rel <= K6_EXACT_REL_TOL[mode] else 'over'}); controls fail: K1 {ctrl_k1}, {other} "
                  f"{ctrl_other}; kernel {ms:.4f} ms (its prep alone {prep_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"bound {k6_bound[0]:.4f} ms ({k6_bound[1]}), K1 bf16 {k1_ms:.4f} ms (CUDA graph)")
            if main is None:
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound=k6_bound)
                print(f"[12 K6] {name} {mode}: no single library call computes it (K1 {k1_ms:.4f} ms computes exact "
                      f"attention)")
            require(not fails, f"K6 {name} {mode}: {fails}")
            require(ctrl_k1 and ctrl_other, f"K6 {name} {mode}: a control passed the check (K1 {ctrl_k1}, {other} "
                                            f"{ctrl_other})")
            worst = max(worst, err)
    return worst, main


K7_SHAPES = [  # (convs at 512 per head, H = W, C, Co), batch 2: the eligible convs of one DPT head
    ("layer3_rn", 32, 384, 256), ("layer4_rn", 16, 768, 256), ("refinenet4 RCU", 16, 256, 256),
    ("refinenet3 RCU", 32, 256, 256), ("refinenet2 RCU", 64, 256, 256), ("refinenet1 RCU", 128, 256, 256),
    ("regressor conv1", 256, 256, 128),
]


def phase_conv3x3(torch, F, c3):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst, main = 0.0, None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, hw, C, Co in K7_SHAPES:
        x = torch.randn(BATCH, hw, hw, C, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(3, 3, C, Co, device="cuda", generator=gen) * (9 * C) ** -0.5).bfloat16()
        b = torch.randn(Co, device="cuda", generator=gen) * 0.1
        out, ref = c3.conv3x3_nhwc(x, w, b), c3.conv3x3_reference(x, w, b)
        require(torch.isfinite(out).all().item(), f"K7 {name}: non-finite output")
        ulps = _ulps(out, ref, 7, floor=1 / 16)
        deterministic = torch.equal(c3.conv3x3_nhwc(x, w, b), out)
        ms = graph_ms(torch, lambda: c3.conv3x3_nhwc(x, w, b))
        plain_ms = graph_ms(torch, lambda: c3.conv3x3_reference(x, w, b))
        # what the stock path runs: the bf16 conv (cuDNN) of a channels_last NCHW view
        xc, wc, bc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), b.bfloat16()
        stock_ms = graph_ms(torch, lambda: F.conv2d(xc, wc, bc, padding=1))
        flops = 2 * BATCH * hw * hw * C * Co * 9
        k7_bound = bound({"bf16": flops}, (x.numel() + w.numel() + BATCH * hw * hw * Co) * 2 + Co * 4)
        tw, th, bn, split = c3.conv3x3_plan(BATCH, hw, hw, C, Co, sms)
        print(f"[13 K7] {name:16s} {BATCH}x{hw}x{hw}x{C} -> {Co}: {ulps:.2f} ulp (tol {K7_ULPS}), deterministic "
              f"{deterministic}; plan: tiles {tw}x{th} pixels x {bn} channels, K loop split {split}; kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), stock bf16 conv (cuDNN) {stock_ms:.4f} ms, bound {k7_bound[0]:.4f} ms "
              f"({k7_bound[1]}), plain (fp32 conv) {plain_ms:.4f} ms")
        require(ulps <= K7_ULPS, f"K7 {name}: {ulps} ulp > {K7_ULPS}")
        require(deterministic, f"K7 {name}: two calls gave different bits")
        worst = max(worst, (out.float() - ref.float()).abs().max().item())
        if name == "refinenet1 RCU":
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=stock_ms, bound=k7_bound)
    return worst, main


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


def _kernel_counters(fa, rope, i8, c3, fused):
    return {"K1": fa.flash_attention, "K2": rope.rope_2d_kernel, "K4": i8.int8_matmul_dynamic,
            "K5-self": fused.fused_qkv_rope_attention, "K5-cross": fused.fused_cross_rope_attention,
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
    want = {"K1": 0, "K2": 2 * attn, "K4": k4, "K5-self": 0, "K5-cross": 0, "K6": attn, "K7": k7_convs_per_forward(IMG)}
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
                results["int8-DPT device ms"] = profile_serving(torch, fn, frames)
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


# The device kernels of each hand-written kernel on the serving paths, by the names the profiler gives them. Under
# "fused" K1's kernel is K5's attention launch; K4's GEMM and K5's projection are the shared GEMM with their epilogues.
PROFILE_KERNELS = {"K1 (under fused: K5's attention launch)": ("fa_fwd_bf16",), "K2": ("rope2d",),
                   "K4": ("quant_rows_kernel", "DequantBiasEpilogue"), "K5 projection": ("BiasRopeEpilogue",),
                   "K6": ("fa8_",), "K7": ("conv3x3",)}


def profile_serving(torch, fn, frames, label="15 profile int8-DPT", top=14):
    """Device time by kernel over 3 serving batches (torch.profiler), the top entries and the device-busy share,
    then each hand-written kernel's device ms per batch (all its launches: K4's row quantization and GEMM, K6's
    prep and attention, K7's conv and split-K reduction). Returns the device ms per batch."""
    batches = [(frames[2 * i : 2 * i + 2 * BATCH : 2], frames[2 * i + 1 : 2 * i + 2 * BATCH : 2]) for i in range(3)]
    events = profile_device(torch, lambda: [fn(img1, img2) for img1, img2 in batches], 3, "batch", label, top)
    for name, keys in PROFILE_KERNELS.items():
        mine = [e for e in events if any(k in e.key for k in keys)]
        if not mine:
            continue
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / 3
        print(f"[{label}] {name}: {ms:.3f} ms/batch in {sum(e.count for e in mine) // 3} launches/batch "
              f"({', '.join(sorted(e.key[:60] for e in mine))})")
    return sum(e.self_device_time_total for e in events) / 1e3 / 3


def profile_device(torch, run, n, unit, label, top):
    "Device time by kernel over run(), which does n units of work (torch.profiler): the top entries and the busy share."
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(stop)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{label}] {n} {unit}{'es' if unit.endswith('h') else 's'}: {total:.2f} ms of device time in a {window:.2f} ms window "
          f"(busy share {total / window:.3f}, profiler overhead included)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms / n:8.3f} ms/{unit} {100 * ms / total:5.1f}% {e.count // n:5d} calls/{unit}  {e.key[:90]}")
    return events


K5_CASES = [  # (name, B, Nq, Nk (None: self-attention), C, H, query grid, key grid)
    ("encoder self", 4, 1024, None, 1024, 16, (32, 32), None),
    ("decoder self", 2, 1024, None, 768, 12, (32, 32), None),
    ("decoder cross", 2, 1024, 1024, 768, 12, (32, 32), (32, 32)),
    ("self N=196", 4, 196, None, 1024, 16, (14, 14), None),
    ("cross Nq 300/Nk 1000", 2, 300, 1000, 768, 12, (15, 20), (25, 40)),
]


def k5_bound(B, Nq, Nk, C, H, cross):
    "K5's bound: the projection and attention products in bf16 against x (and xkv), W, the biases and the output."
    hd = H * 64
    proj = 2 * B * (Nq * C * hd + Nk * C * 2 * hd)
    nbytes = (B * Nq * C + (B * Nk * C if cross else 0) + 3 * hd * C + B * Nq * hd) * 2 + 3 * hd * 4
    return bound({"bf16": proj + 4 * B * H * Nq * Nk * 64}, nbytes)


def _pair_ulps(out, ref, floor):
    "Max |out - ref| of RoPE'd (..., 64) heads in bf16 ulps of max(each (u, v) pair's norm in ref, floor)."
    r = ref.float().unflatten(-1, (2, 2, 16))  # [y / x half][u / v][quarter index]
    norm = r.square().sum(-2, keepdim=True).sqrt().expand_as(r).flatten(-3)
    ulp = (norm.clamp_min(floor).log2().floor() - 7).exp2()
    return ((out.float() - ref.float()).abs() / ulp).max().item()


class K5Case:
    "One K5 configuration on the card: seeded inputs in fp32, and the calls of phase 16 in a dtype."

    def __init__(self, torch, fa, make_patch_positions, gen, B, Nq, Nk, C, H, qgrid, kgrid):
        self.fa, self.H, self.cross = fa, H, Nk is not None
        hd = H * 64
        self.x = torch.randn(B, Nq, C, device="cuda", generator=gen)
        self.xkv = torch.randn(B, Nk, C, device="cuda", generator=gen) if self.cross else self.x
        self.w = torch.randn(3 * hd, C, device="cuda", generator=gen) * C**-0.5  # unit-variance q, k, v
        self.b = torch.randn(3 * hd, device="cuda", generator=gen) * 0.1
        self.qpos = make_patch_positions(B, *qgrid, device="cuda")
        self.kpos = make_patch_positions(B, *kgrid, device="cuda") if self.cross else self.qpos
        self.scale = 64**-0.5

    def args(self, dt, rope, f0=1.0, positions=True):
        "The wrapper's arguments in dt; ``positions=False`` drops the positions, ``f0=-1`` inverts the rotation."
        x, w = self.x.to(dt), self.w.to(dt)
        qpos, kpos = (self.qpos, self.kpos) if rope and positions else (None, None)
        if self.cross:
            return (x, self.xkv.to(dt), *w.chunk(3), *self.b.chunk(3), qpos, kpos, self.H, self.scale, 100.0, f0)
        return (x, w, self.b, qpos, self.H, self.scale, 100.0, f0)

    def kernel(self, *args):
        return (self.fa.fused_cross_rope_attention if self.cross else self.fa.fused_qkv_rope_attention)(*args)

    def plain(self, *args):
        return (self.fa.fused_cross_rope_attention_ref if self.cross else self.fa.fused_qkv_rope_attention_ref)(*args)

    def project(self, a, rope, plain):
        "q, k, v as (B, N, H, D) from the wrapper's arguments ``a``: the projection launch alone, or its plain version."
        fa, H = self.fa, self.H
        if self.cross:
            xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos = a[:10]
            if plain:
                return (fa._project_ref(xq, (wq,), (bq,), qpos, (rope,), H, 100.0, 1.0)
                        + fa._project_ref(xkv, (wk, wv), (bk, bv), kpos, (rope, False), H, 100.0, 1.0))
            sections = (*fa._project(xq, (wq,), (bq,), qpos, int(rope), H, 100.0, 1.0),
                        *fa._project(xkv, (wk, wv), (bk, bv), kpos, int(rope), H, 100.0, 1.0))
        else:
            x, w, b, pos = a[:4]
            if plain:
                return fa._project_ref(x, w.chunk(3), b.chunk(3), pos, (rope, rope, False), H, 100.0, 1.0)
            sections = fa._project(x, w.chunk(3), b.chunk(3), pos, 2 * rope, H, 100.0, 1.0)
        return [t.transpose(1, 2) for t in sections]

    def linear_qkv(self, F, a):
        "q, k, v (B, N, H, D) from the RoPE'd arguments ``a`` through cuBLAS (F.linear, as LinearX runs them)."
        dt, heads = a[0].dtype, (lambda t: t.unflatten(-1, (self.H, 64)))  # noqa: E731
        if self.cross:
            xq, xkv, wq, wk, wv, bq, bk, bv = a[:8]
            return heads(F.linear(xq, wq, bq.to(dt))), heads(F.linear(xkv, wk, bk.to(dt))), heads(F.linear(xkv, wv, bv.to(dt)))
        x, w, b = a[:3]
        return F.linear(x, w, b.to(dt)).unflatten(-1, (3, self.H, 64)).unbind(2)

    def unfused(self, F, fa1, rope_mod, a):
        "The unfused kernel path on the same inputs: the q/k/v matmuls, K2 on q and k, K1."
        q, k, v = self.linear_qkv(F, a)
        q, k = rope_mod.rope_2d_kernel(q, self.qpos), rope_mod.rope_2d_kernel(k, self.kpos)
        return fa1.flash_attention(q, k, v, self.scale)

    def library(self, F, a):
        "The yardstick, never on the port's path: cuBLAS for the projections, then SDPA (no RoPE)."
        return sdpa(*self.linear_qkv(F, a), self.scale)


def k5_check(out, ref, bf16):
    "K5's output check: (error in bf16 ulps of max(|plain|, 1/64), or max abs in fp32; whether it passes)."
    if bf16:
        ulps = _ulps(out, ref, 7, floor=K5_ULP_FLOOR)
        return ulps, ulps <= K5_ULPS
    err = (out.float() - ref.float()).abs().max().item()
    return err, err <= K5_FP32_TOL


def phase_fused_attention(torch, F, fa, fa1, rope_mod, make_patch_positions):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    result = {"self": None, "cross": None}
    worst = {"self": 0.0, "cross": 0.0}
    for name, B, Nq, Nk, C, H, qgrid, kgrid in K5_CASES:
        case = K5Case(torch, fa, make_patch_positions, gen, B, Nq, Nk, C, H, qgrid, kgrid)
        kind = "cross" if case.cross else "self"
        for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            bf16 = dt == torch.bfloat16
            for rope in (True, False):
                a = case.args(dt, rope)
                got, want = case.project(a, rope, plain=False), case.project(a, rope, plain=True)
                if bf16:
                    fl = K5_ULP_FLOOR
                    proj = {n: _pair_ulps(g, w_, fl) if rope and n != "v" else _ulps(g, w_, 7, floor=fl)
                            for n, g, w_ in zip("qkv", got, want)}
                    proj_ok = all(e <= K5_PROJ_ULPS["v" if n == "v" or not rope else "qk"] for n, e in proj.items())
                else:
                    proj = {n: (g.float() - w_).abs().max().item() for n, g, w_ in zip("qkv", got, want)}
                    proj_ok = max(proj.values()) <= K5_PROJ_FP32_TOL
                out, ref = case.kernel(*a), case.plain(*a)
                require(torch.isfinite(out).all().item(), f"K5 {name} {label}: non-finite output")
                require(out.shape == ref.shape and out.dtype == dt, f"K5 {name} {label}: {out.shape} {out.dtype}")
                err, ok = k5_check(out, ref, bf16)
                # the attention launch (K1's kernel) alone, on the projection launch's scratch
                q, k, v = (t.transpose(1, 2) for t in got)
                attn_err = k5_check(fa._attend(q, k, v, case.scale), fa._attend_ref(q, *got, case.scale), bf16)[0]
                line = (f"[16 K5] {name:21s} {label} rope {'on ' if rope else 'off'}: projection "
                        + " ".join(f"{n} {e:.2e}" for n, e in proj.items())
                        + f" ({'ulp of max(|plain|, 1/64), q/k at the pair norm with RoPE; tol v %d, q/k %d' % (K5_PROJ_ULPS['v'], K5_PROJ_ULPS['qk']) if bf16 else 'max abs; tol %g' % K5_PROJ_FP32_TOL});"
                        f" output {err:.3g} {'ulp' if bf16 else 'max abs'} (tol {K5_ULPS if bf16 else K5_FP32_TOL});"
                        f" the attention launch (K1's kernel) alone on that scratch vs the plain attention {attn_err:.3g}")
                controls = []
                if rope:  # the positions dropped, and the inverse rotation (-F0): both must fail the same check
                    for cname, cargs in (("no positions", case.args(dt, rope, positions=False)),
                                         ("-F0", case.args(dt, rope, f0=-1.0))):
                        c_err, c_ok = k5_check(case.kernel(*cargs), ref, bf16)
                        controls.append((cname, c_err, c_ok))
                    line += "; controls " + ", ".join(f"{c} {e:.3g} ({'PASSED' if o else 'fails'})" for c, e, o in controls)
                if bf16:
                    worst[kind] = max(worst[kind], (out.float() - ref.float()).abs().max().item())
                if bf16 and rope and name in ("encoder self", "decoder self", "decoder cross"):
                    ms = graph_ms(torch, lambda: case.kernel(*a))
                    proj_ms = graph_ms(torch, lambda: case.project(a, rope, plain=False))
                    cublas_ms = graph_ms(torch, lambda: case.linear_qkv(F, a))
                    plain_ms = graph_ms(torch, lambda: case.plain(*a))
                    unfused_ms = graph_ms(torch, lambda: case.unfused(F, fa1, rope_mod, a))
                    lib_ms = graph_ms(torch, lambda: case.library(F, a))
                    k5b = k5_bound(B, Nq, Nk or Nq, C, H, case.cross)
                    proj_tf = 2 * B * (Nq * C + (Nk or Nq) * 2 * C) * H * 64 / 1e9
                    line += (f"; kernel {ms:.4f} ms (projection launch {proj_ms:.4f} ms, {proj_tf / proj_ms:.1f} "
                             f"TFLOP/s; cuBLAS bf16 GEMMs of the same shape {cublas_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                             f"unfused kernel path {unfused_ms:.4f} ms, cuBLAS + SDPA (no RoPE) {lib_ms:.4f} ms, bound "
                             f"{k5b[0]:.4f} ms ({k5b[1]}) (CUDA graph)")
                    if result[kind] is None:
                        result[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound=k5b)
                print(line)
                require(proj_ok, f"K5 {name} {label} rope {rope}: projection {proj}")
                require(ok, f"K5 {name} {label} rope {rope}: output {err}")
                require(all(not o for _, _, o in controls), f"K5 {name} {label}: a control passed the check {controls}")
        del case
    return worst, result


def phase_fused_model(torch, np, serve, config, blocks, fa, counters, card, bf16_linear, int8_dpt_ms):
    """DUSt3R 512 in the "fused" implementation: forward_pair against the plain path and the unfused kernel path
    (fp32 and bf16 trunks), exact launches, every K5 call of the bf16 forward against its plain version on the same
    activations; one int8-rung forward under "fused"; the serving loop."""
    frames = np.random.RandomState(SEED).randint(0, 256, size=(2 * PAIRS, IMG, IMG, 3), dtype=np.uint8)
    img1, img2 = frames[0:2 * BATCH:2], frames[1:2 * BATCH:2]
    attn = ENC_DEPTH + DEC_DEPTH * 2
    want = {"K1": 0, "K2": 0, "K4": 0, "K5-self": attn, "K5-cross": DEC_DEPTH * 2, "K6": 0, "K7": 0}

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def run(fn, impl):
        config.set_attention_impl(impl)
        try:
            _reset(counters)
            res = fn(img1, img2)
            torch.cuda.synchronize()
            return res, _read(counters)
        finally:
            config.set_attention_impl("kernel")

    served = None
    for dtype, tol in ((torch.float32, MODEL_FP32_REL_TOL), (torch.bfloat16, MODEL_REL_TOL)):
        trunk = str(dtype).replace("torch.", "")
        model = serve.build_model(IMG, ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, device="cuda",
                                  dtype=dtype, seed=SEED)
        fn = serve.make_serving_fn(model, "cuda")
        calls = []
        if dtype == torch.bfloat16:  # every K5 call held against its plain version on the same activations
            def spy(kernel, plain):
                def checked(*args):
                    out = kernel(*args)
                    calls.append(k5_check(out, plain(*args), True)[0])
                    return out
                return checked

            blocks.fused_qkv_rope_attention = spy(fa.fused_qkv_rope_attention, fa.fused_qkv_rope_attention_ref)
            blocks.fused_cross_rope_attention = spy(fa.fused_cross_rope_attention, fa.fused_cross_rope_attention_ref)
        try:
            res_f, launches = run(fn, "fused")
            if dtype == torch.bfloat16:
                path = dict(launches)
        finally:
            blocks.fused_qkv_rope_attention = fa.fused_qkv_rope_attention
            blocks.fused_cross_rope_attention = fa.fused_cross_rope_attention
        res_n, naive_launches = run(fn, "naive")
        res_k, _ = run(fn, "kernel")
        print(f"[17 fused {trunk}] launches per forward_pair {launches} (want {want}); the naive path's {naive_launches}")
        require(launches == want, f"fused {trunk}: launches {launches}, want {want}")
        require(not any(naive_launches.values()), "the naive path launched a kernel")
        if calls:
            print(f"[17 fused {trunk}] each of {len(calls)} K5 calls against its plain version on the same activations: "
                  f"max {max(calls):.2f} ulp of max(|plain|, {K5_ULP_FLOOR}) (tol {K5_ULPS}), median "
                  f"{sorted(calls)[len(calls) // 2]:.2f}")
            require(len(calls) == attn + DEC_DEPTH * 2, f"{len(calls)} K5 calls checked")
            require(max(calls) <= K5_ULPS, f"fused: a K5 call is {max(calls)} ulp from its plain version")
        for name, a, b, c in zip(("pts3d", "conf1", "pts3d_in_other_view", "conf2"), res_f, res_n, res_k):
            require(all(torch.isfinite(t).all().item() for t in (a, b, c)), f"{name}: non-finite output")
            r = rel(a, b)
            print(f"[17 fused {trunk}] {name:20s} {tuple(a.shape)} fused vs plain path {r:.3e} (tol {tol}); vs the "
                  f"unfused kernel path {rel(a, c):.3e}; unfused kernel path vs plain {rel(c, b):.3e}")
            require(r <= tol, f"fused {trunk} {name}: vs plain {r} > {tol}")
        if dtype == torch.bfloat16:  # serving, fused then unfused on the same model, and forward_pair times
            serving, device_ms = {}, {}
            for impl in ("fused", "kernel"):
                config.set_attention_impl(impl)
                try:
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    _reset(counters)
                    out, pairs, seconds = serve.serve_frames(fn, frames, BATCH, "cuda")
                    torch.cuda.synchronize()
                    serving[impl] = (pairs / seconds, torch.cuda.max_memory_allocated(), base, _read(counters))
                    fwd_ms = cuda_ms(torch, lambda: fn(img1, img2), warmup=1, iters=5)
                    device_ms[impl] = profile_serving(torch, fn, frames, label=f"17 profile {impl}", top=8)
                finally:
                    config.set_attention_impl("kernel")
                shapes = [tuple(o.shape) for o in out]
                require(shapes == [(BATCH, IMG, IMG, 3), (BATCH, IMG, IMG, 1)] * 2, f"{impl} serving: shapes {shapes}")
                require(all(torch.isfinite(o).all().item() for o in out), f"{impl} serving: non-finite output")
                rate, peak, base, n = serving[impl]
                print(f"[17 serve {impl}] {pairs} pairs in {seconds:.4f}s = {rate:.3f} pairs/s at {IMG}x{IMG} batch "
                      f"{BATCH} (CUDA events, after one warm-up batch); max_memory_allocated {peak} bytes "
                      f"({peak / 2**30:.3f} GiB; {base} allocated before); forward_pair {fwd_ms:.2f} ms; launches {n} "
                      f"on {card}")
            served = serving["fused"][3]
            print(f"[17 profile] device ms per batch (torch.profiler, 3 batches): fused {device_ms['fused']:.2f}, the "
                  f"unfused bf16-linear rung {device_ms['kernel']:.2f}; the int8-DPT rung {int8_dpt_ms:.2f} (phase 15)")
            print(f"[17 serve] fused {serving['fused'][0]:.3f} pairs/s beside the unfused bf16-linear rung's "
                  f"{serving['kernel'][0]:.3f} here and {bf16_linear['pairs_per_s']:.3f} in phase 6 (peak "
                  f"{bf16_linear['peak']} bytes); no gain is claimed")
            require(served["K5-self"] > 0 and served["K5-cross"] > 0, f"fused serving never launched K5: {served}")
        del model, fn
        torch.cuda.empty_cache()

    # the int8 rung under "fused": the int8 projections are outside the contract, and the fallback is exact attention
    model = serve.build_model(IMG, ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, device="cuda",
                              seed=SEED, int8=True)
    fn = serve.make_serving_fn(model, "cuda")
    config.set_attention_quant("int8")
    try:
        res, launches = run(fn, "fused")
    finally:
        config.set_attention_quant("none")
    k4 = ENC_DEPTH * 4 + (2 if ENC_DIM != DEC_DIM else 0) + DEC_DEPTH * 2 * 8
    want8 = {"K1": ENC_DEPTH + DEC_DEPTH * 4, "K2": 2 * (ENC_DEPTH + DEC_DEPTH * 4), "K4": k4, "K5-self": 0,
             "K5-cross": 0, "K6": 0, "K7": 0}
    print(f"[17 fused int8] int8 trunk, attention quant int8, 'fused': launches per forward_pair {launches} "
          f"(want {want8}: the JAX routing rule)")
    require(launches == want8, f"fused int8: launches {launches}, want {want8}")
    require(all(torch.isfinite(t).all().item() for t in res), "fused int8: non-finite output")
    del model, fn
    torch.cuda.empty_cache()
    return {k: path[k] + served[k] for k in path}


# (name, B, Nq, Nk, H), D = 64, bf16: the sweep script's shape, then K1's four phase-3 shapes
K8_CASES = [("sweep script", 16, 1024, 1024, 16), ("encoder 512", 4, 1024, 1024, 16),
            ("decoder 512", 2, 1024, 1024, 12), ("encoder 224", 4, 196, 196, 16), ("Nq != Nk", 2, 300, 1000, 12)]


def sv_only_tensor_cores(torch, q, k, v, check=True):
    """K8's function as two torch.matmul: the scores from cuBLAS's bf16 product (fp32 sums on the tensor cores,
    rounded to bf16), then S.V in fp32 for the check, or in bf16 (the yardstick's time) with ``check=False``."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2))
    return (torch.matmul(s.float(), vt.float()) if check else torch.matmul(s, vt)).transpose(1, 2).to(q.dtype)


def k8_check(torch, out, ref, ref_tc):
    "(ulps from the tensor-core composition, relative error-norm from the plain version, whether both pass)."
    ulps = _ulps(out, ref_tc, 7, floor=K8_ULP_FLOOR)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    return ulps, rel, ulps <= K8_ULPS and rel <= K8_REL_TOL


def mufu_exp2_per_s(torch, mhz):
    "An estimate of the card's exp2 rate on the MUFU at an SM clock of mhz: SMs x MUFU_EXP2_PER_CLOCK x mhz."
    return torch.cuda.get_device_properties(0).multi_processor_count * MUFU_EXP2_PER_CLOCK * mhz * 1e6


def sm_clock_under_load(torch, fn, seconds=2.0):
    """The SM clock and power that nvidia-smi reads (every 50 ms) while fn runs back to back for about
    ``seconds`` as CUDA-graph replays of 20 calls: the medians over the samples taken at utilization.gpu >= 90%,
    as (MHz, W, samples), or None when no such sample was read."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    try:
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu,clocks.sm,power.draw",
                                "--format=csv,noheader,nounits", "-lms", "50"],
                               stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None
    try:
        time.sleep(1.0)  # the sampler's start-up
        end, n = time.perf_counter() + seconds, 0
        while time.perf_counter() < end:
            graph.replay()
            n += 1
            if n % 10 == 0:  # at most 10 replays queued, so the load ends with the window
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate(timeout=30)[0]
    busy = []
    for line in text.splitlines():
        try:
            util, mhz, watts = (float(x) for x in line.split(","))
        except ValueError:
            continue
        if util >= 90:
            busy.append((mhz, watts))
    if not busy:
        return None
    mid = len(busy) // 2
    return sorted(m for m, _ in busy)[mid], sorted(w for _, w in busy)[mid], len(busy)


def phase_sv_only(torch, sv, fa):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    max_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    _, B, Nq, Nk, H = K8_CASES[0]
    load_gen = torch.Generator(device="cuda").manual_seed(SEED + 9)  # gen's draws for the cases stay as they were
    q, k, v = (torch.randn(B, n, H, 64, device="cuda", generator=load_gen).bfloat16() for n in (Nq, Nk, Nk))
    load = sm_clock_under_load(torch, lambda: fa.flash_attention(q, k, v))
    load_mhz = load[0] if load else max_mhz
    exp2_max, exp2_load = mufu_exp2_per_s(torch, max_mhz), mufu_exp2_per_s(torch, load_mhz)
    print(f"[18 K8] SM clock under K1's load at {K8_CASES[0][0]}: "
          + (f"median {load[0]:.0f} MHz, {load[1]:.1f} W over {load[2]} samples at >= 90% utilization"
             if load else "not read (no nvidia-smi sample at >= 90% utilization)")
          + f"; max SM clock {max_mhz:.0f} MHz. MUFU exp2 rate, an estimate at {MUFU_EXP2_PER_CLOCK} per clock per "
          f"SM: {exp2_max / 1e12:.3f} T/s at the max clock, {exp2_load / 1e12:.3f} T/s at the clock under load")
    worst, main = 0.0, None
    for name, B, Nq, Nk, H in K8_CASES:
        q = torch.randn(B, Nq, H, 64, device="cuda", generator=gen).bfloat16()
        k, v = (torch.randn(B, Nk, H, 64, device="cuda", generator=gen).bfloat16() for _ in range(2))
        out, ref = sv.sv_only(q, k, v), sv.sv_only_ref(q, k, v)
        require(torch.isfinite(out).all().item(), f"K8 {name}: non-finite output")
        ulps, rel, ok = k8_check(torch, out, ref, sv_only_tensor_cores(torch, q, k, v))
        err = (out.float() - ref.float()).abs().max().item()
        # K8 and K1 in turns (K8, K1, K1, K8), each the mean of its two readings
        k8_fn, k1_fn = (lambda: sv.sv_only(q, k, v)), (lambda: fa.flash_attention(q, k, v))
        k8_a, k1_a, k1_b, k8_b = (graph_ms(torch, fn) for fn in (k8_fn, k1_fn, k1_fn, k8_fn))
        ms, k1_ms = (k8_a + k8_b) / 2, (k1_a + k1_b) / 2
        plain_ms = graph_ms(torch, lambda: sv.sv_only_ref(q, k, v))
        sdpa_ms = graph_ms(torch, lambda: sdpa(q, k, v))
        two_ms = graph_ms(torch, lambda: sv_only_tensor_cores(torch, q, k, v, check=False))
        k8_bound = attention_bound(B, Nq, Nk, H)
        flops, exps = 4 * B * H * Nq * Nk * 64, B * H * Nq * Nk
        print(f"[18 K8] {name:12s} B={B} Nq={Nq} Nk={Nk} H={H} D=64 bf16: vs tensor-core scores {ulps:.2f} ulp of "
              f"max(|out|, {K8_ULP_FLOOR}) (tol {K8_ULPS}); vs plain ||err||/||plain|| {rel:.3e} (tol {K8_REL_TOL}), "
              f"max|err| {err:.3e}")
        print(f"[18 K8] {name:12s} K8 {ms:.4f} ms ({k8_a:.4f}, {k8_b:.4f}; {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{k8_bound[0] / ms:.3f} of the bound), K1 {k1_ms:.4f} ms ({k1_a:.4f}, {k1_b:.4f}; "
              f"{flops / k1_ms / 1e9:.1f} TFLOP/s), SDPA {sdpa_ms:.4f} ms, two bf16 torch.matmul {two_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {k8_bound[0]:.4f} ms ({k8_bound[1]}) (CUDA graph); (K1 - K8) / K1 "
              f"{(k1_ms - ms) / k1_ms:.3f}; K8 <= K1: {ms <= k1_ms}; {exps} exponentials in K1 (one per score), "
              f"alone on the MUFU an estimated {exps / exp2_max * 1e3:.4f} ms at the max clock, "
              f"{exps / exp2_load * 1e3:.4f} ms at the clock under load")
        require(ok, f"K8 {name}: {ulps} ulp from the tensor-core composition, {rel} from the plain version")
        worst = max(worst, err)
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=two_ms, bound=k8_bound)
            # the diagnostic path: the sweep's timing of S.V at its shape, calls counted
            sv.sv_only.launches = 0
            diag_ms = cuda_ms(torch, lambda: sv.sv_only(q, k, v), warmup=3, iters=30)
            main["launches"] = sv.sv_only.launches
            print(f"[18 K8] diagnostic run: {main['launches']} launches, {diag_ms:.4f} ms per call (CUDA events)")
            require(main["launches"] > 0, "the diagnostic path never launched K8")
    return worst, main


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
    from uniception_tpu_torch.nn import blocks, quant
    from uniception_tpu_torch.ops import conv3x3 as c3
    from uniception_tpu_torch.ops import flash_attention as fa
    from uniception_tpu_torch.ops import fused_attention as fused
    from uniception_tpu_torch.ops import gemm
    from uniception_tpu_torch.ops import int8_matmul as i8
    from uniception_tpu_torch.ops import kernel_lib, rope
    from uniception_tpu_torch.ops import sv_only as sv
    from uniception_tpu_torch.parallel import training

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    card = phase_card()
    phase_build(kernel_lib)
    k1_err, k1 = phase_flash_attention(torch, fa, kernel_lib)
    k2_err, k2 = phase_rope(torch, rope, make_patch_positions)

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
    k3_err, k3 = phase_flash_bwd(torch, fa)
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

    k4_err, k4 = phase_int8_matmul(torch, F, i8, gemm)
    k6_err, k6 = phase_int8_attention(torch, fa)
    k7_err, k7 = phase_conv3x3(torch, F, c3)
    counters = _kernel_counters(fa, rope, i8, c3, fused)
    dpt = phase_int8_dpt(torch, np, serve, config, quant, fa, counters)
    rungs = phase_serving_rungs(torch, np, serve, config, counters, card, bf16_linear)
    served = {k: sum(rungs[r]["launches"][k] for r in ("int8-linear", "bf16-DPT fp32 heads", "int8-DPT")) + dpt[k]
              for k in counters}

    k5_err, k5 = phase_fused_attention(torch, F, fused, fa, rope, make_patch_positions)
    fused_path = phase_fused_model(torch, np, serve, config, blocks, fused, counters, card, bf16_linear,
                                   rungs["int8-DPT device ms"])
    k8_err, k8 = phase_sv_only(torch, sv, fa)

    def entry(name, source, replaces, n, err, m):
        return {"name": name, "route": "cuda", "source": f"uniception_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound"][0], "bound_by": m["bound"][1], "library_ms": m["library_ms"]}

    kernels = [
        entry("flash_attention_fwd", "flash_attention.cu", "uniception_tpu/ops/flash_attention.py:194",
              launches["flash_attention_fwd"] + trained["flash_attention_fwd"] + served["K1"], k1_err, k1),
        entry("flash_attention_bwd", "flash_attention_bwd.cu", "uniception_tpu/ops/flash_attention.py:436",
              trained["flash_attention_bwd"], k3_err, k3),
        entry("rope2d", "rope.cu", "uniception_tpu/ops/rope.py:126",
              launches["rope2d"] + trained["rope2d_fwd"] + trained["rope2d_bwd"] + served["K2"], k2_err, k2),
        entry("int8_matmul_dynamic", "int8_matmul.cu", "uniception_tpu/ops/int8_matmul.py:50", served["K4"], k4_err,
              k4),
        entry("fused_qkv_rope_attention", "fused_attention.cu", "uniception_tpu/ops/fused_attention.py:244",
              fused_path["K5-self"], k5_err["self"], k5["self"]),
        entry("fused_cross_rope_attention", "fused_attention.cu", "uniception_tpu/ops/fused_attention.py:325",
              fused_path["K5-cross"], k5_err["cross"], k5["cross"]),
        entry("flash_attention_int8", "flash_attention_int8.cu", "uniception_tpu/ops/flash_attention.py:130",
              served["K6"], k6_err, k6),
        entry("conv3x3_nhwc", "conv3x3.cu", "uniception_tpu/ops/conv3x3.py:47", served["K7"], k7_err, k7),
        entry("sv_only", "flash_attention.cu", "scripts/sweep_attention.py:75", k8["launches"], k8_err, k8),
    ]
    require(all(k["launches"] > 0 for k in kernels), f"a kernel was never launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
