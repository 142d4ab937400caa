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
               SM clock and at the clock nvidia-smi reads under K1's load;
   19. checkpoints: DUSt3R ViT-L 512 DPT from seed 0 written as an fp32
               .pth, the .npz interchange file and a bf16 .nsv in the JAX
               scan layout (convert_checkpoints --serving), each loaded by
               serve.build_model(checkpoint=...) bit for bit equal to the
               in-memory model cast to the file's dtype; file sizes and the
               time to weights of each;
   20. bucketed: DUSt3R 512 with landscape_only (ManyAR, bf16 trunk, bf16
               DPT heads on K7) serving JAX _bucket_loop's synthetic
               mixed-aspect stream through the five DUSt3R-512 buckets:
               pairs/s; per bucket the kernel path against the plain path
               (decoder features, K7 alone, every kernel) and its device ms
               per batch; exact K1, K2 and K7 launches for a batch with
               portrait rows; K1, K6 and K7 timed at each bucket's shapes
               and transposes; one int8-DPT batch at 336x512 with each K6
               call held against its plain version;
   21. flow:   UFMFlow 512 with the DPT head serving the same stream through
               the buckets and their portrait canvases, each canvas's
               kernel path against the plain path;
   22. multiview: the N-frame multi-view pointmap model at
               scripts/bench_multiview.py's width (ViT-L 512 encoder, 12-deep
               768-wide info sharing, batch 1, tanh GELU), 4 views alternating
               and global, 8 views alternating: kernels against the plain path
               (every view's pts3d and conf, the info sharing's features) with
               exact launches, frames/s, device ms per forward, busy share and
               peak memory; on 4-view alternating also int8 attention, "fused"
               and the int8 rung, each K6, K5 and K4 call held against its
               plain version; K1 at the global streams' lengths (4096, 8192
               tokens) and a frame's, beside SDPA and the bound.
   23. K3 long: K1 with its logsumexp and K3 at (1, N, 12, 64) for the
               multi-view global streams (N = 4096, 8192, 3077), in bf16 ulps
               of max(|plain|, 1/64) against their plain versions with
               dropped-tile controls; K3's time beside SDPA's backward and
               the bound;
   24-29. training as examples/train_dust3r.py and scripts/bench_train.py
               run it, at the full width of DUSt3R ViT-L 512 (bf16 trunk over
               fp32 parameters and AdamW state, seed 0): one step's loss and
               gradients through the kernels against the plain path at phase
               10's bars, the exact launches of a step, ms/step, the busy
               share and peak memory of (24) the DPT heads (bf16, on K7, head
               remat on; the peak with it off beside), (25) mixed-aspect
               ManyAR batches on the 512 x 768 canvas with a portrait row,
               (26) UFMFlow DPT on NaN-sentinel targets, (27) the 4-view
               alternating multi-view model with gradient checkpointing (the
               key count of every K1 and K3 launch; frames/s), (28) LoRA rank
               8 on the trunk (only the adapters move; the merged model's
               forward equals the wrapped one; under "fused" the wrapped
               projections take K1 and K2, the merged ones K5), (29) one step
               in the "fused" implementation (K5, its backward through K2, K1
               and K3);
   30. resume: the training entry point at ViT-L 512's width with its
               depth cut to 2 (--warmup-cosine, --mu-bf16, clipping and
               --skip-nonfinite): 4 steps against 2 steps with an
               asynchronous save, then --resume and 2 more; the train states
               must be equal bit for bit;
   31. dinov2: DINOv2-L/14 with registers at 518, batch 2, through
               encoder_factory (seed 0): features and cls + register tokens
               through the kernels against the plain path with an fp32 trunk,
               then bf16 (24 K1), under "fused" (24 K5: no RoPE, a qkv bias,
               N = 1374; each call held against its plain version), and a
               qk-norm variant under "fused" (no K5: 24 K1); ViT-g/14-reg at
               518, batch 1, bf16, all 40 blocks (SwiGLU-fused FFN; 40 K1);
               DUNE-base at 448 (12 K1); each with images/s, device ms per
               forward, busy share and peak memory;
   32. dino K1: K1 at the DINOv2 paths' ragged key counts (2, 1374, 16, 64),
               (1, 1374, 24, 64), (2, 1029, 12, 64) and (1, 2738, 16, 64) in
               bf16 ulps with the ragged tile's keys dropped as the control,
               beside SDPA and the bound; K5 without RoPE with a qkv bias at
               DINOv2-L's shape and K6 at its 224 shape beside their plain
               versions, the library calls and the bounds;
   33. dino surgery: DINOv2-L-reg's intermediate features after block 11 of
               two 518 views, then a 12-deep global info sharing initialised
               by convert_dino_to_info_sharing from blocks 12-23 and loaded
               strict, against the plain path (K1 12 at 1374 keys, 12 at
               2738); DINOv2-L-reg at 224 under int8 attention (24 K6, N =
               261), each call against its plain version;
   34. zoo K1: K1 at the encoder zoo's head dims and shapes (RADIO-h 80,
               PE-G14 96, DINOv3-7b 128, E-RADIO's windows 32, Pixio-H 80),
               bf16 in ulps with two controls (the ragged key tile dropped,
               the last 16 head-dim columns zeroed) and fp32, with and
               without the logsumexp, beside the plain version, SDPA and the
               bound; K2 on DINOv3's patch tokens (a strided view) at D = 64
               and 128;
   35. zoo:    the encoder zoo through encoder_factory against the plain path
               with exact launches: RADIO v2.5-H/16 and DINOv3 ViT-L/16 at
               512, batch 2, full depth, fp32 and bf16 trunks (32 K1; 24 K1
               and 48 K2); PE-Core-G14 at 448 and DINOv3-7b at 512 (depth
               cut), Pixio-H at 256, E-RADIO v2 at 512 (10 K1 over windows of
               1024 and 256 tokens), DINOv3 ConvNeXt-base, the dense
               representation encoder (3 K7 under the 3x3-conv kernel) and
               the global one; images/s, device ms, busy share and peak
               memory of each bf16 forward;
   36. heads:  DINOv2-L/14-reg at 518, batch 2, bf16, its levels after
               blocks 5, 11, 17 and 23 into every head at its published widths:
               in bf16 under the 3x3-conv kernel DPTFeature at DPT-Large with
               the regression and segmentation processors; in fp32 on TF32
               MoGeConvFeature at MoGe-v1's defaults, PoseHead, GlobalHead and
               MLPFeature, against
               the plain path with exact launches (K1 24, K7 18 per forward),
               each head's adaptors on the card against the CPU, images/s,
               device ms and peak memory; K7 at the eight DPT-Large shapes
               beside cuDNN and the bound;
   37. differential: DUSt3R ViT-L 512 with bf16 DPT heads (K7) and the 12-deep,
               768-wide differential cross-attention info sharing with RoPE100
               (6 differential heads per block), batch 2 pairs: exact launches
               (K1 48, K2 144, K7 34), every K2 call against its plain version,
               the info sharing's features, K7 alone and the outputs against
               the plain path, pairs/s, device ms and peak memory; K2 at the
               differential sub-head shapes beside its plain version and the
               bound.
   38. cosmos K1: K1 at D = 512 (the Cosmos tokenizer's single-head mid-block
               attention) at (2, 4096), (1, 16384), (2, 1024) and a ragged
               (2, 4100) tokens, bf16 in ulps with the last key tile dropped
               as the control and fp32, with and without the logsumexp,
               beside the plain version, SDPA (each backend that takes D =
               512 timed alone, the default's named) and the bound;
   39. cosmos: the CI and DI tokenizers through ImageTokenizer at their
               published widths: CI8x8 and CI16x16 at 512 x 2 in bf16 (K7)
               and fp32, CI8x8 at 1024 x 1 and DI16x16 at 512 x 2 in bf16,
               against the plain path with exact launches (K1 2; K7 39 at
               CI8x8, 40 at CI16x16, 42 at DI16x16 per autoencode) and every
               K7 and K1 call held against its plain version, the
               reconstructions no farther from the fp32 path than the plain
               path's, the DI indices that flip, images/s, device ms and peak
               memory; K7 at the tokenizers' conv shapes beside cuDNN and the
               bound; the image CLI once on a PNG;
   40. cosmos encoder and head: encoder_factory("cosmos") at CI8x8 and
               CI16x16, 512 x 2, bf16 (K1 1, K7 16), and CosmosFeature 768 -> 3
               (three CI16x16 decoders: K1 3, K7 72) into
               FlowWithConfidenceAdaptor, each against the plain path with
               exact launches, images/s and device ms.
   41. head dims: K1, K3, K6 and K5 at every padded head dim each is built
               for and at D = 20 (padded into a copy), Nq != Nk with ragged
               tiles, bf16 and fp32 (K6 bf16, its prep bit for bit), against
               their plain versions at the bars above (K1 with its two
               controls, K5 with positions dropped as the control); then each
               at the new paths' shapes beside the plain version, SDPA (its
               backward alone for K3; cuBLAS's qkv GEMM + SDPA for K5) and
               the bound;
   42. training example: python -m uniception_tpu_torch.train with the
               JAX example's defaults (64 wide, 4 heads: D = 16, fp32, 10
               steps) through the kernels (exact launches: K1-LSE, K3 and K2
               at D = 16) and on the plain path, step by step;
   43. training at ViT-L 512's width, 24 deep, batch 2, bf16, 8 heads (D =
               128) and 32 (D = 32): one step's loss and gradients against
               the plain path (depth cut to 4), exact launches at depth 24
               (K3 120 a step), ms/step, device ms and peak memory;
   44. zoo fused: RADIO v2.5-H/16 at 512 and Pixio-H at 256 under "fused"
               (K5-self 32 per forward at D = 80, every call against its
               plain version), against "kernel" and the plain path;
   45. zoo int8: int8 attention on Pixio-H at 256 (K6 32 at D = 80), E-RADIO
               at 512 (K6 10 at D = 32) and the differential DUSt3R-DPT 512
               (K6 24 at D = 64 and 24 at D = 128), every K6 call against its
               plain version, the outputs against int8 attention's plain path;
   46. PE pool: PE-Core-G14 at 448 (8 of 50 blocks) through the vision
               tower's pooled forward: K1 8 at D = 96 and 1 at D = 192 (the
               attention pool), against the plain path.
   47. redesigned kernels: K1's fp32 kernel (3xTF32 on wgmma) at every
               padded head dim and at the fp32 paths' shapes (the Cosmos
               tokenizer's (2, 4096, 1, 512), the fp32 DUSt3R trunk, DINOv2-L,
               RADIO-h, the training example's D = 16), and K3's whole-width
               kernels above D = 64 at every padded head dim and at ViT-L
               training's D = 128, against their plain versions (K3 also bit
               for bit across two calls), each timed beside the plain version,
               SDPA (its backward alone for K3) and the bound; the fp32 K3
               kernels beside SDPA's fp32 backward.
   48. int8 transforms: DUSt3R ViT-L 512 with linear heads through the
               int8 weight-transform path (calibrate_gptq, nn/gptq.py,
               nn/smooth.py): Hessians and activation maxima of the 289
               trunk linears over 2 calibration pairs (RandomState(7)) of the
               bf16 model through K1 and K2 (72 and 144 per forward), every H
               finite and symmetric, and the capture's seconds; SmoothQuant
               (alpha 0.25) and QuaRot on an fp32 copy leave the kernel path's
               outputs within phase 5's fp32 bar, and the analytically updated
               Hessians of three layers equal a fresh fp32 capture on the
               transformed model; GPTQ of every layer in fp32 on the card (its
               seconds, the median and worst H-metric ratio against RTN), three
               layers (d_in 768, 1024, 4096) against float64 on the CPU; the
               ladder RTN, + smooth, + rotate, GPTQ, GPTQ + smooth + rotate on 2
               held-out pairs (RandomState(42)) through K4, K1 and K2 with
               exact launches, each rung's pts3d bill against the fp32 plain
               path (GPTQ's below RTN's); every K4 call of the last rung
               against its plain version (equal codes, ulps);
               serve.build_model(int8, gptq=npz) bit for bit the in-memory
               GPTQ model's codes, serve_frames of RTN and of GPTQ + smooth +
               rotate (pairs/s, peak memory), and convert_checkpoints --int8
               --gptq to an .nsv (in a temporary directory inside the
               checkout, removed at the end) read back bit for bit.
   49. cosmos video: CV8x8x8 and DV8x16x16 through CausalVideoTokenizer at
               the published widths over 17-frame clips (RandomState(0)):
               CV at 512 x 2 bf16 and x 1 fp32, DV at 512 x 2 bf16, CV at
               1024 x 1 bf16, against the plain path with exact launches (K1
               2 per autoencode at D = 512, the mid blocks; no K7 with the
               3x3-conv kernel on) and every K1 call held against its plain
               version on the same activations (bf16 in ulps with the
               dropped-tile control, fp32 at phase 47's bars); latents,
               reconstructions no farther from the fp32 path than the plain
               path's, DV's FSQ indices that flip, frames/s, device ms and
               peak memory; the video CLI once on the card;
   50. PE language: PE-Core-L14-336 CLIP through CLIP.from_config in bf16
               and fp32 on 8 images and 8 token sequences: encode_image
               (K1 24 at D = 64, 1 at D = 128) and encode_text (no kernel)
               against the plain path, the logit scale; the Llama
               BaseTransformer (1024 wide, 16 heads over 4 kv heads, 8
               layers, 2 x 1024 tokens) with mask=None (K1 8) and "causal"
               (none); images/s, texts/s and device ms; then K1 at the new
               shapes of both phases beside its plain version, SDPA and the
               bound.

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

import gc
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
# K1 at the multi-view model's shapes (phase 22), in bf16 ulps of max(|plain|, 1/64): over N random keys the output is
# an average of about N / e values, |o| ~ 0.02-0.7, so an absolute bar sized for |o| ~ 2-4 would pass a kernel that
# drops a key tile. Both outputs are one rounding of fp32 sums taken in another order, and a p that rounds to the
# other bf16 neighbour moves its row by about 2^-8 of one key's weight: the more so the fewer the keys (K5's bar at
# N = 1024 is 16). The control, the plain version without its last key tile (128 keys), must land at least
# K1_MV_CONTROL_ULPS away, so the bar can see a lost tile; the phase prints both.
K1_MV_ULPS, K1_MV_ULP_FLOOR, K1_MV_CONTROL_ULPS = 8, 1 / 64, 32
K8_REL_TOL = 1e-3
# Published peaks of the H100 SXM (dense) and its memory rate: the bound of each kernel's work. "tf32x3": fp32 products
# taken as three TF32 products on the tensor cores (K1's fp32 kernel), 495 TFLOP/s over three.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "tf32x3": 495e12 / 3}
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


def attention_bound(B, Nq, Nk, H, D=64, elem_bytes=2):
    "Attention's two products (4 Nq Nk D per (b, h)) in bf16 against q, k, v and o."
    return bound({"bf16": 4 * B * H * Nq * Nk * D}, (2 * Nq + 2 * Nk) * B * H * D * elem_bytes)


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


def dpt_k7_convs(h, w, recomputed_only=False):
    """(H, W, C, Co) of the convs of one DPT head pass on an h x w image that the K7 rule (nn/dpt_parts.py
    Conv2dTorch.takes_conv3x3) sends to the kernel: 3x3 / stride 1 with C and Co multiples of 128 at H * W <= 256^2.
    ``recomputed_only``: those of the stages head remat recomputes (all but the four layer*_rn convs)."""
    hp, wp = h // 16, w // 16  # the token grid
    h4, w4 = -(-hp // 2), -(-wp // 2)  # after act_4's stride-2 conv
    convs = [  # every 3x3 / stride-1 conv of the head
        (4 * hp, 4 * wp, 96, 256), (2 * hp, 2 * wp, 192, 256), (hp, wp, 384, 256), (h4, w4, 768, 256),  # layer*_rn
        *[(h4, w4, 256, 256)] * 2, *[(hp, wp, 256, 256)] * 4, *[(2 * hp, 2 * wp, 256, 256)] * 4,  # RCUs
        *[(4 * hp, 4 * wp, 256, 256)] * 4, (8 * hp, 8 * wp, 256, 128), (h, w, 128, 128),  # RCUs, regressor convs
    ]
    return [c for c in convs[4 if recomputed_only else 0:]
            if c[0] * c[1] <= 256 * 256 and c[2] % 128 == 0 and c[3] % 128 == 0]


def k7_convs_per_forward(img):
    "The K7 launches of one DUSt3R DPT forward_pair at img x img: one pass of each of the two heads."
    return 2 * len(dpt_k7_convs(img, img))


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
                   "K3": ("fa_bwd_",), "K4": ("quant_rows_kernel", "DequantBiasEpilogue"),
                   "K5 projection": ("BiasRopeEpilogue", "PadRopeEpilogue"), "K6": ("fa8_",), "K7": ("conv3x3",)}


def profile_serving(torch, fn, frames, label="15 profile int8-DPT", top=14):
    """Device time by kernel over 3 serving batches (torch.profiler), the top entries and the device-busy share,
    then each hand-written kernel's device ms per batch (all its launches: K4's row quantization and GEMM, K6's
    prep and attention, K7's conv and split-K reduction). Returns the device ms per batch."""
    batches = [(frames[2 * i : 2 * i + 2 * BATCH : 2], frames[2 * i + 1 : 2 * i + 2 * BATCH : 2]) for i in range(3)]
    events = profile_device(torch, lambda: [fn(img1, img2) for img1, img2 in batches], 3, "batch", label, top)
    return kernel_device_ms(events, 3, "batch", label)


def kernel_device_ms(events, n, unit, label):
    """Each hand-written kernel's device ms per unit from profiler events over n units (all its launches: K4's row
    quantization and GEMM, K6's prep and attention, K7's conv and split-K reduction). Returns the device ms per unit."""
    for name, keys in PROFILE_KERNELS.items():
        mine = [e for e in events if any(k in e.key for k in keys)]
        if not mine:
            continue
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / n
        print(f"[{label}] {name}: {ms:.3f} ms/{unit} in {sum(e.count for e in mine) // n} launches/{unit} "
              f"({', '.join(sorted(e.key[:60] for e in mine))})")
    return sum(e.self_device_time_total for e in events) / 1e3 / n


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



# Phases 19-21: the serving entry point as the JAX package's users run it (examples/serve_dust3r.py): checkpoints,
# mixed-aspect bucketed DUSt3R with landscape_only and the UFM flow model, at full width.
BUCKET_PAIRS = 20  # JAX _bucket_loop's synthetic stream: 4 pairs per aspect ratio, so every bucket fills 2 batches
# Every kernel vs the plain path on a bucket's batch, bf16 trunk and bf16 DPT heads with K7, ||d|| / ||plain|| per
# output. The decoder features keep phase 5's bar (MODEL_REL_TOL) and K7 alone phase 14's (K7_HEADS_REL_TOL); the
# outputs through both, the trunk's bf16 gap amplified by the bf16 heads and the exp adaptor, have a bar of their own.
# Measured on an H100 80GB HBM3 (700 W): decoder features 0.94e-2 to 0.98e-2; K7 alone 1.39e-2 to 3.75e-2; every
# kernel 2.40e-2 to 5.38e-2 (DUSt3R), 0.70e-2 to 3.20e-2 (flow). Phase 14's every-kernel bar, 8e-2, holds them.
BUCKET_OUT_REL_TOL = 8e-2


def phase_checkpoints(torch, serve, card):
    """DUSt3R ViT-L 512 DPT from seed 0: an fp32 .pth of its state dict, the .npz interchange file and a bf16 .nsv in
    the JAX scan layout written by convert_checkpoints, each loaded through serve.build_model(checkpoint=...): every
    tensor equals the in-memory model's, cast to the file's dtype and then to the module's, bit for bit. The time to
    weights of each (construct on meta + read + transfer, synchronised) and the file sizes."""
    import shutil
    import tempfile

    from uniception_tpu_torch import convert_checkpoints
    from uniception_tpu_torch.utils.checkpoint import save_checkpoint

    dims = (ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS)
    flags = ["--head", "dpt", "--img-size", str(IMG), "--enc-depth", str(ENC_DEPTH), "--enc-dim", str(ENC_DIM),
             "--enc-heads", str(ENC_HEADS), "--dec-depth", str(DEC_DEPTH), "--dec-dim", str(DEC_DIM),
             "--dec-heads", str(DEC_HEADS)]
    ref = serve.build_model(IMG, *dims, device="cuda", dtype=torch.float32, seed=SEED, head="dpt")
    state = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
    del ref
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=REPO)
    try:
        paths = {"pth": os.path.join(tmp, "dust3r.pth"), "npz": os.path.join(tmp, "dust3r.npz"),
                 "nsv": os.path.join(tmp, "dust3r.nsv")}
        t0 = time.perf_counter()
        torch.save({"model": state}, paths["pth"])
        save_checkpoint(paths["npz"], state)
        convert_checkpoints.main([paths["pth"], paths["nsv"], "--serving", *flags])
        print(f"[19 checkpoints] wrote the .pth, .npz and the bf16 scan-layout .nsv in {time.perf_counter() - t0:.1f}s")
        for fmt, file_dtype in (("pth", torch.float32), ("npz", torch.float32), ("nsv", torch.bfloat16)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = serve.build_model(IMG, *dims, device="cuda", head="dpt", checkpoint=paths[fmt])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = model.state_dict()
            require(sorted(got) == sorted(state), f"{fmt}: the loaded model's keys are not the in-memory model's")
            bad = [k for k, v in got.items()
                   if v.device.type != "cuda" or not torch.equal(v.cpu(), state[k].to(file_dtype).to(v.dtype))]
            dtypes = sorted({str(v.dtype).replace("torch.", "") for v in got.values()})
            print(f"[19 checkpoints] .{fmt}: {os.path.getsize(paths[fmt])} bytes, time to weights {seconds:.2f}s "
                  f"(construct on meta + read + one copy per dtype + layout on the card, synchronised); {len(got)} "
                  f"tensors ({'/'.join(dtypes)}) equal to the in-memory model's as {file_dtype}: {not bad} on {card}")
            require(not bad, f".{fmt}: {len(bad)} tensors differ from the in-memory model's, e.g. {bad[:3]}")
            del model, got
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def first_bucket_batches(pairs, buckets, manyar):
    "The first full batch of each bucket that the pair stream fills: {(h, w): (canvas1, canvas2, true_shape1, 2)}."
    import torch

    from uniception_tpu_torch.data.bucketing import PairBucketedBatcher

    batcher, first = PairBucketedBatcher(BATCH, buckets, manyar=manyar), {}
    for key, img1, img2 in pairs:
        for hw, c1, c2, t1, t2, _ in batcher.add(img1, img2, key):
            first.setdefault(hw, (c1, c2, torch.from_numpy(t1), torch.from_numpy(t2)))
    return first


def bucket_check(torch, config, model, fn, batch, label, names):
    """One bucket batch three ways: every kernel, K7 on its plain version (the trunk's kernels unchanged), and the
    plain path. The decoder features and K7 alone within their bars, the outputs within BUCKET_OUT_REL_TOL."""
    import uniception_tpu_torch.nn.dpt_parts as dpt_parts
    from uniception_tpu_torch.ops import conv3x3 as c3

    trunk = []

    def keep(mod, inp, out):
        final = out[0] if isinstance(out, tuple) else out
        trunk.append(torch.cat([f.float().flatten() for f in final.features]))

    hook = model.info_sharing.register_forward_hook(keep)
    try:
        res_k = fn(*batch)
        dpt_parts.conv3x3_nhwc = c3.conv3x3_reference
        try:
            res_s = fn(*batch)
        finally:
            dpt_parts.conv3x3_nhwc = c3.conv3x3_nhwc
        config.set_attention_impl("naive")
        try:
            res_n = fn(*batch)
        finally:
            config.set_attention_impl("kernel")
        torch.cuda.synchronize()
    finally:
        hook.remove()
    t_k, t_s, t_n = trunk

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    require(torch.equal(t_k, t_s), f"{label}: the trunk moved when only K7 changed")
    trunk_rel = rel(t_k, t_n)
    worst = {"trunk": trunk_rel, "k7": 0.0, "out": 0.0}
    line = [f"decoder features {trunk_rel:.3e} (tol {MODEL_REL_TOL})"]
    require(trunk_rel <= MODEL_REL_TOL, f"{label}: decoder features kernels vs plain {trunk_rel} > {MODEL_REL_TOL}")
    for name, a, s_, b in zip(names, res_k, res_s, res_n):
        require(all(torch.isfinite(t).all().item() for t in (a, s_, b)), f"{label} {name}: non-finite output")
        r_k, r_s = rel(a, b), rel(a, s_)
        worst["k7"], worst["out"] = max(worst["k7"], r_s), max(worst["out"], r_k)
        line.append(f"{name} K7 alone {r_s:.3e} every kernel {r_k:.3e}")
        require(r_s <= K7_HEADS_REL_TOL, f"{label} {name}: K7 alone moves the output by {r_s} > {K7_HEADS_REL_TOL}")
        require(r_k <= BUCKET_OUT_REL_TOL, f"{label} {name}: kernels vs plain {r_k} > {BUCKET_OUT_REL_TOL}")
    print(f"[{label}] vs plain: " + "; ".join(line) + f" (tols: K7 alone {K7_HEADS_REL_TOL}, every kernel "
          f"{BUCKET_OUT_REL_TOL})")
    return worst, res_k


def bucket_device_ms(torch, fn, batch, label):
    "Device ms per batch and the busy share of two back-to-back batches of one bucket (torch.profiler)."
    events = profile_device(torch, lambda: [fn(*batch) for _ in range(2)], 2, "batch", label, top=0)
    return sum(e.self_device_time_total for e in events) / 1e3 / 2


def bucket_kernel_times(torch, F, fa, c3, buckets):
    "K1, K6 and K7 at each bucket's shapes beside their plain versions and library calls (CUDA graphs)."
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    for h, w in buckets:
        hp, wp = h // 16, w // 16
        n = hp * wp
        x = torch.randn(4, n, 3, 16, 64, device="cuda", generator=gen).bfloat16()
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        k1 = graph_ms(torch, lambda: fa.flash_attention(q, k, v))
        lib = graph_ms(torch, lambda: sdpa(q, k, v))
        k6 = graph_ms(torch, lambda: fa.flash_attention_int8(q, k, v, mode="int8"))
        b1 = attention_bound(4, n, n, 16)
        conv = []
        for hh, ww in ((4 * hp, 4 * wp), (4 * wp, 4 * hp)):  # refinenet1's RCUs, and on the transposed grid
            xc = torch.randn(BATCH, hh, ww, 256, device="cuda", generator=gen).bfloat16()
            wt = (torch.randn(3, 3, 256, 256, device="cuda", generator=gen) * (9 * 256) ** -0.5).bfloat16()
            bc = torch.randn(256, device="cuda", generator=gen) * 0.1
            ulps = _ulps(c3.conv3x3_nhwc(xc, wt, bc), c3.conv3x3_reference(xc, wt, bc), 7, floor=1 / 16)
            require(ulps <= K7_ULPS, f"K7 at {hh}x{ww}: {ulps} ulp > {K7_ULPS}")
            ms = graph_ms(torch, lambda: c3.conv3x3_nhwc(xc, wt, bc))
            xn, wn = xc.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            cudnn = graph_ms(torch, lambda: F.conv2d(xn, wn, bc.bfloat16(), padding=1))
            kb = bound({"bf16": 2 * BATCH * hh * ww * 256 * 256 * 9}, (2 * xc.numel() + wt.numel()) * 2)
            conv.append(f"K7 {BATCH}x{hh}x{ww}x256->256 {ms:.4f} ms (cuDNN {cudnn:.4f}, bound {kb[0]:.4f} {kb[1]}, "
                        f"{ulps:.2f} ulp)")
        print(f"[20 kernels {h}x{w}] K1 (4,{n},16,64) {k1:.4f} ms (SDPA {lib:.4f}, bound {b1[0]:.4f} {b1[1]}); K6 int8 "
              f"{k6:.4f} ms; " + "; ".join(conv))


def phase_bucketed(torch, F, np, serve, config, quant, fa, c3, counters, card):
    """DUSt3R 512 with landscape_only, ManyAR, bf16 trunk and bf16 DPT heads on K7, serving JAX _bucket_loop's
    synthetic mixed-aspect stream through the five DUSt3R-512 buckets; per bucket the kernel path against the plain
    path, exact launches for one batch with portrait rows, device ms per batch, then one int8-DPT batch at 336x512
    with each K6 call held against its plain version. Returns the stream's launches."""
    import uniception_tpu_torch.ops.attention as attention
    from uniception_tpu_torch.data.bucketing import extract_view

    buckets = serve.scaled_buckets(IMG)
    pairs = list(serve.synthetic_pairs(BUCKET_PAIRS, IMG, seed=SEED))
    model = serve.build_model(IMG, ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, device="cuda",
                              seed=SEED, head="dpt", head_dtype=torch.bfloat16, landscape_only=True)
    fn = serve.make_serving_fn(model, "cuda")
    names = ("pts3d", "conf1", "pts3d_in_other_view", "conf2")
    config.set_conv3x3_impl("kernel")
    try:
        _reset(counters)
        stats = serve.serve_bucketed(model, "cuda", pairs, BATCH, buckets)
        launches = _read(counters)
        full = {hw: sum(1 for b in stats["batches"] if b == hw) for hw in buckets}
        print(f"[20 bucketed] {stats['pairs']} pairs in {stats['seconds']:.3f}s = {stats['pairs'] / stats['seconds']:.3f} "
              f"pairs/s through {len(buckets)} buckets {list(buckets)} at batch {BATCH} (host resizing included, each "
              f"bucket warmed once in {stats['warm_seconds']:.2f}s); pairs per bucket "
              f"{ {f'{h}x{w}': n for (h, w), n in stats['per_bucket'].items()} }, batches {full}; launches {launches} "
              f"on {card}")
        require(stats["pairs"] == BUCKET_PAIRS, f"served {stats['pairs']} pairs of {BUCKET_PAIRS}")
        require(all(stats["per_bucket"].get(hw, 0) >= BATCH for hw in buckets), f"a bucket got no full batch: {full}")
        out, t2, _ = stats["last"]
        native = [extract_view(out[2][i], t2[i]).shape for i in range(BATCH)]
        print(f"[20 bucketed] the last batch's second views in their native orientation: {native}")

        t0 = time.perf_counter()
        batches = first_bucket_batches(pairs, buckets, manyar=True)
        resize_s = time.perf_counter() - t0
        print(f"[20 bucketed] the host's bucketing of the stream alone (PairBucketedBatcher: {2 * len(pairs)} images "
              f"resized and cropped, no device work): {resize_s:.3f}s, {1e3 * resize_s / (2 * len(pairs)):.1f} ms per "
              f"image, {len(pairs) / resize_s:.2f} pairs/s")
        device_ms = {}
        for hw in buckets:
            c1, c2, t1, t2 = batches[hw]
            bucket_check(torch, config, model, fn, batches[hw], f"20 bucket {hw[0]}x{hw[1]} portrait rows "
                         f"{(t1[:, 0] > t1[:, 1]).tolist()}/{(t2[:, 0] > t2[:, 1]).tolist()}", names)
            device_ms[hw] = bucket_device_ms(torch, fn, batches[hw], f"20 profile {hw[0]}x{hw[1]}")
        per_batch = "; ".join(f"{h}x{w} {ms:.2f}" for (h, w), ms in device_ms.items())
        stream_device_s = sum(device_ms[hw] for hw in stats["batches"]) / 1e3
        print(f"[20 bucketed] device ms per batch: {per_batch}; summed over the stream's {len(stats['batches'])} "
              f"batches {stream_device_s:.3f}s of its {stats['seconds']:.3f}s (busy share "
              f"{stream_device_s / stats['seconds']:.3f})")

        # exact launches for one eager batch with portrait rows: the heads of a view with a portrait row run twice
        hw = next(b for b in buckets if any((t[:, 0] > t[:, 1]).any() for t in batches[b][2:]))
        c1, c2, t1, t2 = batches[hw]
        _reset(counters)
        fn(*batches[hw])
        torch.cuda.synchronize()
        got = _read(counters)
        attn = ENC_DEPTH + DEC_DEPTH * 2 * 2
        passes = [1 + bool((t[:, 0] > t[:, 1]).any()) for t in (t1, t2)]
        want = {k: 0 for k in counters}
        want.update(K1=attn, K2=2 * attn, K7=sum(p * len(dpt_k7_convs(*hw)) for p in passes))
        print(f"[20 bucketed] launches for one batch at {hw[0]}x{hw[1]} (head passes per view {passes}): {got} "
              f"(want {want})")
        require(got == want, f"bucketed launches {got}, want {want}")

        bucket_kernel_times(torch, F, fa, c3, buckets)

        # the int8-DPT rung on one batch of the 336x512 bucket: each K6 call against its plain version
        n_q = quant.quantize_trunk(model, "all")
        k6_ulps, k6_ctrl = [], []

        def k6_checked(q, k, v, scale=None, mode="int8"):
            o = fa.flash_attention_int8(q, k, v, scale, mode)
            ref = fa.flash_attention_int8_ref(q, k, v, scale, mode)
            k6_ulps.append(_ulps(o, ref, 7, floor=K6_ULP_FLOOR))
            k6_ctrl.append(_ulps(fa.flash_attention_ref(q, k, v, scale), ref, 7, floor=K6_ULP_FLOOR))
            return o

        config.set_attention_quant("int8")
        attention.flash_attention_int8 = k6_checked
        try:
            res = fn(*batches[(336, 512)])
            torch.cuda.synchronize()
        finally:
            attention.flash_attention_int8 = fa.flash_attention_int8
            config.set_attention_quant("none")
        require(all(torch.isfinite(r).all().item() for r in res), "int8-DPT 336x512: non-finite output")
        print(f"[20 int8-DPT 336x512] {n_q} trunk linears quantized; {len(k6_ulps)} K6 calls (N = 672), each against "
              f"its plain version on the same activations: max {max(k6_ulps):.2f} ulp (tol {K6_ULPS}); exact "
              f"attention, the control: {sum(c > K6_ULPS for c in k6_ctrl)} calls over the tol, max {max(k6_ctrl):.2f}")
        require(len(k6_ulps) == attn, f"{len(k6_ulps)} K6 calls, want {attn}")
        require(max(k6_ulps) <= K6_ULPS, f"int8-DPT 336x512: a K6 call is {max(k6_ulps)} ulp from its plain version")
        require(max(k6_ctrl) > K6_ULPS, "int8-DPT 336x512: exact attention passed K6's check")
    finally:
        config.set_conv3x3_impl("torch")
    del model, fn
    torch.cuda.empty_cache()
    return launches


def phase_flow(torch, np, serve, config, counters, card):
    """UFMFlow 512 with the DPT head (bf16 trunk, bf16 head on K7) serving the same stream through the buckets and
    their portrait canvases (manyar=False); per canvas the kernel path against the plain path. Returns the launches."""
    buckets = serve.scaled_buckets(IMG, portrait=True)
    pairs = list(serve.synthetic_pairs(BUCKET_PAIRS, IMG, seed=SEED))
    model = serve.build_model(IMG, ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, device="cuda",
                              seed=SEED, head="dpt", head_dtype=torch.bfloat16, model="flow")
    fn = serve.make_serving_fn(model, "cuda")
    config.set_conv3x3_impl("kernel")
    try:
        _reset(counters)
        stats = serve.serve_bucketed(model, "cuda", pairs, BATCH, buckets)
        launches = _read(counters)
        print(f"[21 flow] {stats['pairs']} pairs in {stats['seconds']:.3f}s = {stats['pairs'] / stats['seconds']:.3f} "
              f"pairs/s through {len(buckets)} canvases at batch {BATCH} (host resizing included); pairs per canvas "
              f"{ {f'{h}x{w}': n for (h, w), n in stats['per_bucket'].items()} }; launches {launches} on {card}")
        require(stats["pairs"] == BUCKET_PAIRS, f"flow served {stats['pairs']} pairs of {BUCKET_PAIRS}")
        out = stats["last"][0]
        require(tuple(out[0].shape[-1:]) == (2,) and tuple(out[1].shape[-1:]) == (1,), "flow: output shapes")
        batches = first_bucket_batches(pairs, buckets, manyar=False)
        for hw, batch in batches.items():
            model.adaptor.value_adaptor.base_shape = list(hw)  # as serve_bucketed sets it per bucket
            bucket_check(torch, config, model, fn, batch, f"21 flow {hw[0]}x{hw[1]}", ("flow", "flow_conf"))
        require(len(batches) >= 5, f"flow: only {len(batches)} canvases got a full batch")
    finally:
        config.set_conv3x3_impl("torch")
    del model, fn
    torch.cuda.empty_cache()
    return launches


# Phase 22: scripts/bench_multiview.py's configuration: the ViT-L 512 encoder and the 12-deep, 768-wide multi-view info
# sharing, batch 1, tanh GELU; (views, info sharing) in the order run. The int8 rung, int8 attention and "fused" run on
# the first.
MV_CONFIGS = [(4, "alternating"), (4, "global"), (8, "alternating")]
MV_BATCH, MV_FORWARDS, MV_PROFILED = 1, 5, 3
MV_K1_SHAPES = [  # (name, B, N, H, keys the control drops: one 128-key tile)
    ("global 4 views", 1, 4096, 12, 128), ("global 8 views", 1, 8192, 12, 128), ("frame", 4, 1024, 12, 128)]


def mv_want(attention_type, rung, counters):
    """Exact launches per multi-view forward at batch 1: the encoder's 24 attention layers run once over the views
    folded into the batch; the info sharing's 12 depths are all global, or alternate global (even) and frame (odd)."""
    glob = DEC_DEPTH if attention_type == "global" else DEC_DEPTH // 2
    frame, want = DEC_DEPTH - glob, {k: 0 for k in counters}
    if rung == "int8 attention":  # one key block holds the encoder's and a frame's 1024 keys, not V * 1024
        want.update(K6=ENC_DEPTH + frame, K1=glob, K2=2 * ENC_DEPTH)
    elif rung == "fused":  # the fused contract takes at most 2048 keys, and the info sharing has no RoPE
        want.update({"K5-self": ENC_DEPTH + frame, "K1": glob})
    else:
        want.update(K1=ENC_DEPTH + DEC_DEPTH, K2=2 * ENC_DEPTH)
        if rung == "int8":  # qkv, proj, fc1, fc2 of every block, and proj_embed once over the whole stream
            want.update(K4=ENC_DEPTH * 4 + (ENC_DIM != DEC_DIM) + DEC_DEPTH * 4)
    return want


def counted_forward(torch, counters, fwd, label, want, total):
    "One eager forward with the counts from 0; they must be ``want`` exactly; added to ``total``."
    _reset(counters)
    out = fwd()
    torch.cuda.synchronize()
    got = _read(counters)
    print(f"[{label}] launches per forward {got} (want {want})")
    require(got == want, f"{label}: launches {got}, want {want}")
    for k in total:
        total[k] += got[k]
    return out


def forward_timing(torch, fwd, n, unit, per_forward, label, card, top=8):
    """``unit``/s (n per forward: CUDA events over MV_FORWARDS forwards after one warm-up), peak memory over them,
    device ms per forward (torch.profiler over MV_PROFILED forwards) with each kernel's share, and the busy share."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(MV_FORWARDS):
        fwd()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / MV_FORWARDS
    peak = torch.cuda.max_memory_allocated()
    events = profile_device(torch, lambda: [fwd() for _ in range(MV_PROFILED)], MV_PROFILED, "forward", label, top)
    device_ms = kernel_device_ms(events, MV_PROFILED, "forward", label)
    rate = n * 1e3 / ms
    print(f"[{label}] {rate:.3f} {unit}/s ({per_forward}; {ms:.3f} ms per forward by CUDA events "
          f"over {MV_FORWARDS} forwards after one warm-up); device {device_ms:.3f} ms per forward (torch.profiler, "
          f"{MV_PROFILED} forwards); busy share {device_ms / ms:.3f} (device ms over the unprofiled ms per forward); "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.3f} GiB) on {card}")


def mv_timing(torch, fwd, views, label, card):
    "frames/s of a multi-view forward (V * B frames), its device ms, busy share and peak memory."
    forward_timing(torch, fwd, views * MV_BATCH, "frames", f"{views} views x batch {MV_BATCH}", label, card)


def k1_times(torch, fa, card, shapes, label, seed):
    """K1 at (name, B, N, H, lost) shapes (q, k, v strided views of one qkv tensor, as in the layers) in bf16 ulps of
    max(|plain|, 1/64), the plain version without the last ``lost`` keys as the control, beside SDPA and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, B, N, H, lost in shapes:
        q, k, v = torch.randn(B, N, 3, H, 64, device="cuda", generator=gen, dtype=torch.bfloat16).unbind(2)
        out, ref = fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        ulps = _ulps(out, ref, 7, floor=K1_MV_ULP_FLOOR)
        control = _ulps(fa.flash_attention_ref(q, k[:, :-lost], v[:, :-lost]), ref, 7, floor=K1_MV_ULP_FLOOR)
        del out, ref
        require(ulps <= K1_MV_ULPS, f"K1 {name}: {ulps} ulps of max(|plain|, 1/64) vs plain > {K1_MV_ULPS}")
        require(control >= K1_MV_CONTROL_ULPS, f"K1 {name}: the control (last {lost} keys dropped) is {control} "
                f"ulps away, under {K1_MV_CONTROL_ULPS}: the bar cannot see a lost key tile")
        ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v))
        lib = graph_ms(torch, lambda: sdpa(q, k, v))
        b = attention_bound(B, N, N, H)
        tflops = 4 * B * H * N * N * 64 / 1e9
        print(f"[{label}] {name} ({B},{N},{H},64), {N // 128} full key tiles + {N % 128}: {ulps:.2f} ulps of "
              f"max(|plain|, 1/64) vs plain (tol {K1_MV_ULPS}; max abs {err:.2e}), the plain version without its last "
              f"{lost} keys {control:.1f} ulps; {ms:.4f} ms ({tflops / ms:.1f} TFLOP/s), SDPA {lib:.4f} ms "
              f"({tflops / lib:.1f} TFLOP/s), {ms / lib:.3f}x SDPA, bound {b[0]:.4f} ms ({b[1]}), share of the bound "
              f"{b[0] / ms:.3f} (CUDA graphs) on {card}")
        del q, k, v
        torch.cuda.empty_cache()


def phase_multiview(torch, np, serve, config, blocks, quant, fa, fused, i8, counters, card):
    """The N-frame multi-view pointmap model at scripts/bench_multiview.py's full width, 512x512, batch 1, from seed 0:
    4 views alternating and global, 8 views alternating. For each the kernel path against the plain path (every
    view's pts3d and conf, the info sharing's features) with exact launches on an eager forward and its timing; on
    4-view alternating also int8 attention (each K6 call against its plain version), "fused" (each K5 call against
    its plain version) and the int8 rung (each K4 call's codes and output against its plain version). Then K1 at the
    long shapes. Returns the launches of the counted forwards."""
    import uniception_tpu_torch.ops.attention as attention

    prep = serve.make_frame_normalizer("dust3r", "cuda")
    frames = np.random.RandomState(SEED).randint(0, 256, size=(8 * MV_BATCH, IMG, IMG, 3), dtype=np.uint8)
    launches = {k: 0 for k in counters}

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def counted(fwd, label, want):
        return counted_forward(torch, counters, fwd, label, want, launches)

    config.set_gelu_mode("tanh")  # bench_multiview.py's GELU
    try:
        for views, attention_type in MV_CONFIGS:
            tag = f"22 {views}-view {attention_type}"
            model = serve.build_model(IMG, ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS, device="cuda",
                                      seed=SEED, model="multiview", num_views=views, attention_type=attention_type)
            imgs = [prep(frames[v * MV_BATCH:(v + 1) * MV_BATCH]) for v in range(views)]
            feats = []
            hook = model.info_sharing.register_forward_hook(
                lambda mod, inp, out: feats.append(torch.cat([f.float().flatten() for f in out.features])))

            def fwd():
                with torch.inference_mode():
                    return model(imgs)

            config.set_attention_impl("naive")
            try:
                res_n = fwd()
                torch.cuda.synchronize()
            finally:
                config.set_attention_impl("kernel")
            res_k = counted(fwd, tag, mv_want(attention_type, "bf16", counters))
            feat_k, feat_n = feats.pop(), feats.pop()
            hook.remove()
            errs = [rel(feat_k, feat_n)]
            for v, (a, b) in enumerate(zip(res_k, res_n)):
                for key, c in (("pts3d", 3), ("conf", 1)):
                    require(tuple(a[key].shape) == (MV_BATCH, IMG, IMG, c), f"{tag} view {v} {key}: {a[key].shape}")
                    require(torch.isfinite(a[key]).all().item(), f"{tag} view {v} {key}: non-finite output")
                    errs.append(rel(a[key], b[key]))
            print(f"[{tag}] kernels vs plain path, ||kernel - plain|| / ||plain||: info-sharing features "
                  f"{errs[0]:.3e}, every view's pts3d and conf max {max(errs[1:]):.3e} (tol {MODEL_REL_TOL})")
            require(max(errs) <= MODEL_REL_TOL, f"{tag}: kernels vs plain {max(errs)} > {MODEL_REL_TOL}")
            mv_timing(torch, fwd, views, tag, card)

            if (views, attention_type) == MV_CONFIGS[0]:
                k6_ulps, k6_ctrl = [], []

                def k6_checked(q, k, v, scale=None, mode="int8"):
                    o = fa.flash_attention_int8(q, k, v, scale, mode)
                    ref = fa.flash_attention_int8_ref(q, k, v, scale, mode)
                    k6_ulps.append(_ulps(o, ref, 7, floor=K6_ULP_FLOOR))
                    k6_ctrl.append(_ulps(fa.flash_attention_ref(q, k, v, scale), ref, 7, floor=K6_ULP_FLOOR))
                    return o

                config.set_attention_quant("int8")
                attention.flash_attention_int8 = k6_checked
                try:
                    res = counted(fwd, f"{tag} int8 attention", mv_want(attention_type, "int8 attention", counters))
                finally:
                    attention.flash_attention_int8 = fa.flash_attention_int8
                    config.set_attention_quant("none")
                require(all(torch.isfinite(r[k]).all().item() for r in res for k in r), f"{tag} int8 attn: non-finite")
                print(f"[{tag} int8 attention] {len(k6_ulps)} K6 calls, each against its plain version on the same "
                      f"activations: max {max(k6_ulps):.2f} ulp (tol {K6_ULPS}); exact attention, the control: "
                      f"{sum(c > K6_ULPS for c in k6_ctrl)} calls over the tol, max {max(k6_ctrl):.2f}")
                require(max(k6_ulps) <= K6_ULPS, f"{tag}: a K6 call is {max(k6_ulps)} ulp from its plain version")
                require(max(k6_ctrl) > K6_ULPS, f"{tag}: exact attention passed K6's check")

                k5_ulps = []

                def k5_checked(*args):
                    out = fused.fused_qkv_rope_attention(*args)
                    k5_ulps.append(k5_check(out, fused.fused_qkv_rope_attention_ref(*args), True)[0])
                    return out

                config.set_attention_impl("fused")
                blocks.fused_qkv_rope_attention = k5_checked
                try:
                    res = counted(fwd, f"{tag} fused", mv_want(attention_type, "fused", counters))
                finally:
                    blocks.fused_qkv_rope_attention = fused.fused_qkv_rope_attention
                    config.set_attention_impl("kernel")
                require(all(torch.isfinite(r[k]).all().item() for r in res for k in r), f"{tag} fused: non-finite")
                print(f"[{tag} fused] {len(k5_ulps)} K5-self calls, each against its plain version on the same "
                      f"activations: max {max(k5_ulps):.2f} ulp of max(|plain|, {K5_ULP_FLOOR}) (tol {K5_ULPS})")
                require(max(k5_ulps) <= K5_ULPS, f"{tag}: a K5 call is {max(k5_ulps)} ulp from its plain version")

                n_q = quant.quantize_trunk(model, "all")
                want = mv_want(attention_type, "int8", counters)
                require(n_q == want["K4"], f"{tag}: {n_q} trunk linears quantized, want {want['K4']}")
                k4_codes, k4_ulps = [], []

                def k4_checked(x, w_q, w_scale, bias=None, out_dtype=None):
                    out = i8.int8_matmul_dynamic(x, w_q, w_scale, bias, out_dtype)
                    x2 = x.reshape(-1, x.shape[-1]).contiguous()
                    x_q = torch.empty(x2.shape, dtype=torch.int8, device=x.device)
                    a_scale = torch.empty(x2.shape[0], dtype=torch.float32, device=x.device)
                    # the codes K4's launch writes to its scratch, from an uncounted launch on the same inputs
                    i8._launch(x2, x_q, a_scale, w_q.t().contiguous(), w_scale, bias, out_dtype or x.dtype, None)
                    ref_q, ref_scale = i8.quantize_rows(x2)
                    k4_codes.append(torch.equal(x_q, ref_q) and torch.equal(a_scale, ref_scale.reshape(-1)))
                    k4_ulps.append(_ulps(out, i8.int8_matmul_dynamic_ref(x, w_q, w_scale, bias, out_dtype), 7))
                    return out

                quant.int8_matmul_dynamic = k4_checked
                try:
                    res = counted(fwd, f"{tag} int8 trunk", want)
                finally:
                    quant.int8_matmul_dynamic = i8.int8_matmul_dynamic
                require(all(torch.isfinite(r[k]).all().item() for r in res for k in r), f"{tag} int8: non-finite")
                print(f"[{tag} int8 trunk] {n_q} trunk linears quantized; {len(k4_codes)} K4 calls, each against its "
                      f"plain version: int8 codes and row scales equal in {sum(k4_codes)}, output max "
                      f"{max(k4_ulps):.2f} ulp (tol {K4_ULPS})")
                require(all(k4_codes), f"{tag}: a K4 call's int8 codes differ from its plain version's")
                require(max(k4_ulps) <= K4_ULPS, f"{tag}: a K4 call is {max(k4_ulps)} ulp from its plain version")
                mv_timing(torch, fwd, views, f"{tag} int8 trunk", card)
            del model, imgs, res_k, res_n
            torch.cuda.empty_cache()
    finally:
        config.set_gelu_mode("exact")
    k1_times(torch, fa, card, MV_K1_SHAPES, "22 K1", SEED + 22)
    return launches


# Phases 23-30: the training entry point as JAX users run it (examples/train_dust3r.py, scripts/bench_train.py) at
# ViT-L 512 with the 12-deep, 768-wide decoder, bf16 trunk over fp32 parameters and AdamW state, seed 0.
# K3 and K1 with its logsumexp at the multi-view model's global stream lengths, in bf16 ulps of max(|plain|, 1/64), as
# phase 22 holds K1: set from a probe on an H100 80GB HBM3 (700 W) that ran phase 23's computation (measured at most
# 3.74 ulps over dq, dk and dv, K1's output 2.31). The controls, the plain dq without the last 128 keys and the plain
# dk and dv without the last 128 queries (and K1's output without the last 128 keys), must land at least
# K3_MV_CONTROL_ULPS away (measured 343 and more): the bar sees a lost tile of keys or queries.
K3_MV_ULPS, K3_MV_CONTROL_ULPS = 8, 32
K3_MV_SHAPES = [("global 4 views", 4096), ("global 8 views", 8192), ("3 views + 5 global tokens", 3077)]
TRAIN_TIMED_STEPS = 3  # steps timed by CUDA events after one warm-up step, and profiled
LORA_RANK, LORA_STEPS = 8, 3
MV_TRAIN_VIEWS = 4


def _train_counters(fa, rope, c3, fused):
    """Every launch counter a training step moves: name -> (module, function, attribute), read through the module
    so that a counting wrapper put in a function's place is what is read."""
    return {"K1": (fa, "flash_attention", "launches"), "K1-LSE": (fa, "flash_attention", "lse_launches"),
            "K3": (fa, "flash_attention_bwd", "launches"), "K2": (rope, "rope_2d_kernel", "launches"),
            "K2-bwd": (rope, "rope_2d_kernel", "backward_launches"),
            "K5-self": (fused, "fused_qkv_rope_attention", "launches"),
            "K5-cross": (fused, "fused_cross_rope_attention", "launches"), "K7": (c3, "conv3x3_nhwc", "launches")}


def _treset(tc):
    for mod, fn, attr in tc.values():
        setattr(getattr(mod, fn), attr, 0)


def _tread(tc):
    return {k: getattr(getattr(mod, fn), attr) for k, (mod, fn, attr) in tc.items()}


def _tadd(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def k7_train_launches(h, w, remat):
    """K7 launches of one DPT head pass on an h x w image in a training step: its K7 convs in the forward, and with
    head remat those of the refinenets and the regressor once more in the backward (the layer*_rn convs run before
    the recomputed stages). The backward's own convs are cuDNN's (Conv3x3Function)."""
    return len(dpt_k7_convs(h, w)) + (len(dpt_k7_convs(h, w, recomputed_only=True)) if remat else 0)


def train_want(tc, attn, rope_attn, k7=0, passes=1):
    """Exact launches of one training step: ``attn`` attention layers (K1 with its logsumexp, then K3), ``rope_attn``
    of them with RoPE on q and k (K2 both ways), each forward run ``passes`` times (2: recomputed under gradient
    checkpointing), and ``k7`` K7 launches."""
    want = {k: 0 for k in tc}
    want.update({"K1": passes * attn, "K1-LSE": passes * attn, "K3": attn, "K2": passes * 2 * rope_attn,
                 "K2-bwd": 2 * rope_attn, "K7": k7})
    return want


def grads_by_impl(torch, config, model, loss_fn, args, impl):
    "(loss, {name: gradient}) of loss_fn(model, *args) over the parameters that train, under attention ``impl``."
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    config.set_attention_impl(impl)
    try:
        loss = loss_fn(model, *args)
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        torch.cuda.synchronize()
    finally:
        config.set_attention_impl("kernel")
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, grads)}


def check_train_grads(torch, config, model, loss_fn, args, label, fused=False, per_parameter=True):
    """One step's loss and gradients through the kernels (or "fused") against the plain path on the same model and
    batch, at phase 10's bf16 bars (without ``per_parameter``, the per-parameter bar is printed and not held: the loss
    and all gradients together are). Every gradient must be finite."""
    lk, gk = grads_by_impl(torch, config, model, loss_fn, args, "fused" if fused else "kernel")
    ln, gn = grads_by_impl(torch, config, model, loss_fn, args, "naive")

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    require(torch.isfinite(lk).item() and all(torch.isfinite(g).all().item() for g in gk.values()),
            f"{label}: a non-finite loss or gradient")
    per = sorted(((rel(gk[k], gn[k]), k) for k in gk if gn[k].abs().max().item() > 0), reverse=True)
    glob = rel(torch.cat([g.float().flatten() for g in gk.values()]), torch.cat([g.float().flatten() for g in gn.values()]))
    loss_rel = abs(lk.item() - ln.item()) / abs(ln.item())
    vals = sorted(x for x, _ in per)
    print(f"[{label}] loss kernels {lk.item():.6f} plain {ln.item():.6f} (rel {loss_rel:.2e}, tol {TRAIN_BF16_LOSS_TOL}); "
          f"gradients over {len(gk)} parameters, kernels vs plain: all together {glob:.3e} (tol {TRAIN_BF16_GLOBAL_TOL}); "
          f"per parameter median {vals[len(vals) // 2]:.3e}, worst {[(f'{x:.3e}', n) for x, n in per[:2]]} "
          f"(tol {TRAIN_BF16_REL_TOL})")
    require(loss_rel <= TRAIN_BF16_LOSS_TOL, f"{label}: loss kernels vs plain {loss_rel} > {TRAIN_BF16_LOSS_TOL}")
    require(per[0][0] <= TRAIN_BF16_REL_TOL or not per_parameter,
            f"{label}: kernels vs plain {per[0]} > {TRAIN_BF16_REL_TOL}")
    require(glob <= TRAIN_BF16_GLOBAL_TOL, f"{label}: all gradients kernels vs plain {glob} > {TRAIN_BF16_GLOBAL_TOL}")
    del gk, gn
    torch.cuda.empty_cache()


def counted_step(torch, tc, ctx, args, want, label):
    "One ctx.step with every count from 0; the counts must be ``want`` exactly. Returns them and the loss."
    _treset(tc)
    loss = ctx.step(*args)
    torch.cuda.synchronize()
    got = _tread(tc)
    print(f"[{label}] launches per step {got} (want {want})")
    require(got == want, f"{label}: launches per step {got}, want {want}")
    require(math.isfinite(loss.item()), f"{label}: non-finite loss {loss.item()}")
    return got


def timed_steps(torch, ctx, args, label, card, samples, unit):
    """ms/step by CUDA events over TRAIN_TIMED_STEPS steps after one warm-up, the rate of ``samples`` per step,
    device ms per step and its busy share (torch.profiler over TRAIN_TIMED_STEPS steps); returns the peak memory
    since the last reset."""
    ms = cuda_ms(torch, lambda: ctx.step(*args), warmup=1, iters=TRAIN_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    events = profile_device(torch, lambda: [ctx.step(*args) for _ in range(TRAIN_TIMED_STEPS)], TRAIN_TIMED_STEPS,
                            "step", label, 10)
    device_ms = kernel_device_ms(events, TRAIN_TIMED_STEPS, "step", label)
    print(f"[{label}] {ms:.2f} ms/step (CUDA events over {TRAIN_TIMED_STEPS} steps after one warm-up) = "
          f"{samples * 1e3 / ms:.3f} {unit}/s; device {device_ms:.2f} ms/step (busy share {device_ms / ms:.3f}); "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.3f} GiB) on {card}")
    return peak


def phase_k3_long(torch, fa, card):
    """K1 with its logsumexp and K3 at (1, N, 12, 64) for the multi-view global streams, on strided views of one
    projection as the layers make them, each against its plain version in bf16 ulps of max(|plain|, 1/64), with
    dropped-tile controls; K3's time beside SDPA's backward alone and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    for name, n in K3_MV_SHAPES:
        q = torch.randn(1, n, 3, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)[:, :, 0]
        kv = torch.randn(1, n, 2, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)
        k, v = kv[:, :, 0], kv[:, :, 1]
        dout = torch.randn(1, n, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)
        out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        qf, kf, vf, of, df = (t.float() for t in (q, k, v, out, dout))
        oref, lref = fa.flash_attention_lse_ref(qf, kf, vf)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout)
        refs = fa.flash_attention_bwd_ref(qf, kf, vf, of, lse, df)
        o_c, l_c = fa.flash_attention_lse_ref(qf, kf[:, :-128], vf[:, :-128])
        dq_c = fa.flash_attention_bwd_ref(qf, kf[:, :-128], vf[:, :-128], o_c, l_c, df)[0]
        _, dk_c, dv_c = fa.flash_attention_bwd_ref(qf[:, :-128], kf, vf, of[:, :-128], lse[..., :-128], df[:, :-128])
        out_ulps, out_ctrl = _ulps(out, oref, 7, K1_MV_ULP_FLOOR), _ulps(o_c, oref, 7, K1_MV_ULP_FLOOR)
        lse_err = (lse - lref).abs().max().item()
        ulps = [_ulps(g, r, 7, K1_MV_ULP_FLOOR) for g, r in zip(grads, refs)]
        ctrl = [_ulps(c, r, 7, K1_MV_ULP_FLOOR) for c, r in zip((dq_c, dk_c, dv_c), refs)]
        del o_c, l_c, dq_c, dk_c, dv_c
        ms = graph_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout))
        plain_ms = graph_ms(torch, lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, dout))
        lib_ms = sdpa_bwd_ms(torch, q, k, v, dout)[0]
        flops = 10 * 12 * n * n * 64
        b = bound({"bf16": flops}, (4 * n + 5 * n) * 12 * 64 * 2 + 12 * n * 4)
        print(f"[23 K3 long] {name} (1,{n},12,64): K1+LSE output {out_ulps:.2f} ulps (tol {K1_MV_ULPS}; control "
              f"{out_ctrl:.1f}), LSE max|err| {lse_err:.2e} (tol {LSE_TOL['bf16']}); K3 dq dk dv "
              f"{' '.join(f'{x:.2f}' for x in ulps)} ulps of max(|plain|, 1/64) (tol {K3_MV_ULPS}), controls "
              f"{' '.join(f'{x:.1f}' for x in ctrl)} (>= {K3_MV_CONTROL_ULPS}); K3 {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, SDPA backward alone {lib_ms:.4f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]}), "
              f"share of the bound {b[0] / ms:.3f} (CUDA graphs) on {card}")
        require(out_ulps <= K1_MV_ULPS and out_ctrl >= K1_MV_CONTROL_ULPS, f"K1+LSE {name}: {out_ulps}, {out_ctrl}")
        require(lse_err <= LSE_TOL["bf16"], f"K1+LSE {name}: LSE error {lse_err}")
        require(max(ulps) <= K3_MV_ULPS, f"K3 {name}: {ulps} ulps > {K3_MV_ULPS}")
        require(min(ctrl) >= K3_MV_CONTROL_ULPS, f"K3 {name}: a control is {min(ctrl)} ulps away, under "
                f"{K3_MV_CONTROL_ULPS}: the bar cannot see a lost tile")
        del q, kv, k, v, dout, out, lse, grads, refs
        torch.cuda.empty_cache()


def _dpt_model(torch, DUSt3R, size, **kw):
    "DUSt3R ViT-L with bf16-computing DPT heads (K7) over fp32 parameters, head remat on, from SEED."
    return DUSt3R(name="dust3r_train_dpt", img_size=size, patch_embed_cls="ManyAR_PatchEmbed", pred_head_type="dpt",
                  head_gradient_checkpointing=True, head_dtype=torch.bfloat16, dtype=torch.bfloat16, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(SEED), **kw)


def _pair_loss(training):
    def loss_fn(m, v1, v2, t1, t2):
        r1, r2 = m.forward_pair(v1["img"], v2["img"], true_shape1=v1.get("ts"), true_shape2=v2.get("ts"))
        return training.dust3r_confidence_loss(r1, r2, t1, t2)

    return loss_fn


def _set_head_remat(model, on):
    for head in model.heads():
        head.checkpoint_gradient = on


def phase_train_dpt(torch, np, train, serve, training, config, DUSt3R, tc, card):
    """bench_train's BENCH_HEAD=dpt at batch 2 with head remat on: the heads computing in bf16 so that their convs
    run on K7 (the JAX package's head_dtype; fp32 heads run cuDNN). Gradients vs plain, exact launches, ms/step,
    busy share, peak memory; the peak again with head remat off, from the initial weights and a fresh optimizer."""
    model = _dpt_model(torch, DUSt3R, (IMG, IMG))
    initial = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}  # off the card: not in its peak
    img1, img2, t1, t2 = _train_batch(torch, train, serve, model)
    args = ({"img": img1}, {"img": img2}, t1, t2)
    loss_fn = _pair_loss(training)
    check_train_grads(torch, config, model, loss_fn, args, "24 train DPT")
    ctx = training.make_train_step(model, loss_fn=loss_fn, learning_rate=1e-4)
    attn = ENC_DEPTH + DEC_DEPTH * 2 * 2
    torch.cuda.reset_peak_memory_stats()
    launches = counted_step(torch, tc, ctx, args, train_want(tc, attn, attn, 2 * k7_train_launches(IMG, IMG, True)),
                            "24 train DPT")
    peak = timed_steps(torch, ctx, args, "24 train DPT", card, BATCH, "training pairs")
    _set_head_remat(model, False)
    # Eight steps on one batch take the random-weight DPT loss from 5.8e5 to 1e11-1e14, and the heads' atomic adds
    # (bilinear upsampling, cuDNN's conv backward) make each run's path differ from the second step: on an H100 the
    # ninth step's loss overflowed to inf in 2 of 6 runs. The head-remat-off step starts where the first one did.
    model.load_state_dict(initial)
    del initial, ctx
    gc.collect()  # the first optimizer's state goes before the second's is made: not in the peak below
    ctx = training.make_train_step(model, loss_fn=loss_fn, learning_rate=1e-4)
    torch.cuda.reset_peak_memory_stats()
    counted_step(torch, tc, ctx, args, train_want(tc, attn, attn, 2 * k7_train_launches(IMG, IMG, False)),
                 "24 train DPT, head remat off")
    ctx.step(*args)
    torch.cuda.synchronize()
    off = torch.cuda.max_memory_allocated()
    print(f"[24 train DPT] peak memory with head remat on {peak / 2**30:.3f} GiB, off {off / 2**30:.3f} GiB "
          f"(max_memory_allocated over 2 steps) on {card}")
    del model, ctx, args
    torch.cuda.empty_cache()
    return launches


def phase_train_mixed_ar(torch, np, train, serve, training, config, DUSt3R, tc, card):
    """Mixed-aspect training (--mixed-ar at 512): the 512 x 768 ManyAR canvas (1536 tokens), landscape_only, row 0
    landscape and row 1 portrait, so every head pass runs twice (canvas and transposed grid). With the trunk's
    gradient checkpointing (--remat): without it the plain path's attention probabilities at 1536 tokens outgrow
    the card's 80 GB."""
    h, w = IMG, IMG * 3 // 2
    model = _dpt_model(torch, DUSt3R, (h, w), landscape_only=True, gradient_checkpointing=True)
    data = train.synthetic_mixed_dataset(BATCH, h, w, SEED)
    ts = torch.tensor([[h, w], [w, h]], dtype=torch.int32)  # on the host, where landscape_only reads it
    prep = serve.make_frame_normalizer(model.data_norm_type, "cuda")
    args = ({"img": prep(data["img1"]), "ts": ts}, {"img": prep(data["img2"]), "ts": ts},
            torch.from_numpy(data["pts1"]).cuda(), torch.from_numpy(data["pts2"]).cuda())
    loss_fn = _pair_loss(training)
    check_train_grads(torch, config, model, loss_fn, args, "25 train mixed-AR DPT")
    ctx = training.make_train_step(model, loss_fn=loss_fn, learning_rate=1e-4)
    attn = ENC_DEPTH + DEC_DEPTH * 2 * 2
    k7 = 2 * (k7_train_launches(h, w, True) + k7_train_launches(w, h, True))
    torch.cuda.reset_peak_memory_stats()
    launches = counted_step(torch, tc, ctx, args, train_want(tc, attn, attn, k7, passes=2), "25 train mixed-AR DPT")
    timed_steps(torch, ctx, args, "25 train mixed-AR DPT", card, BATCH, "training pairs")
    del model, ctx, args
    torch.cuda.empty_cache()
    return launches


def phase_train_flow(torch, np, train, serve, training, config, UFMFlow, tc, card):
    "UFMFlow 512 DPT (bf16 head on K7, head remat on) on train.synthetic_flow_dataset: ~10% NaN-sentinel targets."
    model = UFMFlow(name="ufm_train", img_size=(IMG, IMG), pred_head_type="dpt", head_gradient_checkpointing=True,
                    head_dtype=torch.bfloat16, dtype=torch.bfloat16, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(SEED))
    data = train.synthetic_flow_dataset(BATCH, IMG, SEED)
    prep = serve.make_frame_normalizer(model.data_norm_type, "cuda")
    args = (prep(data["img1"]), prep(data["img2"]), torch.from_numpy(data["flow"]).cuda(),
            torch.from_numpy(data["valid"]).cuda())
    invalid = 1 - data["valid"].mean()
    require(0.05 < invalid < 0.15 and np.isnan(data["flow"]).any(), f"flow: {invalid} of the pixels invalid")

    def loss_fn(m, img1, img2, flow, valid):
        return training.flow_confidence_loss(m.forward_pair(img1, img2), flow, valid=valid > 0)

    print(f"[26 train flow] {invalid:.3f} of the pixels invalid, their targets NaN")
    check_train_grads(torch, config, model, loss_fn, args, "26 train flow DPT")
    ctx = training.make_train_step(model, loss_fn=loss_fn, learning_rate=1e-4)
    attn = ENC_DEPTH + DEC_DEPTH * 2 * 2
    want = train_want(tc, attn, attn, k7_train_launches(IMG, IMG, True))
    # the flow head reads view 1's decoder branch: view 2's last block (self and cross attention) gets no gradient
    want.update({"K3": attn - 2, "K2-bwd": 2 * (attn - 2)})
    torch.cuda.reset_peak_memory_stats()
    launches = counted_step(torch, tc, ctx, args, want, "26 train flow DPT")
    timed_steps(torch, ctx, args, "26 train flow DPT", card, BATCH, "training pairs")
    del model, ctx, args
    torch.cuda.empty_cache()
    return launches


def phase_train_multiview(torch, np, serve, training, config, fa, MultiViewPointmapModel, tc, card):
    """bench_train's BENCH_MODEL=multiview: 4 views alternating at 512, batch 1, gradient checkpointing, tanh GELU,
    multiview_confidence_loss; the views ride the first image slot, their targets the first target slot. Gradients
    vs plain, exact launches with the key count of every K1+LSE and K3 launch, frames/s and device ms per step."""
    V = MV_TRAIN_VIEWS
    config.set_gelu_mode("tanh")
    real_fwd, real_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
    try:
        model = MultiViewPointmapModel(name="mv_train", num_views=V, img_size=(IMG, IMG), attention_type="alternating",
                                       gradient_checkpointing=True, dtype=torch.bfloat16, device="cuda",
                                       generator=torch.Generator(device="cuda").manual_seed(SEED))
        rng = np.random.RandomState(SEED)
        prep = serve.make_frame_normalizer(model.data_norm_type, "cuda")
        views = prep(rng.randint(0, 256, (V * MV_BATCH, IMG, IMG, 3), np.uint8)).reshape(V, MV_BATCH, 3, IMG, IMG)
        targets = torch.from_numpy(rng.randn(V, MV_BATCH, IMG, IMG, 3).astype(np.float32)).cuda()
        args = (views, None, targets, None)

        def loss_fn(m, views, _, targets, __):
            return training.multiview_confidence_loss(m(list(views.unbind(0))), list(targets.unbind(0)))

        check_train_grads(torch, config, model, loss_fn, args, "27 train multi-view")
        ctx = training.make_train_step(model, loss_fn=loss_fn, learning_rate=1e-4)
        keys = {"K1-LSE": {}, "K3": {}}

        def fwd_counting(q, k, v, scale=None, with_lse=False):
            if with_lse:
                keys["K1-LSE"][k.shape[1]] = keys["K1-LSE"].get(k.shape[1], 0) + 1
            return real_fwd(q, k, v, scale, with_lse)

        def bwd_counting(q, k, *rest):
            keys["K3"][k.shape[1]] = keys["K3"].get(k.shape[1], 0) + 1
            return real_bwd(q, k, *rest)

        bwd_counting.launches = 0  # K3's wrapper counts itself by its module name: it now counts here
        bwd_counting.head_dims = real_bwd.head_dims
        fa.flash_attention_fwd, fa.flash_attention_bwd = fwd_counting, bwd_counting
        attn = ENC_DEPTH + DEC_DEPTH  # 24 encoder layers over the views as a batch; 6 global + 6 frame layers
        torch.cuda.reset_peak_memory_stats()
        launches = counted_step(torch, tc, ctx, args, train_want(tc, attn, ENC_DEPTH, passes=2), "27 train multi-view")
        glob = DEC_DEPTH // 2
        want_keys = {"K1-LSE": {V * 1024: 2 * glob, 1024: 2 * (attn - glob)}, "K3": {V * 1024: glob, 1024: attn - glob}}
        print(f"[27 train multi-view] launches by key count {keys} (want {want_keys})")
        require(keys == want_keys, f"multi-view training: launches by key count {keys}, want {want_keys}")
        fa.flash_attention_fwd, fa.flash_attention_bwd = real_fwd, real_bwd
        timed_steps(torch, ctx, args, "27 train multi-view", card, V * MV_BATCH, "training frames")
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = real_fwd, real_bwd
        config.set_gelu_mode("exact")
    del model, ctx, args
    torch.cuda.empty_cache()
    return launches


def phase_train_lora(torch, np, train, serve, training, config, lora, DUSt3R, tc, card):
    """--lora 8 on the trunk (linear head, bf16 trunk): only the adapters move, the rest stays bit for bit; the
    merged model's forward equals the wrapped one at phase 5's fp32 bar, the trunk computing in fp32 for both (the
    bf16 gap is printed); under "fused" the wrapped projections leave the fused contract (K1 and K2, no K5) and the
    merged ones take it (K5)."""
    model = DUSt3R(name="dust3r_train_lora", img_size=(IMG, IMG), patch_embed_cls="ManyAR_PatchEmbed",
                   dtype=torch.bfloat16, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    n = lora.apply_lora(model.encoder, LORA_RANK, generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
                        min_params=1)
    n += lora.apply_lora(model.info_sharing, LORA_RANK, generator=torch.Generator(device="cuda").manual_seed(SEED + 2),
                         min_params=1)
    want_n = ENC_DEPTH * 4 + 1 + 2 * DEC_DEPTH * 8  # qkv, proj, fc1, fc2; decoder_embed; per branch 8 linears
    require(n == want_n, f"LoRA wrapped {n} linears, want {want_n}")
    img1, img2, t1, t2 = _train_batch(torch, train, serve, model)
    args = (img1, img2, t1, t2)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ctx = training.make_train_step(model, learning_rate=1e-4, trainable=lora.lora_trainable)
    attn = ENC_DEPTH + DEC_DEPTH * 2 * 2
    launches = counted_step(torch, tc, ctx, args, train_want(tc, attn, attn), "28 train LoRA")
    for _ in range(LORA_STEPS - 1):
        ctx.step(*args)
    torch.cuda.synchronize()
    after = model.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    adapters = [k for k in after if lora.lora_trainable(k)]
    print(f"[28 train LoRA] rank {LORA_RANK} on {n} trunk linears: {sum(p.numel() for p in ctx.params)} trainable "
          f"parameters in {len(ctx.params)} tensors; after {LORA_STEPS} steps {len(moved)} tensors moved, all of them "
          f"adapters: {set(moved) <= set(adapters)}; adapters that moved {len(set(moved) & set(adapters))} of "
          f"{len(adapters)}")
    require(set(moved) == set(adapters), f"LoRA: moved {sorted(set(moved) ^ set(adapters))[:4]} (want the adapters)")

    def forward(impl):
        _treset(tc)
        config.set_attention_impl(impl)
        try:
            with torch.inference_mode():
                r1, r2 = model.forward_pair(img1, img2)
            torch.cuda.synchronize()
        finally:
            config.set_attention_impl("kernel")
        return (r1["pts3d"], r1["conf"], r2["pts3d_in_other_view"], r2["conf"]), _tread(tc)

    trunk = [m for m in model.modules() if getattr(m, "compute_dtype", None) == torch.bfloat16]

    def compute_in(dtype):  # the trunk's compute dtype: its modules cast their fp32 parameters to it at use
        for m in trunk:
            m.compute_dtype = dtype

    def rels(a, b):
        return [((x - y).norm() / y.norm()).item() for x, y in zip(a, b)]

    wrapped16, _ = forward("kernel")
    _, fused_wrapped = forward("fused")
    compute_in(None)  # fp32, where the merged weights hold the adapters' update exactly
    wrapped32, _ = forward("kernel")
    require(lora.merge_lora(model) == n, "LoRA: merge_lora did not fold every adapter")
    merged32, _ = forward("kernel")
    compute_in(torch.bfloat16)
    merged16, _ = forward("kernel")
    _, fused_merged = forward("fused")
    fp32, bf16 = rels(merged32, wrapped32), rels(merged16, wrapped16)
    print(f"[28 train LoRA] merged vs wrapped forward_pair, ||merged - wrapped|| / ||wrapped|| per output, fp32 "
          f"trunk {max(fp32):.3e} (tol {MODEL_FP32_REL_TOL}); bf16 trunk {max(bf16):.3e} (the bf16 cast of a merged "
          f"weight rounds the adapters' small update away, the wrapped layer adds it in a product of its own); "
          f"under \"fused\" the wrapped model launches {fused_wrapped}, the merged one {fused_merged}")
    require(max(fp32) <= MODEL_FP32_REL_TOL, f"LoRA: merged vs wrapped in fp32 {fp32}")
    want_wrapped = {k: 0 for k in tc}
    want_wrapped.update(K1=attn, K2=2 * attn)
    want_merged = {k: 0 for k in tc}
    want_merged.update({"K5-self": ENC_DEPTH + 2 * DEC_DEPTH, "K5-cross": 2 * DEC_DEPTH})
    require(fused_wrapped == want_wrapped, f"LoRA under fused: {fused_wrapped}, want {want_wrapped}")
    require(fused_merged == want_merged, f"merged model under fused: {fused_merged}, want {want_merged}")
    _tadd(launches, fused_wrapped)
    _tadd(launches, fused_merged)
    del model, ctx
    torch.cuda.empty_cache()
    return launches


def phase_train_fused(torch, np, train, serve, training, config, DUSt3R, tc, card):
    """One training step in the "fused" implementation: K5 forward, its backward recomputed through K2, K1 and K3;
    gradients against the plain path, exact launches."""
    model = DUSt3R(name="dust3r_train_fused", img_size=(IMG, IMG), patch_embed_cls="ManyAR_PatchEmbed",
                   dtype=torch.bfloat16, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    args = _train_batch(torch, train, serve, model)

    def loss_fn(m, img1, img2, t1, t2):
        r1, r2 = m.forward_pair(img1, img2)
        return training.dust3r_confidence_loss(r1, r2, t1, t2)

    check_train_grads(torch, config, model, loss_fn, args, "29 train fused", fused=True)
    ctx = training.make_train_step(model, loss_fn=loss_fn, learning_rate=1e-4)
    attn = ENC_DEPTH + DEC_DEPTH * 2 * 2
    want = train_want(tc, attn, attn)
    want.update({"K5-self": ENC_DEPTH + 2 * DEC_DEPTH, "K5-cross": 2 * DEC_DEPTH})
    config.set_attention_impl("fused")
    try:
        launches = counted_step(torch, tc, ctx, args, want, "29 train fused")
    finally:
        config.set_attention_impl("kernel")
    del model, ctx
    torch.cuda.empty_cache()
    return launches


RESUME_FLAGS = ["--device", "cuda", "--img", str(IMG), "--embed-dim", str(ENC_DIM), "--heads", str(ENC_HEADS),
                "--depth", "2", "--batch", str(BATCH), "--dataset-size", "8", "--bf16", "--warmup-cosine", "2",
                "--mu-bf16", "--clip-grad", "1.0", "--skip-nonfinite", "--seed", str(SEED)]


def phase_resume(torch, train, training, tc, card):
    """The entry point's save and --resume on the card (ViT-L 512's width, depth cut to 2): 4 steps uninterrupted
    against 2 steps with an asynchronous save after the first and a final one, then a fresh process state restored
    from the directory and 2 more steps. The two final train states must be equal bit for bit."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=REPO)
    try:
        whole, part = os.path.join(root, "whole"), os.path.join(root, "part")
        _treset(tc)
        t0 = time.perf_counter()
        ref = train.main(RESUME_FLAGS + ["--steps", "4", "--ckpt-dir", whole])
        first = train.main(RESUME_FLAGS + ["--steps", "2", "--ckpt-every", "1", "--ckpt-dir", part])
        second = train.main(RESUME_FLAGS + ["--steps", "2", "--resume", "--ckpt-dir", part])
        seconds = time.perf_counter() - t0
        launches = _tread(tc)
        a, b = (torch.load(os.path.join(d, training.STATE_FILE), map_location="cpu", weights_only=True)
                for d in (whole, part))
        differ = [k for k in a["tensors"] if not torch.equal(a["tensors"][k], b["tensors"][k])]
        counters = {k: (a[k], b[k]) for k in ("step", "count", "mini_step", "notfinite_count")}
        size = os.path.getsize(os.path.join(whole, training.STATE_FILE))
        print(f"[30 resume] {' '.join(RESUME_FLAGS[2:])}: losses uninterrupted {['%.6f' % x for x in ref]}, "
              f"saved and resumed {['%.6f' % x for x in first + second]}; counters (uninterrupted, resumed) "
              f"{counters}; {len(a['tensors'])} tensors, {len(differ)} differ {differ[:5]}; train state "
              f"{size / 2**30:.3f} GiB; {seconds:.1f} s for the three runs on {card}")
        require(first + second == ref, "resume: the resumed run's losses differ from the uninterrupted run's")
        require(not differ and all(x == y for x, y in counters.values()), f"resume: {differ[:5]} {counters}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# Phases 31-33: the DINOv2 encoder family (models/encoders/vit.py, dinov2.py, dune.py) at its published widths
# through the registry's factories, seed 0, and the DINOv2 -> info-sharing surgery (convert_dino_to_info_sharing.py).
# Every size has heads of 64, so the path runs on K1 (no RoPE: no K2), K5 under "fused" and K6 under int8 attention.
DINO_IMG, DINO_BATCH = 518, 2
DUNE_IMG, DINO_INT8_IMG = 448, 224
DINO_L_DEPTH, DINO_G_DEPTH, DUNE_DEPTH = 24, 40, 12
SURGERY_START = 12  # DINOv2-L's blocks 12-23 become a 12-deep global info sharing over two views
# K1 at the DINOv2 paths' key counts, none a multiple of its 128-key tile: 37 x 37 patches + cls + 4 registers at 518,
# 32 x 32 + 5 for DUNE at 448, two views of 37 x 37 patches in the surgery's global stream. Held in bf16 ulps of
# max(|plain|, 1/64) as phase 22 holds K1 (K1_MV_ULPS); the control is the plain version without the ragged last
# tile's keys (the last entry), which must land at least K1_MV_CONTROL_ULPS away: the bar sees a lost zero-filled tile.
DINO_K1_SHAPES = [("DINOv2-L-reg 518", 2, 1374, 16, 94), ("ViT-g-reg 518", 1, 1374, 24, 94),
                  ("DUNE-base 448", 2, 1029, 12, 5), ("surgery global, 2 views", 1, 2738, 16, 50)]


def _dino_tensors(out):
    "The output tensors of an encoder (features, registers), an IFR (each features) or an info sharing (each view's)."
    if isinstance(out, list):
        return [o.features for o in out]
    if hasattr(out, "registers"):
        return [out.features] + ([] if out.registers is None else [out.registers])
    return list(out.features)


def dino_against_plain(torch, config, counters, fwd, label, want, total, tol, impl="kernel"):
    """The plain path (attention "naive"), then ``impl`` counted with exact launches, on the same inputs: every
    output finite and within ``tol`` of the plain one, ||kernel - plain|| / ||plain||. Returns the kernel output."""
    config.set_attention_impl("naive")
    try:
        plain = fwd()
        torch.cuda.synchronize()
    finally:
        config.set_attention_impl("kernel")
    config.set_attention_impl(impl)
    try:
        out = counted_forward(torch, counters, fwd, label, want, total)
    finally:
        config.set_attention_impl("kernel")
    errs = []
    for a, b in zip(_dino_tensors(out), _dino_tensors(plain)):
        require(a.shape == b.shape and torch.isfinite(a).all().item(), f"{label}: {tuple(a.shape)} non-finite or "
                f"not the plain path's {tuple(b.shape)}")
        errs.append(((a.float() - b.float()).norm() / b.float().norm()).item())
    shapes = [tuple(t.shape) for t in _dino_tensors(out)]
    print(f"[{label}] kernels vs plain path, ||kernel - plain|| / ||plain|| of {shapes}: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (tol {tol})")
    require(max(errs) <= tol, f"{label}: kernels vs plain {max(errs)} > {tol}")
    return out


def dino_timing(torch, fwd, images, label, card):
    "images/s of an encoder forward, its device ms, busy share and peak memory."
    forward_timing(torch, fwd, images, "images", f"{images} images per forward", label, card, top=6)


def _dino_input(torch, np, serve, norm, n, size, seed):
    "A (n, 3, size, size) batch of seeded uint8 frames normalized for ``norm`` on the card, as the encoder's input."
    from uniception_tpu_torch.models.encoders import ViTEncoderInput

    frames = np.random.RandomState(seed).randint(0, 256, size=(n, size, size, 3), dtype=np.uint8)
    return ViTEncoderInput(image=serve.make_frame_normalizer(norm, "cuda")(frames), data_norm_type=norm)


def phase_dinov2(torch, np, serve, config, blocks, fused, counters, card):
    """DINOv2-L/14-reg at 518, batch 2, through encoder_factory: fp32 then bf16 trunk against the plain path (24 K1);
    under "fused" (24 K5, each call against its plain version); a qk-norm variant under "fused" (no K5: 24 K1). Then
    ViT-g/14-reg at 518, batch 1, bf16, full depth (40 K1; SwiGLUFFNFused), and DUNE-base at 448 (12 K1). For the
    bf16 ones images/s, device ms, busy share and peak memory. Returns the launches of the counted forwards."""
    from uniception_tpu_torch.models.encoders import encoder_factory

    total = {k: 0 for k in counters}
    none = {k: 0 for k in counters}
    inp = _dino_input(torch, np, serve, "dinov2", DINO_BATCH, DINO_IMG, SEED)
    grid = DINO_IMG // 14
    for trunk, dtype, tol in (("fp32", torch.float32, MODEL_FP32_REL_TOL), ("bf16", torch.bfloat16, MODEL_REL_TOL)):
        tag = f"31 DINOv2-L-reg {trunk}"
        enc = encoder_factory("dinov2", name="dinov2_large", size="large", with_registers=True, device="cuda",
                              seed=SEED, dtype=dtype, param_dtype=dtype).eval()

        def fwd():
            with torch.inference_mode():
                return enc(inp)

        out = dino_against_plain(torch, config, counters, fwd, tag, {**none, "K1": DINO_L_DEPTH}, total, tol)
        require(tuple(out.features.shape) == (DINO_BATCH, 1024, grid, grid), f"{tag}: {tuple(out.features.shape)}")
        require(tuple(out.registers.shape) == (DINO_BATCH, 1024, 5), f"{tag}: {tuple(out.registers.shape)}")
        if dtype == torch.float32:
            del enc, out
            torch.cuda.empty_cache()
            continue
        dino_timing(torch, fwd, DINO_BATCH, tag, card)

        k5_ulps = []

        def k5_checked(*args):
            o = fused.fused_qkv_rope_attention(*args)
            k5_ulps.append(k5_check(o, fused.fused_qkv_rope_attention_ref(*args), True)[0])
            return o

        blocks.fused_qkv_rope_attention = k5_checked
        try:  # no RoPE, a qkv bias, 1374 <= 2048 keys: every layer inside the fused contract
            dino_against_plain(torch, config, counters, fwd, f"{tag} fused", {**none, "K5-self": DINO_L_DEPTH}, total,
                               tol, impl="fused")
        finally:
            blocks.fused_qkv_rope_attention = fused.fused_qkv_rope_attention
        print(f"[{tag} fused] {len(k5_ulps)} K5-self calls (no RoPE, qkv bias, N = 1374), each against its plain "
              f"version on the same activations: max {max(k5_ulps):.2f} ulp of max(|plain|, {K5_ULP_FLOOR}) "
              f"(tol {K5_ULPS})")
        require(len(k5_ulps) == DINO_L_DEPTH and max(k5_ulps) <= K5_ULPS, f"{tag}: K5 calls {k5_ulps}")
        dino_timing(torch, fwd, DINO_BATCH, f"{tag} fused", card)

        for blk in enc.model.blocks:  # the qk-norm variant: a LayerNorm on each head's q and k (JAX nn/blocks.py:345)
            blk.attn.q_norm = blocks.make_norm_layer(64, device="cuda", dtype=dtype).to(dtype)
            blk.attn.k_norm = blocks.make_norm_layer(64, device="cuda", dtype=dtype).to(dtype)
        dino_against_plain(torch, config, counters, fwd, f"{tag} qk-norm fused", {**none, "K1": DINO_L_DEPTH}, total,
                           tol, impl="fused")
        del enc, out
        torch.cuda.empty_cache()

    tag = "31 ViT-g-reg bf16"
    enc = encoder_factory("dinov2", name="dinov2_giant", size="giant", with_registers=True, device="cuda", seed=SEED,
                          dtype=torch.bfloat16, param_dtype=torch.bfloat16).eval()
    require(enc.model.blocks[0].mlp.w3.weight.shape[1] == 4096, "ViT-g: the SwiGLU-fused hidden width is not 4096")
    inp_g = _dino_input(torch, np, serve, "dinov2", 1, DINO_IMG, SEED + 1)

    def fwd_g():
        with torch.inference_mode():
            return enc(inp_g)

    dino_against_plain(torch, config, counters, fwd_g, tag, {**none, "K1": DINO_G_DEPTH}, total, MODEL_REL_TOL)
    dino_timing(torch, fwd_g, 1, tag, card)
    del enc
    torch.cuda.empty_cache()

    tag = f"31 DUNE-base {DUNE_IMG} bf16"
    enc = encoder_factory("dune", name="dune_base", vit_size="base", device="cuda", seed=SEED, dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16).eval()
    with torch.no_grad():  # the 448 PE table starts at zeros (as in the JAX package): give it seeded values
        pe = enc.model.pos_embed
        pe.normal_(0.0, 0.02, generator=torch.Generator(device=pe.device).manual_seed(SEED))
    inp_d = _dino_input(torch, np, serve, "dune", DINO_BATCH, DUNE_IMG, SEED + 2)

    def fwd_d():
        with torch.inference_mode():
            return enc(inp_d)

    out = dino_against_plain(torch, config, counters, fwd_d, tag, {**none, "K1": DUNE_DEPTH}, total, MODEL_REL_TOL)
    require(tuple(out.features.shape) == (DINO_BATCH, 768, 32, 32), f"{tag}: {tuple(out.features.shape)}")
    dino_timing(torch, fwd_d, DINO_BATCH, tag, card)
    del enc, out
    torch.cuda.empty_cache()
    return total


def dino_k5_k6_times(torch, F, fused, fa, make_patch_positions, card):
    """K5 as DINOv2-L's layers run it under "fused" (no RoPE, a qkv bias; (2, 1374), C 1024, 16 heads) beside its
    plain version, cuBLAS + SDPA and the bound; K6 "int8" at DINOv2-L's 224 shape (2, 261, 16, 64), one key block,
    beside its plain version, K1, SDPA and the bound. Each held against its plain version first."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    case = K5Case(torch, fused, make_patch_positions, gen, DINO_BATCH, 1374, None, 1024, 16, (1374, 1), None)
    a = case.args(torch.bfloat16, rope=False)
    ulps, ok = k5_check(case.kernel(*a), case.plain(*a), True)
    require(ok, f"K5 DINOv2-L: {ulps} ulp from its plain version")
    ms, plain_ms = graph_ms(torch, lambda: case.kernel(*a)), graph_ms(torch, lambda: case.plain(*a))
    proj_ms, lib_ms = graph_ms(torch, lambda: case.project(a, False, plain=False)), graph_ms(torch, lambda: case.library(F, a))
    b = k5_bound(DINO_BATCH, 1374, 1374, 1024, 16, False)
    print(f"[32 K5] DINOv2-L self, no RoPE, qkv bias ({DINO_BATCH},1374,C 1024,H 16): {ulps:.2f} ulp of max(|plain|, "
          f"{K5_ULP_FLOOR}) vs plain (tol {K5_ULPS}); kernel {ms:.4f} ms (projection launch {proj_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, cuBLAS + SDPA {lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) (CUDA graphs) on {card}")
    del case, a
    q, k, v = torch.randn(DINO_BATCH, 261, 3, 16, 64, device="cuda", generator=gen, dtype=torch.bfloat16).unbind(2)
    ulps = _ulps(fa.flash_attention_int8(q, k, v), fa.flash_attention_int8_ref(q, k, v), 7, floor=K6_ULP_FLOOR)
    require(ulps <= K6_ULPS, f"K6 DINOv2-L 224: {ulps} ulp from its plain version")
    ms, plain_ms = graph_ms(torch, lambda: fa.flash_attention_int8(q, k, v)), graph_ms(
        torch, lambda: fa.flash_attention_int8_ref(q, k, v))
    k1_ms, lib_ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v)), graph_ms(torch, lambda: sdpa(q, k, v))
    ops = 2 * DINO_BATCH * 16 * 261 * 261 * 64
    b = bound({"int8": ops, "bf16": ops}, 4 * 261 * DINO_BATCH * 16 * 64 * 2)
    print(f"[32 K6] DINOv2-L 224 int8 ({DINO_BATCH},261,16,64), one key block: {ulps:.2f} ulp vs plain (tol {K6_ULPS}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, K1 {k1_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]}) (CUDA graphs) on {card}")


def phase_dino_surgery(torch, np, serve, config, fa, counters, card):
    """DINOv2-L-reg's IFR (pre-norm tokens after block 11) of two 518 views, then a 12-deep, 1024-wide global info
    sharing with LayerScale initialised by convert_dino_to_info_sharing from the encoder's blocks 12-23, loaded
    strict: kernels against the plain path with exact launches (12 K1 at 1374 keys in the encoder, 12 at 2738 in the
    global stream). Then DINOv2-L-reg at 224 under int8 attention: 24 K6 (N = 261, one key block), each against its
    plain version. Returns the launches of the counted forwards."""
    import uniception_tpu_torch.ops.attention as attention
    from uniception_tpu_torch import convert_dino_to_info_sharing as surgery
    from uniception_tpu_torch.models.encoders import encoder_factory, feature_returner_encoder_factory
    from uniception_tpu_torch.models.info_sharing import MultiViewGlobalAttentionTransformer, MultiViewTransformerInput
    from uniception_tpu_torch.utils.weights import load_state_dict_numpy

    total = {k: 0 for k in counters}
    none = {k: 0 for k in counters}
    bf16 = torch.bfloat16
    tag = "33 DINOv2-L surgery"
    ifr = feature_returner_encoder_factory("dinov2", name="dinov2_large", size="large", with_registers=True,
                                           indices=[SURGERY_START - 1], norm_intermediate=False, device="cuda",
                                           seed=SEED, dtype=bf16, param_dtype=bf16).eval()
    t0 = time.perf_counter()
    dino_state = {k: v.float().cpu().numpy() for k, v in ifr.state_dict().items()}
    state = surgery.convert(dino_state, SURGERY_START, DINO_L_DEPTH)
    missing, unexpected = surgery.verify(state, DINO_L_DEPTH - SURGERY_START)
    require(not missing and not unexpected, f"{tag}: the surgery's check: missing {missing}, unexpected {unexpected}")
    info = MultiViewGlobalAttentionTransformer(name="dino_surgery", input_embed_dim=1024, dim=1024,
                                               depth=DINO_L_DEPTH - SURGERY_START, num_heads=16, init_values=1.0,
                                               device="cuda", dtype=bf16).to(bf16).eval()
    load_state_dict_numpy(info, state)  # strict
    print(f"[{tag}] {len(state)} tensors from blocks {SURGERY_START}-{DINO_L_DEPTH - 1} and the final norm, loaded "
          f"strict in {time.perf_counter() - t0:.2f} s (host copy, convert, check, load)")
    del dino_state, state
    inp = _dino_input(torch, np, serve, "dinov2", 2, DINO_IMG, SEED + 3)  # two views of batch 1, as one batch of 2
    keys = {}
    real_k1 = attention.flash_attention

    def k1_counting(q, k, v, scale=None):
        keys[k.shape[1]] = keys.get(k.shape[1], 0) + 1
        return real_k1(q, k, v, scale)

    def fwd():
        with torch.inference_mode():
            feats = ifr(inp)[0].features  # (2, 1024, 37, 37): the views stacked
            return info(MultiViewTransformerInput(features=[feats[:1], feats[1:]]))

    attention.flash_attention = k1_counting
    try:
        out = dino_against_plain(torch, config, counters, fwd, tag, {**none, "K1": 2 * SURGERY_START}, total,
                                 MODEL_REL_TOL)
    finally:
        attention.flash_attention = real_k1
    want_keys = {1374: SURGERY_START, 2738: DINO_L_DEPTH - SURGERY_START}
    print(f"[{tag}] K1 launches by key count {keys} (want {want_keys})")
    require(keys == want_keys, f"{tag}: K1 launches by key count {keys}, want {want_keys}")
    require(all(tuple(f.shape) == (1, 1024, 37, 37) for f in out.features), f"{tag}: {[f.shape for f in out.features]}")
    dino_timing(torch, fwd, 2, tag, card)
    del ifr, info, out
    torch.cuda.empty_cache()

    tag = f"33 DINOv2-L-reg {DINO_INT8_IMG} int8 attention"
    enc = encoder_factory("dinov2", name="dinov2_large", size="large", with_registers=True, device="cuda", seed=SEED,
                          dtype=bf16, param_dtype=bf16).eval()
    inp = _dino_input(torch, np, serve, "dinov2", DINO_BATCH, DINO_INT8_IMG, SEED + 4)
    k6_ulps, k6_ctrl = [], []

    def k6_checked(q, k, v, scale=None, mode="int8"):
        o = fa.flash_attention_int8(q, k, v, scale, mode)
        ref = fa.flash_attention_int8_ref(q, k, v, scale, mode)
        k6_ulps.append(_ulps(o, ref, 7, floor=K6_ULP_FLOOR))
        k6_ctrl.append(_ulps(fa.flash_attention_ref(q, k, v, scale), ref, 7, floor=K6_ULP_FLOOR))
        return o

    def fwd_i8():
        with torch.inference_mode():
            return enc(inp)

    config.set_attention_quant("int8")
    attention.flash_attention_int8 = k6_checked
    try:
        out = counted_forward(torch, counters, fwd_i8, tag, {**none, "K6": DINO_L_DEPTH}, total)
    finally:
        attention.flash_attention_int8 = fa.flash_attention_int8
        config.set_attention_quant("none")
    require(all(torch.isfinite(t).all().item() for t in _dino_tensors(out)), f"{tag}: non-finite output")
    print(f"[{tag}] {len(k6_ulps)} K6 calls at (2, 261, 16, 64), each against its plain version on the same "
          f"activations: max {max(k6_ulps):.2f} ulp (tol {K6_ULPS}); exact attention, the control: "
          f"{sum(c > K6_ULPS for c in k6_ctrl)} calls over the tol, max {max(k6_ctrl):.2f}")
    require(max(k6_ulps) <= K6_ULPS, f"{tag}: a K6 call is {max(k6_ulps)} ulp from its plain version")
    require(max(k6_ctrl) > K6_ULPS, f"{tag}: exact attention passed K6's check")
    config.set_attention_quant("int8")
    try:
        dino_timing(torch, fwd_i8, DINO_BATCH, tag, card)
    finally:
        config.set_attention_quant("none")
    del enc, out
    torch.cuda.empty_cache()
    return total


# K1 at the encoder zoo's head dims and shapes (name, B, N, H, D): RADIO v2.5-H/16 at 512 (cls + 8 registers + 32 x
# 32 patches), PE-Core-G14 at 448 (32 x 32 patches, no cls token), DINOv3-7b/16 at 512 (cls + 4 storage + 32 x 32),
# E-RADIO v2's windows at 512 (the /16 stage's 32 x 32 window, the /32 stage's 16 x 16) and Pixio-H/16 at 256 (8 cls
# + 16 x 16). Held as phase 22 holds K1 (K1_MV_ULPS, bf16 ulps of max(|plain|,
# 1/64)) with two controls that must land at least K1_MV_CONTROL_ULPS away: the plain version without its ragged last
# key tile (the whole last 128-key tile where N is a multiple of 128), and the plain version with the last 16
# head-dim columns of q, k and v zeroed (at D > 64 the columns of the second TMA box). fp32 by ||kernel - plain|| /
# ||plain||; the logsumexp as LSE_TOL.
ZOO_K1_SHAPES = [("RADIO-h 512", 2, 1033, 16, 80), ("PE-G14 448", 2, 1024, 16, 96), ("DINOv3-7b 512", 1, 1029, 32, 128),
                 ("E-RADIO /16 window", 2, 1024, 12, 32), ("E-RADIO /32 window", 2, 256, 24, 32),
                 ("Pixio-H 256", 2, 264, 16, 80)]
ZOO_K1_FP32_REL_TOL = 2e-6
ZOO_K2_SHAPES = [("DINOv3-L 512", 2, 16, 64), ("DINOv3-7b 512", 1, 32, 128)]  # (name, B, H, D) at 32 x 32 patches
ZOO_IMG, ZOO_BATCH = 512, 2
RADIO_H_DEPTH, DINOV3_L_DEPTH = 32, 24
# depth cuts of phase 35 (published widths; every cut listed in PERF.md section 4)
PE_G_BLOCKS, DINOV3_7B_BLOCKS = 8, 4


def zoo_k1_check(torch, fa, q, k, v, lost, label):
    """K1 against its plain version on (q, k, v) (bf16: ulps with the two controls; fp32: norm-relative), with and
    without the logsumexp. Returns (bf16 ulps or fp32 relative error, control ulps or None)."""
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    no_lse = fa.flash_attention_fwd(q, k, v)[0]
    ref, ref_lse = fa.flash_attention_lse_ref(q, k, v)
    require(torch.equal(out, no_lse), f"{label}: the output with the logsumexp differs from the one without")
    lse_err = (lse - ref_lse).abs().max().item()
    bf16 = q.dtype == torch.bfloat16
    require(lse_err <= LSE_TOL["bf16" if bf16 else "fp32"], f"{label}: logsumexp {lse_err}")
    if not bf16:
        rel = ((out - ref).norm() / ref.norm()).item()
        require(rel <= ZOO_K1_FP32_REL_TOL, f"{label}: fp32 {rel} > {ZOO_K1_FP32_REL_TOL}")
        return rel, None, lse_err
    ulps = _ulps(out, ref, 7, floor=K1_MV_ULP_FLOOR)
    ragged = _ulps(fa.flash_attention_ref(q, k[:, :-lost], v[:, :-lost]), ref, 7, floor=K1_MV_ULP_FLOOR)
    zero = lambda t: torch.cat([t[..., :-16], torch.zeros_like(t[..., -16:])], dim=-1)  # noqa: E731
    columns = _ulps(fa.flash_attention_ref(zero(q), zero(k), zero(v)), ref, 7, floor=K1_MV_ULP_FLOOR)
    require(ulps <= K1_MV_ULPS, f"{label}: {ulps} ulps of max(|plain|, 1/64) vs plain > {K1_MV_ULPS}")
    require(min(ragged, columns) >= K1_MV_CONTROL_ULPS, f"{label}: a control is under {K1_MV_CONTROL_ULPS} ulps "
            f"(last {lost} keys dropped {ragged}, last 16 columns zeroed {columns}): the bar cannot see the loss")
    return ulps, (ragged, columns), lse_err


def phase_zoo_k1(torch, fa, rope, make_patch_positions, card):
    """K1 at the zoo's shapes (ZOO_K1_SHAPES), q, k and v strided views of one qkv tensor as the layers make them:
    bf16 and fp32 against the plain version with and without the logsumexp, the controls, and its time beside the
    plain version, SDPA and the bound (CUDA graphs). Then K2 on the DINOv3 trunks' patch tokens (the view q[:, 5:]
    of a qkv projection) against its plain version, timed beside it and its bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    worst = 0.0
    for name, B, N, H, D in ZOO_K1_SHAPES:
        lost = N % 128 or 128
        qkv = torch.randn(B, N, 3, H, D, device="cuda", generator=gen)
        q32, k32, v32 = qkv.unbind(2)
        rel, _, lse32 = zoo_k1_check(torch, fa, q32, k32, v32, lost, f"34 K1 {name} fp32")
        q, k, v = qkv.bfloat16().unbind(2)
        del qkv, q32, k32, v32
        ulps, (ragged, columns), lse16 = zoo_k1_check(torch, fa, q, k, v, lost, f"34 K1 {name} bf16")
        worst = max(worst, (fa.flash_attention(q, k, v).float() - fa.flash_attention_ref(q, k, v).float()).abs().max()
                    .item())
        ms, plain_ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v)), graph_ms(
            torch, lambda: fa.flash_attention_ref(q, k, v))
        lib = graph_ms(torch, lambda: sdpa(q, k, v))
        b = attention_bound(B, N, N, H, D)
        tflops = 4 * B * H * N * N * D / 1e9
        dp = next(p for p in (64, 128, 192, 256, 512) if D <= p)  # K1's padded head dim (csrc/flash_attention.cu)
        print(f"[34 K1] {name} ({B},{N},{H},{D}) padded to {dp}: bf16 {ulps:.2f} ulps of max(|plain|, 1/64) vs plain "
              f"(tol {K1_MV_ULPS}), controls: last {lost} keys dropped {ragged:.1f} ulps, last 16 columns of q/k/v "
              f"zeroed {columns:.1f} ulps (each >= {K1_MV_CONTROL_ULPS}); fp32 ||kernel - plain|| / ||plain|| "
              f"{rel:.2e} (tol {ZOO_K1_FP32_REL_TOL}); logsumexp max abs bf16 {lse16:.2e}, fp32 {lse32:.2e}; "
              f"{ms:.4f} ms ({tflops / ms:.1f} TFLOP/s of the {D} real columns), plain {plain_ms:.4f} ms, SDPA "
              f"{lib:.4f} ms ({tflops / lib:.1f} TFLOP/s), {ms / lib:.3f}x SDPA, bound {b[0]:.4f} ms ({b[1]}), share "
              f"of the bound {b[0] / ms:.3f} (CUDA graphs) on {card}")
        del q, k, v
        torch.cuda.empty_cache()
    for name, B, H, D in ZOO_K2_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, 5 + 1024, 3, H, D, device="cuda", generator=gen).to(dtype)[:, 5:, 0]
            pos = make_patch_positions(B, 32, 32, device="cuda")
            out, ref = rope.rope_2d_kernel(q, pos), rope.rope_2d(q.contiguous(), pos)
            if dtype == torch.float32:
                err = (out - ref).abs().max().item()
                require(err <= K2_FP32_TOL, f"34 K2 {name}: fp32 {err}")
                continue
            ulps = _ulps(out, ref, 7)
            require(ulps <= K2_BF16_ULPS, f"34 K2 {name}: {ulps} bf16 ulps")
            ms, plain_ms = graph_ms(torch, lambda: rope.rope_2d_kernel(q, pos)), graph_ms(
                torch, lambda: rope.rope_2d(q, pos))
            b = bound({}, 2 * B * 1024 * H * D * 2 + B * 1024 * 2 * 4)
            print(f"[34 K2] {name} patch tokens q[:, 5:] of a (B, 1029, 3, {H}, {D}) projection (strided): fp32 max "
                  f"abs {err:.2e} (tol {K2_FP32_TOL}), bf16 {ulps:.2f} ulps (tol {K2_BF16_ULPS}); {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) (CUDA graphs) on {card}")
    return worst


def _zoo_input(torch, np, serve, norm, n, hw, seed):
    "A (n, 3, H, W) batch of seeded uint8 frames normalized for ``norm`` on the card, as the encoder's input."
    from uniception_tpu_torch.models.encoders import ViTEncoderInput

    frames = np.random.RandomState(seed).randint(0, 256, size=(n, hw[0], hw[1], 3), dtype=np.uint8)
    return ViTEncoderInput(image=serve.make_frame_normalizer(norm, "cuda")(frames), data_norm_type=norm)


def phase_zoo(torch, np, serve, config, counters, card):
    """The zoo's encoders through encoder_factory (seed 0) against the plain path with exact launches per forward:
    RADIO v2.5-H/16 at 512, batch 2, all 32 blocks, fp32 then bf16 trunk (32 K1 at (2, 1033, 16, 80)); DINOv3
    ViT-L/16 at 512, all 24 blocks, fp32 then bf16 (24 K1, 48 K2 on the patch tokens); in bf16 at published widths,
    depth cut: PE-Core-G14 at 448 (PE_G_BLOCKS blocks, heads of 96), DINOv3-7b/16 at 512 (DINOV3_7B_BLOCKS blocks,
    batch 1, heads of 128); Pixio-H/16 at 256, all 32 blocks (heads of 80); E-RADIO v2 at 512, whole (windows of
    1024 and 256 tokens, heads of 32: 10 K1); DINOv3 ConvNeXt-base at 512 and the global representation encoder
    (no kernel); the dense representation encoder on a (B, 3, 518, 518) non-image input in bf16 under the 3x3-conv
    kernel (3 K7). For the bf16
    ones images/s, device ms, busy share and peak memory. Returns the launches of the counted forwards."""
    from uniception_tpu_torch.models.encoders import EncoderGlobalRepInput, ViTEncoderNonImageInput, encoder_factory

    total = {k: 0 for k in counters}
    none = {k: 0 for k in counters}

    def run(tag, build, inp, want, tol, timed, batch):
        enc = build().eval()

        def fwd():
            with torch.inference_mode():
                return enc(inp)

        out = dino_against_plain(torch, config, counters, fwd, tag, {**none, **want}, total, tol)
        if timed:
            dino_timing(torch, fwd, batch, tag, card)
        del enc
        gc.collect()
        torch.cuda.empty_cache()
        return out

    grid = ZOO_IMG // 16
    radio_in = _zoo_input(torch, np, serve, "radio", ZOO_BATCH, (ZOO_IMG, ZOO_IMG), SEED)
    dinov3_in = _zoo_input(torch, np, serve, "dinov3", ZOO_BATCH, (ZOO_IMG, ZOO_IMG), SEED + 1)
    for trunk, dtype, tol in (("fp32", torch.float32, MODEL_FP32_REL_TOL), ("bf16", torch.bfloat16, MODEL_REL_TOL)):
        kw = dict(device="cuda", seed=SEED, dtype=dtype, param_dtype=dtype)
        out = run(f"35 RADIO v2.5-H/16 {ZOO_IMG} {trunk}", lambda: encoder_factory(
            "radio", name="radio_v2.5-h", model_version="radio_v2.5-h", **kw), radio_in, {"K1": RADIO_H_DEPTH}, tol,
            dtype == torch.bfloat16, ZOO_BATCH)
        require(tuple(out.features.shape) == (ZOO_BATCH, 1280, grid, grid), f"RADIO-h: {tuple(out.features.shape)}")
        out = run(f"35 DINOv3 ViT-L/16 {ZOO_IMG} {trunk}", lambda: encoder_factory(
            "dinov3", name="dinov3_large", size="large", **kw), dinov3_in,
            {"K1": DINOV3_L_DEPTH, "K2": 2 * DINOV3_L_DEPTH}, tol, dtype == torch.bfloat16, ZOO_BATCH)
        require(tuple(out.features.shape) == (ZOO_BATCH, 1024, grid, grid), f"DINOv3-L: {tuple(out.features.shape)}")
        del out

    bf16 = dict(device="cuda", seed=SEED, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    out = run(f"35 PE-Core-G14 448 bf16 ({PE_G_BLOCKS} of 50 blocks)", lambda: encoder_factory(
        "perception_encoder", name="pe_core_giant", size="giant", checkpoint_type="core",
        keep_first_n_layers=PE_G_BLOCKS - 1, **bf16),
        _zoo_input(torch, np, serve, "perception_encoder", ZOO_BATCH, (448, 448), SEED + 2), {"K1": PE_G_BLOCKS},
        MODEL_REL_TOL, True, ZOO_BATCH)
    require(tuple(out.features.shape) == (ZOO_BATCH, 1536, 32, 32), f"PE-G14: {tuple(out.features.shape)}")
    out = run(f"35 DINOv3-7b/16 {ZOO_IMG} bf16 ({DINOV3_7B_BLOCKS} of 40 blocks)", lambda: encoder_factory(
        "dinov3", name="dinov3_7b", size="7b", keep_first_n_layers=DINOV3_7B_BLOCKS, **bf16),
        _zoo_input(torch, np, serve, "dinov3", 1, (ZOO_IMG, ZOO_IMG), SEED + 3),
        {"K1": DINOV3_7B_BLOCKS, "K2": 2 * DINOV3_7B_BLOCKS}, MODEL_REL_TOL, True, 1)
    require(tuple(out.features.shape) == (1, 4096, grid, grid), f"DINOv3-7b: {tuple(out.features.shape)}")
    out = run("35 Pixio-H/16 256 bf16", lambda: encoder_factory("pixio", name="pixio_vith16", **bf16),
              _zoo_input(torch, np, serve, "pixio", ZOO_BATCH, (256, 256), SEED + 4), {"K1": 32}, MODEL_REL_TOL, True,
              ZOO_BATCH)
    require(tuple(out.features.shape) == (ZOO_BATCH, 1280, 16, 16), f"Pixio-H: {tuple(out.features.shape)}")
    out = run(f"35 E-RADIO v2 {ZOO_IMG} bf16", lambda: encoder_factory(
        "radio", name="e-radio_v2", model_version="e-radio_v2", eradio_input_shape=(ZOO_IMG, ZOO_IMG), **bf16),
        radio_in, {"K1": 10}, MODEL_REL_TOL, True, ZOO_BATCH)
    require(tuple(out.features.shape) == (ZOO_BATCH, 1536, grid, grid), f"E-RADIO: {tuple(out.features.shape)}")
    out = run(f"35 DINOv3 ConvNeXt-base {ZOO_IMG} bf16", lambda: encoder_factory(
        "dinov3_convnext", name="dinov3_convnext_base", size="base", **bf16), dinov3_in, {}, MODEL_REL_TOL, True,
        ZOO_BATCH)
    require(tuple(out.features.shape) == (ZOO_BATCH, 1024, ZOO_IMG // 32, ZOO_IMG // 32), "ConvNeXt-base")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dense_in = ViTEncoderNonImageInput(data=torch.randn(ZOO_BATCH, 3, 518, 518, device="cuda", generator=gen))
    config.set_conv3x3_impl("kernel")  # the JAX conv gate: bf16 modules, 3x3 convs of C, Co multiples of 128
    try:
        out = run("35 dense representation encoder 518 bf16 (3x3 convs on K7)", lambda: encoder_factory(
            "dense_rep_encoder", name="dense_rep_encoder", **bf16), dense_in, {"K7": 3}, MODEL_REL_TOL, True,
            ZOO_BATCH)
    finally:
        config.set_conv3x3_impl("torch")
    require(tuple(out.features.shape) == (ZOO_BATCH, 1024, 37, 37), f"dense: {tuple(out.features.shape)}")
    data = EncoderGlobalRepInput(data=torch.randn(ZOO_BATCH, 3, device="cuda", generator=gen))
    glob = encoder_factory("global_rep_encoder", name="global_rep_encoder", device="cuda", seed=SEED).eval()
    with torch.inference_mode():
        feats = glob(data).features
    require(tuple(feats.shape) == (ZOO_BATCH, 1024) and torch.isfinite(feats).all().item(), "global rep encoder")
    print(f"[35 global representation encoder] (B, 3) -> {tuple(feats.shape)} fp32, finite, no kernel")
    del out, glob
    torch.cuda.empty_cache()
    return total



# Phases 36-37: the prediction-head and adaptor layer over DINOv2-L/14-reg at 518 (36) and the differential info
# sharing in the DUSt3R-DPT composition at 512 (37), seeded weights, synthetic uint8 images, bf16 trunks and heads.
HEAD_LEVELS = [5, 11, 17, 23]  # DINOv2-L's four DPT levels
# DPT-Large (Ranftl et al. 2021, intel-isl/DPT dpt_large): layer dims and fusion width over 1024-wide levels
DPT_LARGE = dict(patch_size=14, hooks=[0, 1, 2, 3], input_feature_dims=1024, layer_dims=[256, 512, 1024, 1024],
                 feature_dim=256)
# K7 per DPT-Large pass on the 37 x 37 grid: 4 layer*_rn (C 256-1024, all multiples of 128), 2 in refinenet4, 4 in each
# of refinenets 3-1; the processors' 3x3 convs run on 296^2 and 518^2 maps, above the kernel's 256^2
DPT_LARGE_K7 = 4 + 2 + 3 * 4
K7_DPT_LARGE_518 = [("layer1_rn", 148, 256), ("layer2_rn", 74, 512), ("layer3_rn", 37, 1024), ("layer4_rn", 19, 1024),
                    ("refinenet4 RCU", 19, 256), ("refinenet3 RCU", 37, 256), ("refinenet2 RCU", 74, 256),
                    ("refinenet1 RCU", 148, 256)]  # (name, H = W, C), Co 256, batch 2
# The adaptors on the card against the same adaptors on the CPU from the same decoded channels, fp32, per component
# |card - cpu| / max(1, |cpu|): elementwise, so this guards the device's exp / sigmoid / norms, not a kernel.
ADAPTOR_REL_TOL = 1e-5
DIFF_DEC_HEADS = DEC_HEADS // 2  # the differential blocks run num_heads // 2 heads (each two sub-heads)
# K2 on the differential path: (B, N, H, D) of its calls (the blocks' self-attention: 6 heads of 128; the differential
# cross-attention: 12 sub-heads of 64), and the same width at 24 sub-heads of 32, timed beside them
K2_DIFF_SHAPES = [(BATCH, 1024, DIFF_DEC_HEADS, 2 * DEC_DIM // DEC_HEADS),
                  (BATCH, 1024, DEC_HEADS, DEC_DIM // DEC_HEADS), (BATCH, 1024, 2 * DEC_HEADS, DEC_DIM // DEC_HEADS // 2)]


def _head_adaptors(tad, tbase):
    "Each head's AdaptorMap, by head name (the adaptors of phase 36)."
    inf = float("inf")
    rays = dict(ray_directions_mode="linear", ray_directions_normalize_to_unit_sphere=True,
                ray_directions_normalize_to_unit_image_plane=False, ray_directions_vmin=-inf, ray_directions_vmax=inf,
                ray_directions_clamp_min_of_z_dir=False, ray_directions_z_dir_min=1, depth_mode="exp", depth_vmin=0,
                depth_vmax=inf, confidence_type="exp", confidence_vmin=1, confidence_vmax=inf)
    pose = dict(cam_trans_mode="linear", cam_trans_vmin=-inf, cam_trans_vmax=inf, quaternions_mode="linear",
                quaternions_normalize=True, quaternions_vmin=-inf, quaternions_vmax=inf)
    return {
        "dpt": tbase.AdaptorMap(tad.RayDirectionsPlusDepthWithConfidenceAndMaskAdaptor("rays", **rays)),
        "segmentation": tbase.AdaptorMap(tad.MaskAdaptor("mask")),
        "moge": tbase.AdaptorMap(tad.PointMapWithMaskAdaptor("pointmap", "z_exp", -inf, inf)),
        "pose": tbase.AdaptorMap(tad.CamTranslationPlusQuatsAdaptor("pose", **pose)),
        "global": tbase.AdaptorMap(tad.ScaleAdaptor("scale", "exp")),
        "mlp": tbase.AdaptorMap(tad.DepthAdaptor("depth", "exp"), tad.ConfidenceAdaptor("conf", "sigmoid", 0, 1)),
    }


def adaptors_card_vs_cpu(torch, maps, decoded, label):
    """Each head's AdaptorMap on the card and on the CPU over the same fp32 decoded channels; every output field within
    ADAPTOR_REL_TOL. Returns the worst error."""
    import dataclasses

    from uniception_tpu_torch.models.prediction_heads.base import AdaptorInput

    worst = 0.0
    for head, amap in maps.items():
        x = decoded[head].float()
        card, cpu = amap(AdaptorInput(x, x.shape[2:])), amap(AdaptorInput(x.cpu(), x.shape[2:]))
        for name in card:
            for field in dataclasses.fields(card[name]):
                a, b = getattr(card[name], field.name), getattr(cpu[name], field.name)
                require(a.shape == b.shape and torch.isfinite(a).all().item(), f"{label}: {head}.{name}.{field.name}")
                err = ((a.cpu() - b).abs() / b.abs().clamp_min(1.0)).max().item()
                worst = max(worst, err)
                require(err <= ADAPTOR_REL_TOL, f"{label}: {head}.{name}.{field.name} card vs CPU {err}")
    print(f"[{label}] adaptors on the card vs the CPU from the same fp32 decoded channels ({', '.join(maps)}): "
          f"max |card - cpu| / max(1, |cpu|) {worst:.2e} (tol {ADAPTOR_REL_TOL})")
    return worst


def phase_heads(torch, F, np, serve, config, c3, counters, card):
    """DINOv2-L/14-reg at 518, batch 2, bf16, its four levels (HEAD_LEVELS) into every head at its published widths:
    in bf16 under the conv kernel, DPTFeature at DPT-Large (K7 18 per pass) with the regression processor (6
    channels) and the segmentation processor; in fp32 on TF32 (the JAX heads' default dtype and JAX's default GPU
    precision, over the levels cast to fp32), MoGeConvFeature at MoGe-v1's defaults, PoseHead, GlobalHead and
    MLPFeature on the last level. The kernel path against the plain path (attention "naive": K1 and K7 on their plain
    versions) with exact launches (K1 24, K7 18 per forward); each head's decoded channels within K7_HEADS_REL_TOL
    where K7 runs and MODEL_REL_TOL elsewhere; each head's adaptors on the card against the CPU; images/s, device ms
    and peak memory; K7 at the eight DPT-Large shapes beside cuDNN and the bound. Returns (launches, K7 timing at
    refinenet1's RCU)."""
    from uniception_tpu_torch.models.encoders import feature_returner_encoder_factory
    from uniception_tpu_torch.models.prediction_heads import adaptors as tad
    from uniception_tpu_torch.models.prediction_heads import base as tbase
    from uniception_tpu_torch.models.prediction_heads import dpt
    from uniception_tpu_torch.models.prediction_heads.mlp_feature import MLPFeature
    from uniception_tpu_torch.models.prediction_heads.moge_conv import MoGeConvFeature
    from uniception_tpu_torch.models.prediction_heads.pose_head import GlobalHead, PoseHead

    total = {k: 0 for k in counters}
    bf16 = torch.bfloat16
    tag = "36 heads over DINOv2-L-reg 518"
    ifr = feature_returner_encoder_factory("dinov2", name="dinov2_large", size="large", with_registers=True,
                                           indices=HEAD_LEVELS, device="cuda", seed=SEED, dtype=bf16,
                                           param_dtype=bf16).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 36)
    kw, fp32 = dict(dtype=bf16, device="cuda", generator=gen), dict(device="cuda", generator=gen)
    heads = dict(
        dpt=dpt.DPTFeature(**DPT_LARGE, **kw), regressor=dpt.DPTRegressionProcessor(256, 6, **kw),
        segmentation=dpt.DPTSegmentationProcessor(256, 1, **kw),
        moge=MoGeConvFeature(patch_size=14, num_features=4, input_feature_dims=1024, dim_out=[3, 1], **fp32),
        pose=PoseHead(14, 1024, **fp32), glob=GlobalHead(14, 1024, **fp32), mlp=MLPFeature(1024, 14, 2, **fp32))
    for h in heads.values():
        h.eval()
    inp = _dino_input(torch, np, serve, "dinov2", DINO_BATCH, DINO_IMG, SEED + 36)

    def fwd():
        with torch.inference_mode():
            levels = [o.features for o in ifr(inp)]
            size = (DINO_IMG, DINO_IMG)
            feat = heads["dpt"](tbase.PredictionHeadLayeredInput(list_features=levels, target_output_shape=size))
            levels = [f.float() for f in levels]  # the fp32 heads' input, as DUSt3R casts to its head dtype
            layered = tbase.PredictionHeadLayeredInput(list_features=levels, target_output_shape=size)
            last = tbase.PredictionHeadInput(last_feature=levels[-1])
            return {"dpt": heads["regressor"](feat).decoded_channels,
                    "segmentation": heads["segmentation"](feat).decoded_channels,
                    "moge": heads["moge"](layered).decoded_channels, "pose": heads["pose"](last).decoded_channels,
                    "global": heads["glob"](last).decoded_channels, "mlp": heads["mlp"](last).decoded_channels}

    # the fp32 heads' convs and matmuls on TF32, as JAX runs fp32 on a GPU by default, on both paths (the bf16 trunk
    # and DPT heads are untouched); with TF32 off cuDNN takes FFT convs for MoGe's 518^2 maps, about 0.9 s a forward
    config.set_conv3x3_impl("kernel")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        config.set_attention_impl("naive")
        try:
            plain = fwd()
            torch.cuda.synchronize()
        finally:
            config.set_attention_impl("kernel")
        out = counted_forward(torch, counters, fwd, tag, {**{k: 0 for k in counters}, "K1": DINO_L_DEPTH,
                                                          "K7": DPT_LARGE_K7}, total)
        shapes = {"dpt": (6, DINO_IMG, DINO_IMG), "segmentation": (1, DINO_IMG, DINO_IMG),
                  "moge": (4, DINO_IMG, DINO_IMG), "pose": (7,), "global": (1,), "mlp": (2, DINO_IMG, DINO_IMG)}
        for name, a in out.items():
            b, tol = plain[name], K7_HEADS_REL_TOL if name in ("dpt", "segmentation") else MODEL_REL_TOL
            require(tuple(a.shape) == (DINO_BATCH, *shapes[name]) and torch.isfinite(a).all().item(),
                    f"{tag}: {name} {tuple(a.shape)} non-finite or not {shapes[name]}")
            rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
            print(f"[{tag}] {name:12s} decoded channels {tuple(a.shape)}, max |x| {a.float().abs().max().item():.3e}: "
                  f"kernels vs plain path ||kernel - plain|| / ||plain|| {rel:.3e} (tol {tol})")
            require(rel <= tol, f"{tag}: {name} kernels vs plain {rel} > {tol}")
        adaptors_card_vs_cpu(torch, _head_adaptors(tad, tbase), out, tag)
        forward_timing(torch, fwd, DINO_BATCH, "images", f"{DINO_BATCH} images per forward, six heads", tag, card)
    finally:
        config.set_conv3x3_impl("torch")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    del ifr, heads, out, plain
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 37)
    main = None
    for name, hw, C in K7_DPT_LARGE_518:
        x = torch.randn(BATCH, hw, hw, C, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(3, 3, C, 256, device="cuda", generator=gen) * (9 * C) ** -0.5).bfloat16()
        b = torch.randn(256, device="cuda", generator=gen) * 0.1
        out, ref = c3.conv3x3_nhwc(x, w, b), c3.conv3x3_reference(x, w, b)
        ulps = _ulps(out, ref, 7, floor=1 / 16)
        require(ulps <= K7_ULPS and torch.equal(c3.conv3x3_nhwc(x, w, b), out), f"36 K7 {name}: {ulps} ulp")
        ms, plain_ms = graph_ms(torch, lambda: c3.conv3x3_nhwc(x, w, b)), graph_ms(
            torch, lambda: c3.conv3x3_reference(x, w, b))
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        stock_ms = graph_ms(torch, lambda: F.conv2d(xc, wc, b.bfloat16(), padding=1))
        flops = 2 * BATCH * hw * hw * C * 256 * 9
        k7_bound = bound({"bf16": flops}, (x.numel() + w.numel() + BATCH * hw * hw * 256) * 2 + 256 * 4)
        print(f"[36 K7] DPT-Large {name:15s} {BATCH}x{hw}x{hw}x{C} -> 256: {ulps:.2f} ulp (tol {K7_ULPS}); {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), cuDNN bf16 {stock_ms:.4f} ms ({ms / stock_ms:.3f}x), bound "
              f"{k7_bound[0]:.4f} ms ({k7_bound[1]}), plain (fp32 conv) {plain_ms:.4f} ms (CUDA graphs) on {card}")
        if name == "refinenet1 RCU":
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=stock_ms, bound=k7_bound)
    return total, main


def phase_diff(torch, np, serve, config, rope_mod, counters, card, DUSt3R):
    """DUSt3R ViT-L 512 with bf16 DPT heads on K7 (phase 17's composition), its info sharing swapped for the 12-deep,
    768-wide DifferentialMultiViewCrossAttentionTransformerIFR (12 heads: each block 6 differential heads) with RoPE100
    and the DPT hooks [encoder, 5, 8, final], batch 2 pairs: forward_pair with exact launches (K1 24 + 24 at D = 128,
    K2 48 + 96, K7 34 per forward), every K2 call held against its plain version in bf16 ulps; against the plain path
    (bucket_check): the info sharing's features within MODEL_REL_TOL, K7 alone and the outputs within their bars;
    pairs/s, device ms and peak memory; K2 at the differential shapes timed beside its plain version and the bound.
    Returns (launches, K2 timing at the cross-attention's shape)."""
    from uniception_tpu_torch.models.info_sharing.diff_cross_attention_transformer import (
        DifferentialMultiViewCrossAttentionTransformerIFR,
    )
    from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions

    total = {k: 0 for k in counters}
    bf16 = torch.bfloat16
    tag = "37 differential info sharing, DUSt3R-DPT 512"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 38)
    model = DUSt3R(name="dust3r_diff_dpt", img_size=(IMG, IMG), pred_head_type="dpt", head_dtype=bf16, dtype=bf16,
                   device="cuda", generator=gen)
    model.info_sharing = DifferentialMultiViewCrossAttentionTransformerIFR(
        name="base_info_sharing", input_embed_dim=ENC_DIM, num_views=2, depth=DEC_DEPTH, dim=DEC_DIM,
        num_heads=DEC_HEADS, custom_positional_encoding=model.rope, indices=[5, 8], norm_intermediate=False,
        device="cuda", dtype=bf16, generator=gen)
    model.eval()
    blk = model.info_sharing.multi_view_branches[0][0]
    require((blk.attn.num_heads, blk.attn.head_dim, blk.cross_attn.num_heads, blk.cross_attn.head_dim)
            == (DIFF_DEC_HEADS, 128, DIFF_DEC_HEADS, 64), f"{tag}: the blocks' heads")
    frames = np.random.RandomState(SEED + 37).randint(0, 256, size=(2 * BATCH, IMG, IMG, 3), dtype=np.uint8)
    fn = serve.make_serving_fn(model, "cuda")
    k2_ulps = {}
    rope_call = rope_mod.Rope2D.__call__

    def k2_checked(pe, tokens, positions):  # every RoPE of the path (encoder and info sharing) and its plain version
        o = rope_call(pe, tokens, positions)
        shape = tuple(tokens.shape[2:])
        k2_ulps[shape] = max(k2_ulps.get(shape, 0.0), _ulps(o, rope_mod.rope_2d(tokens, positions, pe.base, pe.F0), 7))
        return o

    def fwd():
        return fn(frames[0::2], frames[1::2])

    config.set_conv3x3_impl("kernel")
    try:
        want = {**{k: 0 for k in counters}, "K1": ENC_DEPTH + 2 * DEC_DEPTH,
                "K2": 2 * ENC_DEPTH + 2 * DEC_DEPTH * 4, "K7": k7_convs_per_forward(IMG)}
        rope_mod.Rope2D.__call__ = k2_checked
        try:
            out = counted_forward(torch, counters, fwd, tag, want, total)
        finally:
            rope_mod.Rope2D.__call__ = rope_call
        require(all(tuple(a.shape[:3]) == (BATCH, IMG, IMG) and torch.isfinite(a).all().item() for a in out),
                f"{tag}: {[tuple(a.shape) for a in out]}")
        # the differential info sharing's features within MODEL_REL_TOL of the plain path's; K7 alone and the outputs
        # through the bf16 DPT heads and the exp adaptor within the bars phases 14 and 20 set for them
        bucket_check(torch, config, model, fn, (frames[0::2], frames[1::2]), tag,
                     ("pts3d", "conf1", "pts3d_in_other_view", "conf2"))
        print(f"[{tag}] every K2 call against its plain version on the same activations, max bf16 ulps by (H, D): "
              f"{ {k: round(v, 2) for k, v in k2_ulps.items()} } (tol {K2_BF16_ULPS})")
        require(set(k2_ulps) == {(ENC_HEADS, 64), (DIFF_DEC_HEADS, 128), (DEC_HEADS, 64)} and
                max(k2_ulps.values()) <= K2_BF16_ULPS, f"{tag}: K2 calls {k2_ulps}")
        forward_timing(torch, fwd, BATCH, "pairs", f"{BATCH} pairs per forward", tag, card)
    finally:
        config.set_conv3x3_impl("torch")
    del model, out
    torch.cuda.empty_cache()

    main = None
    for B, N, H, D in K2_DIFF_SHAPES:
        q = torch.randn(B, N, 3, H // 2, 2 * D, device="cuda", generator=gen).bfloat16()[:, :, 0].reshape(B, N, H, D)
        pos = make_patch_positions(B, 32, N // 32, device="cuda")
        ulps = _ulps(rope_mod.rope_2d_kernel(q, pos), rope_mod.rope_2d(q.contiguous(), pos), 7)
        require(ulps <= K2_BF16_ULPS, f"37 K2 ({B},{N},{H},{D}): {ulps} bf16 ulps")
        ms, plain_ms = graph_ms(torch, lambda: rope_mod.rope_2d_kernel(q, pos)), graph_ms(
            torch, lambda: rope_mod.rope_2d(q, pos))
        b = bound({}, 2 * B * N * H * D * 2 + B * N * 2 * 4)
        print(f"[37 K2] ({B},{N},{H},{D}) sub-heads of a strided projection: {ulps:.2f} ulps (tol {K2_BF16_ULPS}); "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), library none (CUDA graphs) on "
              f"{card}")
        if H == DEC_HEADS:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound=b)
    return total, main


# --- the Cosmos image tokenizer (phases 38-40) ----------------------------------------------------------------------

COSMOS_D = 512  # the mid blocks' single attention head: D = C = 512
# K1 at D = 512: (name, B, N) at the tokenizers' shapes (CI8x8 at 512: a 64^2 grid; CI8x8 at 1024: 128^2; CI16x16 at
# 512: 32^2) and a ragged N. bf16 in ulps of max(|plain|, 1/64) (K1_MV_ULPS), the plain version without the last key
# tile (64 keys, or the ragged 4) as the control (K1_MV_CONTROL_ULPS); fp32 max abs (K1_FP32_TOL).
COSMOS_K1_SHAPES = [("CI8x8 512", 2, 4096), ("CI8x8 1024", 1, 16384), ("CI16x16 512", 2, 1024), ("ragged", 2, 4100)]
# ||kernel path - plain path|| / ||plain path|| of the latents (and DI's codes): bf16 (K7 and K1 against their plain
# versions, rounded to bf16 at other places through the encoder's 16 K7 convs) and fp32 (cuDNN without TF32 on both
# paths, K1 fp32). The fp32 bar holds the reconstructions too.
COSMOS_REL_TOL = {"bf16": 2e-2, "fp32": 1e-4}
# bf16 reconstructions. Behind 39-42 convs two bf16 paths that differ only in summation order land apart by about
# the bf16 rung's own distance from the fp32 path: measured on an H100 80GB HBM3 (700 W), CI8x8 at 512, the plain
# path 2.040e-2 from the fp32 plain path, the kernel path 2.046e-2, the two 2.177e-2 apart (CI16x16: 2.579e-2,
# 2.603e-2, 2.613e-2), with every K7 call within 1 ulp and every K1 call within 3 ulps of its plain version on the
# same activations. So a reconstruction is held as the heads behind K7 are (phase 36's K7_HEADS_REL_TOL) and, what
# matters, no farther from the fp32 path than the plain bf16 path is, within COSMOS_RUNG_SLACK.
COSMOS_REC_REL_TOL = K7_HEADS_REL_TOL
COSMOS_RUNG_SLACK = 1.1
# (tokenizer, spatial compression, image side, batch, dtype) of phase 39
COSMOS_RUNS = [("CI", 8, 512, 2, "bf16"), ("CI", 8, 512, 2, "fp32"), ("CI", 16, 512, 2, "bf16"),
               ("CI", 16, 512, 2, "fp32"), ("CI", 8, 1024, 1, "bf16"), ("DI", 16, 512, 2, "bf16")]
# K7 launches of one bf16 encoder and decoder by (tokenizer, compression): 16 and 23 at CI8x8, one more Upsample conv
# at 16x16; DI's 256-channel latent (CI's has 16) also puts the encoder's conv_out (512 -> 256) and the decoder's
# conv_in (256 -> 512) on K7
COSMOS_K7 = {("CI", 8): (16, 23), ("CI", 16): (16, 24), ("DI", 16): (17, 25)}
# (name, B, H = W, C, Co) of the tokenizers' K7 convs: CI8x8's at 512 (encoder 128^2 and 64^2 levels, decoder
# 128^2), and the 256^2 level at 1024
COSMOS_K7_SHAPES = [("enc 128^2 128->256", 2, 128, 128, 256), ("enc 128^2 256->256", 2, 128, 256, 256),
                    ("enc 64^2 256->512", 2, 64, 256, 512), ("enc 64^2 512->512", 2, 64, 512, 512),
                    ("dec 128^2 512->512", 2, 128, 512, 512), ("dec 128^2 512->256", 2, 128, 512, 256),
                    ("enc 256^2 128->256 (1024)", 1, 256, 128, 256)]


def sdpa_backends(torch, q, k, v):
    """SDPA's backends that take (q, k, v), each alone under ``sdpa_kernel`` and timed by CUDA graphs: {name: ms}.
    The default call runs one of them, the one whose time it matches."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                sdpa(q, k, v)
                torch.cuda.synchronize()
                times[backend.name.lower()] = graph_ms(torch, lambda: sdpa(q, k, v), iters=5)
        except RuntimeError:  # this backend does not take the inputs (flash: D <= 256)
            pass
    return times


def phase_cosmos_k1(torch, fa, card):
    """K1 at D = 512 (the tokenizer's mid-block attention, one head) at COSMOS_K1_SHAPES, q, k and v strided views of
    one (B, N, 3, 1, 512) tensor: bf16 in ulps with the dropped-tile control, fp32 max abs, each with and without the
    logsumexp; timed by CUDA-graph replay beside the plain version, SDPA (each of its backends that takes the inputs
    timed alone, so the default call's is named) and the bound. Returns (worst bf16 max abs, the timing at (2, 4096, 1, 512))."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 38)
    worst, main = 0.0, None
    for name, B, N in COSMOS_K1_SHAPES:
        lost = N % fa.WIDE_ROWS or fa.WIDE_ROWS  # the last key tile of K1 at D = 512
        qkv = torch.randn(B, N, 3, 1, COSMOS_D, device="cuda", generator=gen)
        q32, k32, v32 = qkv.unbind(2)
        out32, lse32 = fa.flash_attention_fwd(q32, k32, v32, with_lse=True)
        ref32, ref_lse32 = fa.flash_attention_lse_ref(q32, k32, v32)
        err32 = (out32 - ref32).abs().max().item()
        lse_err32 = (lse32 - ref_lse32).abs().max().item()
        require(torch.equal(out32, fa.flash_attention_fwd(q32, k32, v32)[0]), f"38 K1 {name} fp32: the LSE changed o")
        del out32, ref32, ref_lse32, lse32
        f32_ms = graph_ms(torch, lambda: fa.flash_attention(q32, k32, v32), iters=5)
        f32_plain_ms = graph_ms(torch, lambda: fa.flash_attention_ref(q32, k32, v32), iters=3)
        f32_lib_ms = graph_ms(torch, lambda: sdpa(q32, k32, v32), iters=5)
        q, k, v = qkv.bfloat16().unbind(2)
        del qkv, q32, k32, v32
        out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        ref, ref_lse = fa.flash_attention_lse_ref(q, k, v)
        require(torch.isfinite(out).all().item() and torch.equal(out, fa.flash_attention_fwd(q, k, v)[0]),
                f"38 K1 {name}: non-finite, or the LSE changed o")
        ulps = _ulps(out, ref, 7, floor=K1_MV_ULP_FLOOR)
        control = _ulps(fa.flash_attention_ref(q, k[:, :-lost], v[:, :-lost]), ref, 7, floor=K1_MV_ULP_FLOOR)
        err16 = (out.float() - ref.float()).abs().max().item()
        lse_err16 = (lse - ref_lse).abs().max().item()
        del out, ref, lse, ref_lse
        worst = max(worst, err16)
        require(ulps <= K1_MV_ULPS, f"38 K1 {name}: {ulps} ulps of max(|plain|, 1/64) > {K1_MV_ULPS}")
        require(control >= K1_MV_CONTROL_ULPS, f"38 K1 {name}: the control (last {lost} keys dropped) is {control} "
                f"ulps away, under {K1_MV_CONTROL_ULPS}: the bar cannot see a lost key tile")
        require(err32 <= K1_FP32_TOL, f"38 K1 {name}: fp32 max abs {err32} > {K1_FP32_TOL}")
        require(lse_err16 <= LSE_TOL["bf16"] and lse_err32 <= LSE_TOL["fp32"], f"38 K1 {name}: logsumexp "
                f"{lse_err16} / {lse_err32}")
        ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v))
        plain_ms = graph_ms(torch, lambda: fa.flash_attention_ref(q, k, v), iters=5)
        lib_ms = graph_ms(torch, lambda: sdpa(q, k, v))
        alone = sdpa_backends(torch, q, k, v)
        backend = min(alone, key=lambda name: abs(alone[name] - lib_ms))
        b = attention_bound(B, N, N, 1, COSMOS_D)
        b32 = bound({"fp32": 4 * B * N * N * COSMOS_D}, 4 * N * B * COSMOS_D * 4)
        tflops = 4 * B * N * N * COSMOS_D / 1e9
        print(f"[38 K1] {name} ({B},{N},1,{COSMOS_D}): bf16 {ulps:.2f} ulps of max(|plain|, 1/64) vs plain (tol "
              f"{K1_MV_ULPS}; max abs {err16:.2e}), the plain version without its last {lost} keys {control:.1f} ulps "
              f"(>= {K1_MV_CONTROL_ULPS}); fp32 max abs {err32:.2e} (tol {K1_FP32_TOL}); logsumexp max abs bf16 "
              f"{lse_err16:.2e}, fp32 {lse_err32:.2e}; bf16 {ms:.4f} ms ({tflops / ms:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (its {backend} backend; each backend that takes D = 512 "
              f"alone: {({name: round(t, 4) for name, t in alone.items()})}), bound "
              f"{b[0]:.4f} ms ({b[1]}), share of the bound {b[0] / ms:.3f}; fp32 {f32_ms:.4f} ms, plain "
              f"{f32_plain_ms:.4f} ms, SDPA {f32_lib_ms:.4f} ms, its bound {b32[0]:.4f} ms ({b32[1]}) (CUDA graphs) "
              f"on {card}")
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=b, backend=backend,
                        fp32=dict(ms=f32_ms, plain_ms=f32_plain_ms, library_ms=f32_lib_ms, bound=b32))
        del q, k, v
        torch.cuda.empty_cache()
    return worst, main


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def cosmos_calls_checked(torch, fa, c3, record, control=False):
    """A context in which every K7 and K1 call of the Cosmos path is held against its plain version on the same
    activations: K7 in bf16 ulps at |plain| >= 1/16 (K7_ULPS), K1 in bf16 ulps of max(|plain|, 1/64) (K1_MV_ULPS) or
    fp32 max abs (K1_FP32_TOL). ``record`` collects the worst of each; the launches count as before. With
    ``control``, each bf16 K1 call also records (least over the calls, "K1 control") how far the plain version without
    the last key tile of K1 at D = 512 lands from the plain version, and each fp32 call ||out - plain|| / ||plain||
    ("K1 rel")."""
    import contextlib

    import uniception_tpu_torch.nn.dpt_parts as dpt_parts
    import uniception_tpu_torch.ops.attention as attention

    conv, attn = dpt_parts.conv3x3_nhwc, attention.flash_attention

    def conv_checked(x, w, b):
        out = conv(x, w, b)
        record["K7"] = max(record.get("K7", 0.0), _ulps(out, c3.conv3x3_reference(x, w, b), 7, floor=1 / 16))
        return out

    def attn_checked(q, k, v, scale=None):
        out, ref = attn(q, k, v, scale), fa.flash_attention_ref(q, k, v, scale)
        err = (_ulps(out, ref, 7, floor=K1_MV_ULP_FLOOR) if q.dtype == torch.bfloat16 else
               (out - ref).abs().max().item())
        record["K1"] = max(record.get("K1", 0.0), err)
        if control and q.dtype == torch.bfloat16:
            lost = k.shape[1] % fa.WIDE_ROWS or fa.WIDE_ROWS
            dropped = _ulps(fa.flash_attention_ref(q, k[:, :-lost], v[:, :-lost], scale), ref, 7,
                            floor=K1_MV_ULP_FLOOR)
            record["K1 control"] = min(record.get("K1 control", math.inf), dropped)
        elif control:
            record["K1 rel"] = max(record.get("K1 rel", 0.0), ((out - ref).norm() / ref.norm()).item())
        return out

    @contextlib.contextmanager
    def checked():
        dpt_parts.conv3x3_nhwc, attention.flash_attention = conv_checked, attn_checked
        try:
            yield
        finally:
            dpt_parts.conv3x3_nhwc, attention.flash_attention = conv, attn

    return checked()


def phase_cosmos_tokenizers(torch, F, np, config, fa, c3, counters, card):
    """The CI and DI tokenizers through ImageTokenizer at COSMOS_RUNS (seed 0, synthetic images in [-1, 1], the
    published widths, nothing cut): one autoencode with exact launches (K1 2 and COSMOS_K7's K7 in bf16, no K7 in
    fp32) and every K7 and K1 call held against its plain version on the same activations; the kernel path against
    the plain path (attention "naive": K1 and K7 on their plain versions) on the same weights: latents (DI: codes and
    the indices that flip) within COSMOS_REL_TOL, reconstructions (DI: the decoder on the plain path's indices)
    within COSMOS_REC_REL_TOL in bf16 and no farther from the fp32 plain path than the plain bf16 path is; images/s,
    device ms and peak memory; K7 at the tokenizers' conv shapes beside cuDNN and the bound; the CLI once in a
    subprocess on a PNG the phase writes. Returns the launches."""
    import shutil
    import tempfile

    from uniception_tpu_torch.models.libs.cosmos_tokenizer.image_lib import ImageTokenizer
    from uniception_tpu_torch.utils.png import read_png, write_png

    total = {k: 0 for k in counters}

    def nrel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for kind, comp, side, B, dt in COSMOS_RUNS:
        tag = f"39 {kind}{comp}x{comp} {side} x{B} {dt}"
        bf16 = dt == "bf16"
        tok = ImageTokenizer(kind, comp, device="cuda", dtype=torch.bfloat16 if bf16 else None, seed=SEED)
        x = torch.rand(B, 3, side, side, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 39)) * 2 - 1
        config.set_conv3x3_impl("kernel" if bf16 else "torch")
        try:
            config.set_attention_impl("naive")
            try:
                plain_enc = tok.encode(x)
                plain_auto = tok.autoencode(x)
                # DI: the decoder alone, on the plain path's indices
                plain_rec = plain_auto if kind == "CI" else tok.decode(plain_enc[0]).float().cpu().numpy()
                exact = None
                if bf16:  # the same weights in fp32 on the plain path: where the bf16 rung itself lands
                    twin = ImageTokenizer(kind, comp, device="cuda", seed=SEED)
                    exact = twin.autoencode(x) if kind == "CI" else twin.decode(plain_enc[0]).cpu().numpy()
                    del twin
                torch.cuda.synchronize()
            finally:
                config.set_attention_impl("kernel")
            want = {**{k: 0 for k in counters}, "K1": 2, "K7": sum(COSMOS_K7[kind, comp]) if bf16 else 0}
            calls = {}
            with cosmos_calls_checked(torch, fa, c3, calls):
                out = counted_forward(torch, counters, lambda: tok.autoencode(x), tag, want, total)
            k1_bar = K1_MV_ULPS if bf16 else K1_FP32_TOL
            print(f"[{tag}] every call against its plain version on the same activations: K7 {calls.get('K7', 0):.2f} "
                  f"ulp (tol {K7_ULPS}), K1 {calls['K1']:.3g} {'ulps' if bf16 else 'max abs'} (tol {k1_bar})")
            require(calls.get("K7", 0.0) <= K7_ULPS and calls["K1"] <= k1_bar, f"{tag}: calls {calls}")
            require(out.shape == (B, 3, side, side) and np.isfinite(out).all(), f"{tag}: reconstruction {out.shape}")
            tol = COSMOS_REL_TOL[dt]
            enc = tok.encode(x)
            if kind == "CI":
                require(tuple(enc.shape) == (B, 16, side // comp, side // comp), f"{tag}: latent {tuple(enc.shape)}")
                rel_lat = _rel(enc, plain_enc)
                detail = f"latent {tuple(enc.shape)} {rel_lat:.3e} (tol {tol})"
                require(rel_lat <= tol, f"{tag}: latent kernels vs plain {rel_lat} > {tol}")
                rec, what = out, "reconstruction"
            else:
                idx, codes = enc
                flips = (idx != plain_enc[0]).float().mean().item()
                rel_codes = _rel(codes, plain_enc[1])
                detail = (f"FSQ indices {tuple(idx.shape)}: {flips:.4%} flip; codes {rel_codes:.3e}; the "
                          f"reconstruction through the flipped indices {nrel(out, plain_auto):.3e}")
                rec, what = tok.decode(plain_enc[0]).float().cpu().numpy(), "decoder on the plain path's indices"
            rel_rec = nrel(rec, plain_rec)
            rec_tol = tol if exact is None else COSMOS_REC_REL_TOL
            rung = ""
            if exact is not None:
                d_plain, d_kernel = nrel(plain_rec, exact), nrel(rec, exact)
                rung = (f"; from the fp32 plain path: the plain path {d_plain:.3e}, the kernels {d_kernel:.3e} "
                        f"(<= {COSMOS_RUNG_SLACK} x the plain path's)")
                require(d_kernel <= COSMOS_RUNG_SLACK * d_plain, f"{tag}: the kernels land {d_kernel} from the fp32 "
                        f"path, the plain path {d_plain}")
            print(f"[{tag}] kernels vs plain path ||kernel - plain|| / ||plain||: {detail}; {what} {rel_rec:.3e} "
                  f"(tol {rec_tol}){rung}; mean |recon - input| {np.abs(out - x.cpu().numpy()).mean():.4f}")
            require(rel_rec <= rec_tol, f"{tag}: {what} kernels vs plain {rel_rec} > {rec_tol}")
            forward_timing(torch, lambda: tok.autoencode(x), B, "images", f"{B} images per autoencode", tag, card)
        finally:
            config.set_conv3x3_impl("torch")
        del tok, x, plain_enc, plain_auto, plain_rec, exact, out, rec, enc
        gc.collect()
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 39)
    for name, B, hw, C, Co in COSMOS_K7_SHAPES:
        x = torch.randn(B, hw, hw, C, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(3, 3, C, Co, device="cuda", generator=gen) * (9 * C) ** -0.5).bfloat16()
        b = torch.randn(Co, device="cuda", generator=gen) * 0.1
        out, ref = c3.conv3x3_nhwc(x, w, b), c3.conv3x3_reference(x, w, b)
        ulps = _ulps(out, ref, 7, floor=1 / 16)
        require(ulps <= K7_ULPS and torch.equal(c3.conv3x3_nhwc(x, w, b), out), f"39 K7 {name}: {ulps} ulp")
        ms, plain_ms = graph_ms(torch, lambda: c3.conv3x3_nhwc(x, w, b)), graph_ms(
            torch, lambda: c3.conv3x3_reference(x, w, b), iters=5)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        stock_ms = graph_ms(torch, lambda: F.conv2d(xc, wc, b.bfloat16(), padding=1))
        flops = 2 * B * hw * hw * C * Co * 9
        k7_bound = bound({"bf16": flops}, (x.numel() + w.numel() + B * hw * hw * Co) * 2 + Co * 4)
        print(f"[39 K7] Cosmos {name:26s} {B}x{hw}x{hw}x{C} -> {Co}: {ulps:.2f} ulp (tol {K7_ULPS}); {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), cuDNN bf16 {stock_ms:.4f} ms ({ms / stock_ms:.3f}x), bound "
              f"{k7_bound[0]:.4f} ms ({k7_bound[1]}), plain (fp32 conv) {plain_ms:.4f} ms (CUDA graphs) on {card}")
        del x, w, b, out, ref
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_cosmos_", dir=REPO)
    try:
        src, dst = os.path.join(tmp, "in.png"), os.path.join(tmp, "out.png")
        y, xx = np.mgrid[0:512, 0:512]
        write_png(src, np.stack([xx // 2, y // 2, (xx + y) // 4], -1).astype(np.uint8))
        cmd = [sys.executable, "-m", "uniception_tpu_torch.models.libs.cosmos_tokenizer.image_cli", "--image", src,
               "--output", dst, "--tokenizer", "CI", "--spatial-compression", "8", "--dtype", "bfloat16"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0 and "recon (1, 3, 512, 512)" in proc.stdout and read_png(dst).shape ==
                (512, 512, 3), f"39 CLI: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr[-2000:]}")
        print(f"[39 CLI] {' '.join(cmd[2:4])} on a 512 x 512 PNG, bf16, on the card in {time.perf_counter() - t0:.1f} "
              f"s (process start, build check, weights, one autoencode): {proc.stdout.strip().splitlines()[0]}; "
              f"wrote a 512 x 512 PNG")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def phase_cosmos_encoder_and_head(torch, config, counters, card):
    """The Cosmos encoder through encoder_factory at CI8x8 and CI16x16, 512, batch 2, bf16 (K1 1, K7 16 per forward),
    and CosmosFeature(input_feature_dim=768, output_dim=3, patch_size=16) in bf16 over a 768-wide 32^2 map (DUSt3R's
    decoder width): three CI16x16 decoders (K1 3, K7 72 per pass) into FlowWithConfidenceAdaptor. Each against the
    plain path with exact launches, images/s, device ms and peak memory. Returns the launches."""
    from uniception_tpu_torch.models.encoders import ViTEncoderInput, encoder_factory
    from uniception_tpu_torch.models.prediction_heads import base as tbase
    from uniception_tpu_torch.models.prediction_heads.cosmos import CLASSNAME_TO_ADAPTOR_CLASS, CosmosFeature

    total = {k: 0 for k in counters}
    bf16, tol = torch.bfloat16, COSMOS_REL_TOL["bf16"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    x = torch.rand(BATCH, 3, IMG, IMG, device="cuda", generator=gen) * 2 - 1
    config.set_conv3x3_impl("kernel")
    try:
        for patch in (8, 16):
            tag = f"40 encoder_factory cosmos CI{patch}x{patch} {IMG} x{BATCH} bf16"
            enc = encoder_factory("cosmos", name=f"cosmos_ci{patch}x{patch}", patch_size=patch, device="cuda",
                                  seed=SEED, dtype=bf16).eval()
            inp = ViTEncoderInput(image=x, data_norm_type="cosmos")

            def fwd():
                with torch.inference_mode():
                    return enc(inp).features

            config.set_attention_impl("naive")
            try:
                plain = fwd()
            finally:
                config.set_attention_impl("kernel")
            out = counted_forward(torch, counters, fwd, tag, {**{k: 0 for k in counters}, "K1": 1,
                                                              "K7": COSMOS_K7["CI", patch][0]}, total)
            rel = _rel(out, plain)
            print(f"[{tag}] features {tuple(out.shape)}: kernels vs plain path {rel:.3e} (tol {tol})")
            require(tuple(out.shape) == (BATCH, 16, IMG // patch, IMG // patch) and torch.isfinite(out).all().item()
                    and rel <= tol, f"{tag}: {tuple(out.shape)}, {rel}")
            forward_timing(torch, fwd, BATCH, "images", f"{BATCH} images per forward", tag, card)
            del enc, out, plain
            torch.cuda.empty_cache()

        tag = f"40 CosmosFeature 768 -> 3 (CI16x16) over a 32^2 map x{BATCH} bf16"

        def build_head(dtype):  # the same weights for the bf16 head and its fp32 twin
            return CosmosFeature(input_feature_dim=DEC_DIM, output_dim=3, patch_size=16, device="cuda", dtype=dtype,
                                 generator=torch.Generator(device="cuda").manual_seed(SEED + 41)).eval()

        head = build_head(bf16)
        adaptor = CLASSNAME_TO_ADAPTOR_CLASS["FlowWithConfidenceAdaptor"](
            "flow", (0.0, 0.0), (1.0, 1.0), (IMG, IMG), "none", False, "exp", 1.0, float("inf"))
        feat = torch.randn(BATCH, DEC_DIM, 32, 32, device="cuda", generator=gen).bfloat16()

        def head_fwd(mod=head, inp=feat):
            with torch.inference_mode():
                decoded = mod(tbase.PredictionHeadInput(last_feature=inp))[0].decoded_channels
                return decoded, adaptor(tbase.AdaptorInput(adaptor_feature=decoded, output_shape_hw=(IMG, IMG)))

        config.set_attention_impl("naive")
        try:
            plain, plain_flow = head_fwd()
            exact = head_fwd(build_head(None), feat.float())[0]  # fp32 on the plain path: where bf16 itself lands
        finally:
            config.set_attention_impl("kernel")
        out, flow = counted_forward(torch, counters, head_fwd, tag, {**{k: 0 for k in counters}, "K1": 3,
                                                                      "K7": 3 * COSMOS_K7["CI", 16][1]}, total)
        rels = {"decoded": _rel(out, plain), "flow": _rel(flow.value, plain_flow.value),
                "confidence": _rel(flow.confidence, plain_flow.confidence)}
        d_plain, d_kernel = _rel(plain, exact), _rel(out, exact)
        print(f"[{tag}] decoded {tuple(out.shape)}, flow {tuple(flow.value.shape)}, confidence "
              f"{tuple(flow.confidence.shape)}: kernels vs plain path {({k: f'{v:.3e}' for k, v in rels.items()})} "
              f"(tol {COSMOS_REC_REL_TOL}: each decoder is a CI16x16 one behind 24 K7 convs); decoded from the fp32 "
              f"plain path: the plain path {d_plain:.3e}, the kernels {d_kernel:.3e} (<= {COSMOS_RUNG_SLACK} x)")
        require(tuple(out.shape) == (BATCH, 3, IMG, IMG) and torch.isfinite(out).all().item() and
                max(rels.values()) <= COSMOS_REC_REL_TOL and d_kernel <= COSMOS_RUNG_SLACK * d_plain,
                f"{tag}: {tuple(out.shape)} {rels}, from fp32 {d_kernel} vs the plain path's {d_plain}")
        forward_timing(torch, head_fwd, BATCH, "images", f"{BATCH} maps per pass", tag, card)
        del head, out, plain, flow, plain_flow, exact
    finally:
        config.set_conv3x3_impl("torch")
    torch.cuda.empty_cache()
    return total


# Phases 41-46: every head dim the Pallas kernels take. K1 takes any D up to 512, K3 and K6 up to 256, K5 a multiple of 4
# up to 256 (ops/flash_attention.py head_dim_rule); a D that is not a multiple of 8 is padded into a copy.
# Phase 41 holds each kernel against its plain version at every padded head dim it is built for and at D = 20
# (not a multiple of 8), with Nq != Nk and ragged N, at the bars of the earlier phases; then times each at the new
# paths' shapes beside the plain version, SDPA and the bound. D: K1's DP 64 (8, 16, 20, 48), 128 (72), 192 (136,
# 192), 256 (200, 256), 512 (264, 504); K3's DP 64, 128, 192, 256; K6's row of 64, 128, 256 bytes; K5's padded
# heads of 32, 64, 128, 256 columns and D = 64 itself.
HD_K1 = [8, 16, 20, 48, 72, 136, 192, 200, 256, 264, 504]
HD_K3 = [16, 20, 48, 80, 128, 136, 192, 256]
HD_K6 = [16, 20, 32, 80, 128, 136, 256]
HD_K5 = [16, 20, 32, 48, 64, 80, 96, 128, 192, 256]
# (B, Nq, Nk, H): Nq != Nk, ragged tiles of 64 and 128 rows. Hundreds of keys, where K1's bar was set (phase 22): at
# 70 keys an exact fp32 emulation of K1's online softmax over 64-key tiles (the column-split kernel's) reads 10.5-10.8
# bf16 ulps of max(|plain|, 1/64) from the plain version, whose p is rounded against the row's global max; at 520 and
# 700 keys 4.5-5.0 (worst of 8 draws, D = 136, on the CPU)
HD_SHAPES = [(2, 200, 520, 3), (1, 130, 700, 2)]
# The new paths' shapes, (kernel, name, B, Nq, Nk, H, D), timed by CUDA graphs: the JAX training example's defaults
# (32 x 32 images, patch 16: 4 tokens a view, 8 pairs; the decoder's cross-attention over the other view), ViT-L 512
# training at 8 and 32 heads, RADIO-h and Pixio-H under "fused" (K5, C = 1280), Pixio-H, E-RADIO's windows and the
# differential info sharing's self-attention under int8 attention, PE-G14's attention pooling (one query).
HD_TIMED = [("K3", "training example D = 16", 16, 4, 4, 4, 16), ("K3", "ViT-L 512 8 heads", 4, 1024, 1024, 8, 128),
            ("K3", "ViT-L 512 32 heads", 4, 1024, 1024, 32, 32), ("K5", "RADIO-h 512", 2, 1033, 1033, 16, 80),
            ("K5", "Pixio-H 256", 2, 264, 264, 16, 80), ("K6", "Pixio-H 256", 2, 264, 264, 16, 80),
            ("K6", "E-RADIO /16 window", 2, 1024, 1024, 12, 32), ("K6", "E-RADIO /32 window", 2, 256, 256, 24, 32),
            ("K6", "differential self 512", 2, 1024, 1024, 6, 128), ("K1", "PE-G14 attention pool", 2, 1, 1025, 8, 192)]


def _hd_qkv(torch, gen, B, Nq, Nk, H, D, dt):
    "q as a view of a (B, Nq, 3, H, D) projection, k and v of a (B, Nk, 2, H, D) one, as the layers make them."
    q = torch.randn(B, Nq, 3, H, D, device="cuda", generator=gen).to(dt)[:, :, 0]
    kv = torch.randn(B, Nk, 2, H, D, device="cuda", generator=gen).to(dt)
    return q, kv[:, :, 0], kv[:, :, 1]


def k3_errors(torch, fa, q, k, v, dout, label):
    "K3's gradients against the plain backward (max |err| / max |plain|, each gradient); raises over K3_REL_TOL."
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    refs = fa.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, lse, dout)))
    tol = K3_REL_TOL["bf16" if q.dtype == torch.bfloat16 else "fp32"]
    rels = []
    for g, r in zip(grads, refs):
        require(g.shape == r.shape and torch.isfinite(g).all().item(), f"{label}: gradient {tuple(g.shape)} non-finite")
        rels.append(((g.float() - r).abs().max() / r.abs().max()).item())
    require(max(rels) <= tol, f"{label}: dq dk dv {rels} > {tol}")
    return rels, max((g.float() - r).abs().max().item() for g, r in zip(grads, refs))


def _k5_inputs(torch, gen, B, N, C, H, D, grid, make_patch_positions):
    "Seeded fp32 inputs of a K5 self call: x (B, N, C), wqkv (3 H D, C), bqkv, the positions of a grid."
    x = torch.randn(B, N, C, device="cuda", generator=gen)
    w = torch.randn(3 * H * D, C, device="cuda", generator=gen) * C**-0.5
    b = torch.randn(3 * H * D, device="cuda", generator=gen) * 0.1
    return x, w, b, make_patch_positions(B, *grid, device="cuda")


def phase_head_dim_kernels(torch, fa, fused, make_patch_positions, card):
    """Phase 41: K1, K3, K6 and K5 at the head dims of HD_K1, HD_K3, HD_K6 and HD_K5 against their plain versions,
    then timed at the paths' shapes (HD_TIMED). Returns {kernel: (worst bf16 max abs, {name: timing})}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    worst = {"K1": 0.0, "K3": 0.0, "K5": 0.0, "K6": 0.0}
    copies = fa.pad_head_dim.copies
    for D in HD_K1:
        for B, Nq, Nk, H in HD_SHAPES:
            for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
                q, k, v = _hd_qkv(torch, gen, B, Nq, Nk, H, D, dt)
                lost = Nk % fa.fwd_rows(-(-D // 8) * 8) or fa.fwd_rows(-(-D // 8) * 8)
                err, controls, lse_err = zoo_k1_check(torch, fa, q, k, v, lost, f"41 K1 D={D} ({B},{Nq},{Nk},{H}) {label}")
                if dt == torch.bfloat16:
                    worst["K1"] = max(worst["K1"], (fa.flash_attention(q, k, v).float()
                                                    - fa.flash_attention_ref(q, k, v).float()).abs().max().item())
                    print(f"[41 K1] D={D} (B,Nq,Nk,H)=({B},{Nq},{Nk},{H}) bf16 {err:.2f} ulps (tol {K1_MV_ULPS}), "
                          f"controls {controls[0]:.1f} / {controls[1]:.1f} ulps (>= {K1_MV_CONTROL_ULPS}), logsumexp "
                          f"{lse_err:.2e}", end="")
                else:
                    print(f"; fp32 {err:.2e} (tol {ZOO_K1_FP32_REL_TOL}), logsumexp {lse_err:.2e}")
    for D in HD_K3:
        for B, Nq, Nk, H in HD_SHAPES:
            line = f"[41 K3] D={D} (B,Nq,Nk,H)=({B},{Nq},{Nk},{H}) max|err|/max|plain| dq dk dv"
            for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
                q, k, v = _hd_qkv(torch, gen, B, Nq, Nk, H, D, dt)
                dout = torch.randn(B, Nq, H, D, device="cuda", generator=gen).to(dt)
                rels, abs_err = k3_errors(torch, fa, q, k, v, dout, f"41 K3 D={D} {label}")
                if dt == torch.bfloat16:
                    worst["K3"] = max(worst["K3"], abs_err)
                line += f" {label} " + " ".join(f"{r:.2e}" for r in rels) + f" (tol {K3_REL_TOL[label]})"
            print(line)
    for D in HD_K6:
        for B, Nq, Nk, H in HD_SHAPES:
            q, k, v = _hd_qkv(torch, gen, B, Nq, Nk, H, D, torch.bfloat16)
            exact = fa.flash_attention_ref(q.float(), k.float(), v.float())
            line = f"[41 K6] D={D} (B,Nq,Nk,H)=({B},{Nq},{Nk},{H})"
            for mode in fa.INT8_MODES:
                prep, prep_ref = fa.flash_attention_int8_prep(k, v, mode), fa.flash_attention_int8_prep_ref(k, v, mode)
                require(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(prep, prep_ref)),
                        f"41 K6 D={D} {mode}: the prep's scratch is not its plain version's")
                out, ref = fa.flash_attention_int8(q, k, v, mode=mode), fa.flash_attention_int8_ref(q, k, v, mode=mode)
                ulps, rel, rel_plain, fails = k6_check(out, ref, exact)
                require(not fails, f"41 K6 D={D} {mode}: {fails}")
                worst["K6"] = max(worst["K6"], (out.float() - ref.float()).abs().max().item())
                line += (f" {mode}: prep bit for bit, {ulps:.2f} ulps (tol {K6_ULPS}), from exact {rel:.2e} "
                         f"(plain {rel_plain:.2e});")
            print(line)
    C, N, grid = 256, 400, (20, 20)  # hundreds of keys, as for K1 (HD_SHAPES): K5's attention is K1's kernel
    for D in HD_K5:
        H = max(1, 512 // D)
        x, w, b, pos = _k5_inputs(torch, gen, 2, N, C, H, D, grid, make_patch_positions)
        line = f"[41 K5] D={D} self (2, {N}, C={C}, H={H})"
        for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            bf16 = dt == torch.bfloat16
            for rope in (True, False):
                args = (x.to(dt), w.to(dt), b, pos if rope else None, H, D**-0.5)
                out, ref = fused.fused_qkv_rope_attention(*args), fused.fused_qkv_rope_attention_ref(*args)
                err, ok = k5_check(out, ref, bf16)
                require(out.shape == ref.shape and ok, f"41 K5 D={D} {label} rope {rope}: {err}")
                line += f" {label} rope {'on' if rope else 'off'} {err:.3g}"
                if bf16:
                    worst["K5"] = max(worst["K5"], (out.float() - ref.float()).abs().max().item())
                if bf16 and rope:  # the control: the positions dropped must fail the same check
                    c_err, c_ok = k5_check(fused.fused_qkv_rope_attention(*args[:3], None, H, D**-0.5), ref, True)
                    require(not c_ok, f"41 K5 D={D}: the control without positions passed ({c_err})")
                    line += f" (control without positions {c_err:.3g})"
        if D in (16, 80):  # cross: q from 100 tokens, k and v from 64 of another grid
            xkv, _, _, kpos = _k5_inputs(torch, gen, 2, 64, C, H, D, (8, 8), make_patch_positions)
            wq, wk, wv = w.bfloat16().chunk(3)
            args = (x.bfloat16(), xkv.bfloat16(), wq, wk, wv, *b.chunk(3), pos, kpos, H, D**-0.5)
            err, ok = k5_check(fused.fused_cross_rope_attention(*args), fused.fused_cross_rope_attention_ref(*args),
                               True)
            require(ok, f"41 K5 cross D={D}: {err}")
            line += f"; cross bf16 {err:.3g}"
        print(line + f" (ulps of max(|plain|, 1/64), tol {K5_ULPS}; fp32 max abs, tol {K5_FP32_TOL})")
    print(f"[41 pad] copies of a head dim padded to a multiple of 8 in this phase: {fa.pad_head_dim.copies - copies}")
    times = {k: {} for k in worst}
    for kernel, name, B, Nq, Nk, H, D in HD_TIMED:
        times[kernel][name] = head_dim_times(torch, fa, fused, make_patch_positions, gen, kernel, name, B, Nq, Nk, H, D,
                                             card)
    return worst, times


def head_dim_times(torch, fa, fused, make_patch_positions, gen, kernel, name, B, Nq, Nk, H, D, card):
    """One kernel at one of HD_TIMED's shapes (bf16): its time beside the plain version, the library call (SDPA's
    forward, or its backward alone for K3) and the bound, by CUDA graphs. Returns the timing record."""
    q, k, v = _hd_qkv(torch, gen, B, Nq, Nk, H, D, torch.bfloat16)
    attn_ops = 4 * B * H * Nq * Nk * D
    if kernel == "K1":
        fn, plain = (lambda: fa.flash_attention(q, k, v)), (lambda: fa.flash_attention_ref(q, k, v))
        lib_ms, b = graph_ms(torch, lambda: sdpa(q, k, v)), attention_bound(B, Nq, Nk, H, D)
    elif kernel == "K3":
        dout = torch.randn(B, Nq, H, D, device="cuda", generator=gen).bfloat16()
        out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        fn = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout)  # noqa: E731
        plain = lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, dout)  # noqa: E731
        lib_ms = sdpa_bwd_ms(torch, q, k, v, dout)[0]
        b = bound({"bf16": 10 * B * H * Nq * Nk * D}, (4 * Nq + 5 * Nk) * B * H * D * 2 + B * H * Nq * 4)
    elif kernel == "K6":
        fn, plain = (lambda: fa.flash_attention_int8(q, k, v)), (lambda: fa.flash_attention_int8_ref(q, k, v))
        lib_ms = graph_ms(torch, lambda: sdpa(q, k, v))
        b = bound({"int8": 2 * B * H * Nq * Nk * D, "bf16": 2 * B * H * Nq * Nk * D},
                  (2 * Nq + 2 * Nk) * B * H * D * 2)
    else:  # K5 self: x (B, N, C = H D), the qkv projection, RoPE and attention
        C = H * D
        x, w, bq, _ = _k5_inputs(torch, gen, B, Nq, C, H, D, (1, Nq), make_patch_positions)
        args = (x.bfloat16(), w.bfloat16(), bq, None, H, D**-0.5)  # RADIO and Pixio take no RoPE
        fn, plain = (lambda: fused.fused_qkv_rope_attention(*args)), (lambda: fused.fused_qkv_rope_attention_ref(*args))
        qkv = lambda: torch.nn.functional.linear(args[0], args[1], bq.bfloat16()).unflatten(-1, (3, H, D))  # noqa: E731
        lib_ms = graph_ms(torch, lambda: sdpa(*qkv().unbind(2)))
        proj = 2 * B * Nq * C * 3 * H * D
        b = bound({"bf16": proj + attn_ops}, (B * Nq * C + 3 * H * D * C + B * Nq * H * D) * 2 + 3 * H * D * 4)
    ms, plain_ms = graph_ms(torch, fn), graph_ms(torch, plain)
    print(f"[41 {kernel}] {name} (B,Nq,Nk,H,D)=({B},{Nq},{Nk},{H},{D}) bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"{'SDPA backward alone' if kernel == 'K3' else 'cuBLAS qkv + SDPA' if kernel == 'K5' else 'SDPA'} "
          f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), share of the bound {b[0] / ms:.3f} (CUDA graphs) on {card}")
    # one PyTorch call computes K1's and K3's function; none computes K5's or K6's (SDPA is exact, unfused attention)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms if kernel in ("K1", "K3") else None, bound=b)


# The JAX training example's own command line (examples/train_dust3r.py's defaults: 32 x 32 images, 64 wide, 2 deep,
# 4 heads: D = 16, batch 8, 10 steps, fp32), on the card; phase 42 runs it once through the kernels and once on the
# plain path (attention "naive"), each from the same seed.
TRAIN_EXAMPLE_FLAGS = ["--device", "cuda", "--seed", str(SEED)]
# Phase 43: training at ViT-L 512's width (1024 wide, 24 deep encoder and decoder, batch 2 pairs, bf16 trunk over fp32
# parameters) at 8 heads (D = 128) and 32 (D = 32).
VITL_TRAIN_HEADS = [8, 32]
VITL_CHECK_DEPTH = 4  # the gradient check against the plain path at this depth: the plain attention's (B, H, N, N) fp32
# scores, saved for its backward in every layer, do not fit the card at 24 + 24 blocks and 32 heads
PE_POOL_HEADS = 8  # PE-Core-G14's attention pool: 8 heads of 1536 / 8 = 192


def _head_dims(*fns):
    "The launches by head dim of each wrapper (its ``head_dims`` counter), as plain dicts."
    return [dict(f.head_dims) for f in fns]


def _clear_head_dims(*fns):
    for f in fns:
        f.head_dims.clear()


HD_SEEN = {}  # kernel -> {head dim: launches} over phases 42-46's counted runs, for the kernels line


def _seen(kernel, dims):
    for d, n in dims.items():
        HD_SEEN.setdefault(kernel, {})[d] = HD_SEEN.get(kernel, {}).get(d, 0) + n


def phase_train_example(torch, train, config, fa, tc, card):
    """Phase 42 (path a): ``train.main`` with the JAX example's defaults and no width flag, on the card: exact
    launches (K1 with its logsumexp, K3 and K2 both ways, every one at D = 16), finite losses, and the same run on the
    plain path within phase 10's fp32 bar step by step. Returns the launches."""
    args = train.parse_args(TRAIN_EXAMPLE_FLAGS)
    D = args.embed_dim // args.heads
    require(D == 16, f"42 the training example's head dim is {D}, not the JAX example's 16")
    attn = args.depth + args.depth * 2 * 2  # the encoder over both views, then each view's self and cross layers
    want = {k: v * args.steps for k, v in train_want(tc, attn, attn).items()}
    _treset(tc)
    _clear_head_dims(fa.flash_attention, fa.flash_attention_bwd)
    t0 = time.perf_counter()
    losses = train.main(TRAIN_EXAMPLE_FLAGS)
    seconds = time.perf_counter() - t0
    got = _tread(tc)
    dims = _head_dims(fa.flash_attention, fa.flash_attention_bwd)
    config.set_attention_impl("naive")
    try:
        plain = train.main(TRAIN_EXAMPLE_FLAGS)
    finally:
        config.set_attention_impl("kernel")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    print(f"[42 train example] python -m uniception_tpu_torch.train {' '.join(TRAIN_EXAMPLE_FLAGS)} (img {args.img}, "
          f"embed {args.embed_dim}, depth {args.depth}, heads {args.heads}: D = {D}, batch {args.batch}, {args.steps} "
          f"steps, fp32) in {seconds:.1f} s: losses {['%.6f' % x for x in losses]}, plain path "
          f"{['%.6f' % x for x in plain]}, worst step rel {max(rel):.2e} (tol {TRAIN_FP32_REL_TOL}); launches {got} "
          f"(want {want}); K1 and K3 by head dim {dims} on {card}")
    require(len(losses) == args.steps and all(math.isfinite(x) for x in losses + plain), "42: a non-finite loss")
    require(got == want, f"42 launches {got}, want {want}")
    require(dims == [{D: want["K1"]}, {D: want["K3"]}], f"42 head dims {dims}")
    _seen("K1", dims[0])
    _seen("K3", dims[1])
    require(max(rel) <= TRAIN_FP32_REL_TOL, f"42 kernels vs plain path losses {max(rel)} > {TRAIN_FP32_REL_TOL}")
    return got


def phase_train_vitl_heads(torch, train, serve, training, config, fa, tc, card):
    """Phase 43 (path b): training at ViT-L 512's width at 8 and 32 heads, bf16, built by the training CLI's own
    builder and loss: one step's loss and gradients together against the plain path at the bf16 bars (depth cut to
    VITL_CHECK_DEPTH), then at depth 24 a step's exact launches (K1 with its logsumexp, K3 and K2 at D = 128 or 32),
    ms/step, device ms and peak memory. Returns the launches."""
    total = {}
    for heads in VITL_TRAIN_HEADS:
        D = ENC_DIM // heads
        label = f"43 train ViT-L {IMG} {heads} heads (D = {D}) bf16"

        def flags(depth):
            return ["--device", "cuda", "--img", str(IMG), "--embed-dim", str(ENC_DIM), "--depth", str(depth),
                    "--heads", str(heads), "--batch", str(BATCH), "--bf16", "--seed", str(SEED)]

        # the path's outputs at the bf16 bars of section 2: the loss and all gradients together, at VITL_CHECK_DEPTH.
        # The per-parameter bar of phase 10 is printed, not held: its worst parameters are cross-attention projk
        # biases, whose gradient is a near-cancelling sum over the tokens (zero but for RoPE's backward), in which
        # K3's rounding of ds to bf16 before dk (the Pallas kernel's order) is the whole of what is left.
        args = train.parse_args(flags(VITL_CHECK_DEPTH))
        model = train.build_model(args, torch.device("cuda"))
        check_train_grads(torch, config, model, train._loss_fn(args), _train_batch(torch, train, serve, model),
                          f"{label}, depth {VITL_CHECK_DEPTH}", per_parameter=False)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        args = train.parse_args(flags(ENC_DEPTH))
        model = train.build_model(args, torch.device("cuda"))
        loss_fn = train._loss_fn(args)
        batch = _train_batch(torch, train, serve, model)
        ctx = training.make_train_step(model, loss_fn=loss_fn, learning_rate=args.lr)
        attn = ENC_DEPTH + ENC_DEPTH * 2 * 2
        _clear_head_dims(fa.flash_attention, fa.flash_attention_bwd)
        _tadd(total, counted_step(torch, tc, ctx, batch, train_want(tc, attn, attn), label))
        dims = _head_dims(fa.flash_attention, fa.flash_attention_bwd)
        print(f"[{label}] K1 and K3 launches by head dim {dims}")
        require(dims == [{D: attn}, {D: attn}], f"{label}: head dims {dims}")
        _seen("K1", dims[0])
        _seen("K3", dims[1])
        torch.cuda.reset_peak_memory_stats()
        timed_steps(torch, ctx, batch, label, card, BATCH, "pairs")
        del model, ctx, batch
        gc.collect()
        torch.cuda.empty_cache()
    return total


def _out_tensors(out):
    "The output tensors of a forward: a list or tuple of tensors as it is, else an encoder's (_dino_tensors)."
    if isinstance(out, (list, tuple)) and all(hasattr(t, "shape") for t in out):
        return list(out)
    return _dino_tensors(out)


def impl_against(torch, config, counters, fwd, label, want, total, tol, impl, ref_impl):
    """``ref_impl`` (uncounted), then ``impl`` with exact launches, on the same inputs and weights: every output finite
    and within ``tol`` of the reference, ||out - ref|| / ||ref||. Returns the counted output."""
    config.set_attention_impl(ref_impl)
    try:
        ref = fwd()
        torch.cuda.synchronize()
    finally:
        config.set_attention_impl("kernel")
    config.set_attention_impl(impl)
    try:
        out = counted_forward(torch, counters, fwd, label, want, total)
    finally:
        config.set_attention_impl("kernel")
    errs = []
    for a, b in zip(_out_tensors(out), _out_tensors(ref)):
        require(a.shape == b.shape and torch.isfinite(a).all().item(), f"{label}: {tuple(a.shape)} non-finite or not "
                f"the reference's {tuple(b.shape)}")
        errs.append(((a.float() - b.float()).norm() / b.float().norm()).item())
    print(f"[{label}] {impl} vs {ref_impl} on the same weights, ||out - ref|| / ||ref|| of "
          f"{[tuple(t.shape) for t in _out_tensors(out)]}: {', '.join(f'{e:.3e}' for e in errs)} (tol {tol})")
    require(max(errs) <= tol, f"{label}: {impl} vs {ref_impl} {max(errs)} > {tol}")
    return out


def phase_zoo_fused(torch, np, serve, config, blocks, fused, counters, card):
    """Phase 44 (path c): RADIO v2.5-H/16 at 512 (batch 2, all 32 blocks) and Pixio-H/16 at 256 in bf16 through
    encoder_factory under "fused": K5-self at D = 80, 32 per forward, every call held against its plain version on
    the same activations; the output against the same weights on "kernel" (K1) and on the plain path; images/s,
    device ms and peak memory. Returns the launches."""
    from uniception_tpu_torch.models.encoders import encoder_factory

    total = {k: 0 for k in counters}
    bf16 = dict(device="cuda", seed=SEED, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    runs = [(f"44 RADIO v2.5-H/16 {ZOO_IMG} bf16 fused", lambda: encoder_factory(
                "radio", name="radio_v2.5-h", model_version="radio_v2.5-h", **bf16),
             _zoo_input(torch, np, serve, "radio", ZOO_BATCH, (ZOO_IMG, ZOO_IMG), SEED), RADIO_H_DEPTH),
            ("44 Pixio-H/16 256 bf16 fused", lambda: encoder_factory("pixio", name="pixio_vith16", **bf16),
             _zoo_input(torch, np, serve, "pixio", ZOO_BATCH, (256, 256), SEED + 4), 32)]
    for tag, build, inp, depth in runs:
        enc = build().eval()

        def fwd():
            with torch.inference_mode():
                return enc(inp)

        calls = []

        def checked(*args):
            out = fused.fused_qkv_rope_attention(*args)
            calls.append(k5_check(out, fused.fused_qkv_rope_attention_ref(*args), True)[0])
            return out

        blocks.fused_qkv_rope_attention = checked
        fused.fused_qkv_rope_attention.head_dims.clear()
        copies = fused.fused_qkv_rope_attention.weight_copies
        try:
            impl_against(torch, config, counters, fwd, tag, {**{k: 0 for k in counters}, "K5-self": depth}, total,
                         MODEL_REL_TOL, "fused", "kernel")
        finally:
            blocks.fused_qkv_rope_attention = fused.fused_qkv_rope_attention
        dims = dict(fused.fused_qkv_rope_attention.head_dims)
        print(f"[{tag}] {len(calls)} K5 calls, each against its plain version on the same activations: max "
              f"{max(calls):.2f} ulp (tol {K5_ULPS}); K5-self by head dim {dims}; weights copied into padded heads "
              f"{fused.fused_qkv_rope_attention.weight_copies - copies} times (once per K5 call)")
        require(len(calls) == depth and max(calls) <= K5_ULPS and dims == {80: depth}, f"{tag}: {calls} {dims}")
        _seen("K5", dims)
        impl_against(torch, config, counters, fwd, tag, {**{k: 0 for k in counters}, "K5-self": depth}, total,
                     MODEL_REL_TOL, "fused", "naive")
        _seen("K5", {80: depth})
        config.set_attention_impl("fused")
        try:
            dino_timing(torch, fwd, ZOO_BATCH, tag, card)
        finally:
            config.set_attention_impl("kernel")
        del enc
        gc.collect()
        torch.cuda.empty_cache()
    return total


def phase_zoo_int8(torch, np, serve, config, attention, fa, counters, card, DUSt3R):
    """Phase 45 (path d): int8 attention (config.set_attention_quant("int8")) in bf16 on Pixio-H/16 at 256 (K6 at
    D = 80, 32 per forward), E-RADIO v2 at 512 (its windows: K6 at D = 32, 10 per forward) and DUSt3R-DPT 512 with
    the differential info sharing (phase 37's model: K6 at D = 64 in the encoder, at D = 128 on the blocks'
    self-attention; the differential cross-attention takes the einsum path). Every K6 call held against its plain
    version on the same activations (exact attention as the control), and the output against the same weights with
    int8 attention on its plain version (attention "naive"; DUSt3R's decoder features and outputs at phase 37's
    bars). Returns the launches."""
    from uniception_tpu_torch.models.encoders import encoder_factory
    from uniception_tpu_torch.models.info_sharing.diff_cross_attention_transformer import (
        DifferentialMultiViewCrossAttentionTransformerIFR,
    )

    total = {k: 0 for k in counters}
    none = {k: 0 for k in counters}
    bf16 = dict(device="cuda", seed=SEED, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    radio_in = _zoo_input(torch, np, serve, "radio", ZOO_BATCH, (ZOO_IMG, ZOO_IMG), SEED)

    def diff_model():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 38)
        model = DUSt3R(name="dust3r_diff_dpt", img_size=(IMG, IMG), pred_head_type="dpt", head_dtype=torch.bfloat16,
                       dtype=torch.bfloat16, device="cuda", generator=gen)
        model.info_sharing = DifferentialMultiViewCrossAttentionTransformerIFR(
            name="base_info_sharing", input_embed_dim=ENC_DIM, num_views=2, depth=DEC_DEPTH, dim=DEC_DIM,
            num_heads=DEC_HEADS, custom_positional_encoding=model.rope, indices=[5, 8], norm_intermediate=False,
            device="cuda", dtype=torch.bfloat16, generator=gen)
        return model.eval()

    frames = np.random.RandomState(SEED + 37).randint(0, 256, size=(2 * BATCH, IMG, IMG, 3), dtype=np.uint8)
    runs = [("45 Pixio-H/16 256 bf16 int8 attention", lambda: encoder_factory("pixio", name="pixio_vith16", **bf16),
             _zoo_input(torch, np, serve, "pixio", ZOO_BATCH, (256, 256), SEED + 4), {80: 32}, {}),
            (f"45 E-RADIO v2 {ZOO_IMG} bf16 int8 attention", lambda: encoder_factory(
                "radio", name="e-radio_v2", model_version="e-radio_v2", eradio_input_shape=(ZOO_IMG, ZOO_IMG), **bf16),
             radio_in, {32: 10}, {}),
            (f"45 differential DUSt3R-DPT {IMG} bf16 int8 attention", diff_model, None,
             {64: ENC_DEPTH, 128: 2 * DEC_DEPTH}, {"K2": 2 * ENC_DEPTH + 2 * DEC_DEPTH * 4})]
    config.set_attention_quant("int8")
    try:
        for tag, build, inp, want_dims, extra in runs:
            model = build()
            if inp is None:
                fn = serve.make_serving_fn(model, "cuda")

                def fwd():
                    return list(fn(frames[0::2], frames[1::2]))
            else:
                def fwd():
                    with torch.inference_mode():
                        return model(inp)

            ulps, ctrl = [], []

            def k6_checked(q, k, v, scale=None, mode="int8"):
                o = fa.flash_attention_int8(q, k, v, scale, mode)
                ref = fa.flash_attention_int8_ref(q, k, v, scale, mode)
                ulps.append(_ulps(o, ref, 7, floor=K6_ULP_FLOOR))
                ctrl.append(_ulps(fa.flash_attention_ref(q, k, v, scale), ref, 7, floor=K6_ULP_FLOOR))
                return o

            attention.flash_attention_int8 = k6_checked
            fa.flash_attention_int8.head_dims.clear()
            try:
                want = {**none, **extra, "K6": sum(want_dims.values())}
                if inp is not None:
                    impl_against(torch, config, counters, fwd, tag, want, total, MODEL_REL_TOL, "kernel", "naive")
                    dims = dict(fa.flash_attention_int8.head_dims)
                else:  # the decoder features and the outputs through the bf16 DPT heads at phase 37's bars
                    counted_forward(torch, counters, fwd, tag, want, total)
                    dims = dict(fa.flash_attention_int8.head_dims)
                    bucket_check(torch, config, model, fn, (frames[0::2], frames[1::2]), tag,
                                 ("pts3d", "conf1", "pts3d_in_other_view", "conf2"))
            finally:
                attention.flash_attention_int8 = fa.flash_attention_int8
            print(f"[{tag}] {len(ulps)} K6 calls, each against its plain version on the same activations: max "
                  f"{max(ulps):.2f} ulp (tol {K6_ULPS}); exact attention, the control: {sum(c > K6_ULPS for c in ctrl)} "
                  f"calls over the tol, max {max(ctrl):.2f}; K6 by head dim {dims}")
            require(max(ulps) <= K6_ULPS and max(ctrl) > K6_ULPS, f"{tag}: K6 {max(ulps)}, control {max(ctrl)}")
            require(dims == want_dims, f"{tag}: K6 by head dim {dims}, want {want_dims}")
            _seen("K6", dims)
            forward_timing(torch, fwd, ZOO_BATCH if inp is not None else BATCH, "images" if inp is not None else
                           "pairs", "batch 2", tag, card, top=6)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        config.set_attention_quant("none")
    return total


def phase_pe_pool(torch, np, serve, config, fa, counters, card):
    """Phase 46 (path e): PE-Core-G14 at 448, depth cut to PE_G_BLOCKS of 50 blocks as phase 35 cuts it, bf16, through
    the vision tower's pooled forward (pool_type "attn": the probe's attention over the 1024 patch tokens, 8 heads of
    192): K1 at D = 96 in the blocks and at D = 192 in the pool, against the plain path. Returns the launches."""
    from uniception_tpu_torch.models.encoders import encoder_factory

    total = {k: 0 for k in counters}
    tag = f"46 PE-Core-G14 448 pooled forward bf16 ({PE_G_BLOCKS} of 50 blocks)"
    enc = encoder_factory("perception_encoder", name="pe_core_giant", size="giant", checkpoint_type="core",
                          keep_first_n_layers=PE_G_BLOCKS - 1, device="cuda", seed=SEED, dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16).eval()
    tower = enc.model  # the vision tower, pool_type "attn"
    require(tower.pool_type == "attn" and tower.attn_pool.attn.head_dim == 1536 // PE_POOL_HEADS, f"{tag}: the pool")
    image = _zoo_input(torch, np, serve, "perception_encoder", ZOO_BATCH, (448, 448), SEED + 2).image.bfloat16()

    def fwd():
        with torch.inference_mode():
            return [tower(image)]

    fa.flash_attention.head_dims.clear()
    out = impl_against(torch, config, counters, fwd, tag, {**{k: 0 for k in counters}, "K1": PE_G_BLOCKS + 1}, total,
                       MODEL_REL_TOL, "kernel", "naive")
    dims = dict(fa.flash_attention.head_dims)
    require(tuple(out[0].shape) == (ZOO_BATCH, 1280), f"{tag}: {tuple(out[0].shape)}")
    require(dims == {96: PE_G_BLOCKS, 192: 1}, f"{tag}: K1 by head dim {dims}")
    _seen("K1", dims)
    print(f"[{tag}] (B, 1280) embedding; K1 by head dim {dims}")
    forward_timing(torch, fwd, ZOO_BATCH, "images", "batch 2", tag, card, top=6)
    del enc, tower
    torch.cuda.empty_cache()
    return total


# Phase 47: the two redesigned kernels, K1's fp32 kernel (3xTF32 on wgmma) and K3's whole-width kernels above D = 64,
# at every padded head dim each is built for and at the paths' shapes, (name, B, Nq, Nk, H, D): held against their
# plain versions (K1 fp32 at K1_FP32_TOL, LSE_TOL and ZOO_K1_FP32_REL_TOL; K3 at K3_REL_TOL and bit for bit across two
# calls), then timed by CUDA graphs beside the plain version, the library call (SDPA fp32; SDPA's backward alone) and
# the bound. K1 fp32's bound takes its products at the TF32 rate over three (PEAK_OPS "tf32x3": each needed product
# is three on the tensor cores), K3's at bf16. The fp32 K3 kernels (CUDA cores, unchanged) are timed beside SDPA's
# fp32 backward at the training example's and the fp32 trunk's shapes.
K47_K1_F32 = [("Cosmos CI8x8 512", 2, 4096, 4096, 1, 512), ("fp32 DUSt3R trunk", 4, 1024, 1024, 16, 64),
              ("DINOv2-L 518", 2, 1374, 1374, 16, 64), ("RADIO-h 512", 2, 1033, 1033, 16, 80),
              ("training example D = 16", 16, 4, 4, 4, 16), ("DP 32 (D = 32)", 2, 1024, 1024, 12, 32),
              ("DP 128 (D = 128)", 1, 1029, 1029, 32, 128), ("DP 256 (D = 192)", 2, 1024, 1024, 8, 192),
              ("DP 256 (D = 256)", 2, 1024, 1024, 4, 256)]
K47_K3 = [("ViT-L 512 8 heads", 4, 1024, 1024, 8, 128), ("RADIO-h 512 D = 80", 2, 1033, 1033, 16, 80),
          ("PE-G14 448 D = 96", 2, 1024, 1024, 16, 96), ("phase 41 D = 80", 2, 200, 520, 3, 80),
          ("phase 41 D = 96", 2, 200, 520, 3, 96), ("phase 41 D = 128", 1, 130, 700, 2, 128),
          ("DP 192 (D = 192)", 2, 1024, 1024, 8, 192), ("DP 256 (D = 256)", 2, 1024, 1024, 8, 256),
          ("phase 41 D = 192", 2, 200, 520, 3, 192), ("phase 41 D = 256", 1, 130, 700, 2, 256)]
K47_K3_F32 = [("training example D = 16", 16, 4, 4, 4, 16), ("fp32 DUSt3R trunk", 4, 1024, 1024, 16, 64)]


def phase_redesigned(torch, fa, card):
    """Phase 47: K47_K1_F32, K47_K3 and K47_K3_F32 against their plain versions, then timed. Returns ({"K1 fp32" |
    "K3": worst max abs}, {"K1 fp32" | "K3" | "K3 fp32": {name: timing record}})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 47)
    worst, times = {"K1 fp32": 0.0, "K3": 0.0}, {"K1 fp32": {}, "K3": {}, "K3 fp32": {}}
    for name, B, Nq, Nk, H, D in K47_K1_F32:
        q, k, v = _hd_qkv(torch, gen, B, Nq, Nk, H, D, torch.float32)
        out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        ref, ref_lse = fa.flash_attention_lse_ref(q, k, v)
        err, lse_err = (out - ref).abs().max().item(), (lse - ref_lse).abs().max().item()
        rel = ((out - ref).norm() / ref.norm()).item()
        require(torch.equal(out, fa.flash_attention_fwd(q, k, v)[0]), f"47 K1 fp32 {name}: the logsumexp moved o")
        require(err <= K1_FP32_TOL and lse_err <= LSE_TOL["fp32"] and rel <= ZOO_K1_FP32_REL_TOL,
                f"47 K1 fp32 {name}: max abs {err}, logsumexp {lse_err}, ||err|| / ||plain|| {rel}")
        worst["K1 fp32"] = max(worst["K1 fp32"], err)
        ms = graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v))
        plain_ms = graph_ms(torch, lambda: fa.flash_attention_ref(q, k, v))
        lib_ms = graph_ms(torch, lambda: sdpa(q, k, v))
        b = bound({"tf32x3": 4 * B * H * Nq * Nk * D}, (2 * Nq + 2 * Nk) * B * H * D * 4)
        times["K1 fp32"][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=b)
        print(f"[47 K1 fp32] {name} (B,Nq,Nk,H,D)=({B},{Nq},{Nk},{H},{D}): max abs {err:.2e} (tol {K1_FP32_TOL}), "
              f"||err||/||plain|| {rel:.2e} (tol {ZOO_K1_FP32_REL_TOL}), logsumexp {lse_err:.2e} (tol "
              f"{LSE_TOL['fp32']}); {ms:.4f} ms ({4 * B * H * Nq * Nk * D / ms / 1e9:.1f} TFLOP/s of the needed "
              f"products), plain {plain_ms:.4f} ms, SDPA fp32 {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), bound "
              f"{b[0]:.4f} ms ({b[1]}, 3xTF32 at {PEAK_OPS['tf32x3'] / 1e12:.0f} TFLOP/s), share of the bound "
              f"{b[0] / ms:.3f} (CUDA graphs) on {card}")
    for name, B, Nq, Nk, H, D in K47_K3:
        q, k, v = _hd_qkv(torch, gen, B, Nq, Nk, H, D, torch.bfloat16)
        dout = torch.randn(B, Nq, H, D, device="cuda", generator=gen).bfloat16()
        rels, abs_err = k3_errors(torch, fa, q, k, v, dout, f"47 K3 {name}")
        out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        fn = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout)  # noqa: E731
        require(all(torch.equal(a, c) for a, c in zip(fn(), fn())), f"47 K3 {name}: two calls differ")
        worst["K3"] = max(worst["K3"], abs_err)
        ms = graph_ms(torch, fn)
        plain_ms = graph_ms(torch, lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, dout))
        lib_ms = sdpa_bwd_ms(torch, q, k, v, dout)[0]
        b = bound({"bf16": 10 * B * H * Nq * Nk * D}, (4 * Nq + 5 * Nk) * B * H * D * 2 + B * H * Nq * 4)
        times["K3"][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=b)
        print(f"[47 K3] {name} (B,Nq,Nk,H,D)=({B},{Nq},{Nk},{H},{D}) bf16: max|err|/max|plain| dq dk dv "
              + " ".join(f"{r:.2e}" for r in rels) + f" (tol {K3_REL_TOL['bf16']}), two calls bit for bit; "
              f"{ms:.4f} ms ({10 * B * H * Nq * Nk * D / ms / 1e9:.1f} TFLOP/s of the five products), plain "
              f"{plain_ms:.4f} ms, SDPA backward alone {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), bound {b[0]:.4f} ms "
              f"({b[1]}), share of the bound {b[0] / ms:.3f} (CUDA graphs) on {card}")
    for name, B, Nq, Nk, H, D in K47_K3_F32:
        q, k, v = _hd_qkv(torch, gen, B, Nq, Nk, H, D, torch.float32)
        dout = torch.randn(B, Nq, H, D, device="cuda", generator=gen)
        rels, _ = k3_errors(torch, fa, q, k, v, dout, f"47 K3 fp32 {name}")
        out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        ms = graph_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout))
        plain_ms = graph_ms(torch, lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, dout))
        lib_ms = sdpa_bwd_ms(torch, q, k, v, dout)[0]
        b = bound({"fp32": 10 * B * H * Nq * Nk * D}, (4 * Nq + 5 * Nk) * B * H * D * 4 + B * H * Nq * 4)
        times["K3 fp32"][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=b)
        print(f"[47 K3 fp32] {name} (B,Nq,Nk,H,D)=({B},{Nq},{Nk},{H},{D}): max|err|/max|plain| dq dk dv "
              + " ".join(f"{r:.2e}" for r in rels) + f" (tol {K3_REL_TOL['fp32']}); {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA fp32 backward alone {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), bound {b[0]:.4f} "
              f"ms ({b[1]}, FFMA at 67 TFLOP/s), share of the bound {b[0] / ms:.3f} (CUDA graphs) on {card}")
    return worst, times


# Phase 48: the int8 weight-transform path at DUSt3R ViT-L 512 (linear heads). One layer of each kind the transforms'
# Hessian updates touch (d_in 1024, 768, 768), and three of d_in 768, 1024 and 4096 for GPTQ on the card against the
# CPU in float64.
TRANSFORM_LAYERS = ("encoder.enc_blocks.0.attn.qkv", "info_sharing.multi_view_branches.0.5.attn.proj",
                    "info_sharing.multi_view_branches.1.7.cross_attn.proj")
GPTQ_CPU_LAYERS = ("info_sharing.multi_view_branches.0.0.attn.qkv", "encoder.enc_blocks.0.attn.qkv",
                   "encoder.enc_blocks.0.mlp.fc2")
SMOOTH_ALPHA, CALIB_PAIRS, HELD_OUT_PAIRS, HELD_OUT_SEED = 0.25, 2, 2, 42
# An analytically updated Hessian against a fresh capture on the transformed model, max |a - b| / max |b|: the bar of
# the JAX package's test_hessian_updates_match_fresh_capture. Both captures are fp32 (TF32 off): a bf16 model's
# activations move with the bf16 rounding of the transformed weights, about 2^-9 relative, which is more than the bar.
HESSIAN_UPDATE_REL_TOL = 1e-3
# GPTQ in fp32 on the card against the same in float64 on the CPU: the H-metric error of the codes within 1%.
GPTQ_H_ERR_REL_TOL = 1e-2
# An fp32 Hessian is symmetric up to the GEMM's summation order: max |H - H^T| / max |H|.
HESSIAN_SYM_REL_TOL = 1e-6


def phase_int8_transforms(torch, np, serve, config, quant, i8, counters, card, k4_serving):
    """DUSt3R ViT-L 512 with linear heads, seeded: the int8 weight-transform path (calibrate_gptq, nn/gptq.py,
    nn/smooth.py) on the card. (a) Hessians and activation maxima over 2 calibration pairs (RandomState(7)) of the bf16
    model through K1 and K2, exact launches; (b) SmoothQuant(0.25) + QuaRot on an fp32 copy leave the kernel path's
    outputs, and the analytic Hessian updates equal a fresh capture; (c) GPTQ of every captured layer in fp32 on the
    card, three layers against float64 on the CPU; (d) the ladder RTN, + smooth, + rotate, GPTQ, GPTQ + smooth + rotate
    on 2 held-out pairs (RandomState(42)) through K4/K1/K2 against the fp32 plain path; (e) every K4 call of the last
    rung against its plain version; (f) serve.build_model(int8, gptq=npz), serve_frames of RTN and the last rung, and
    convert_checkpoints --int8 --gptq to an .nsv read back. Returns the launches of the counted runs."""
    import shutil
    import tempfile

    from uniception_tpu_torch import calibrate_gptq, convert_checkpoints
    from uniception_tpu_torch.nn import gptq, smooth
    from uniception_tpu_torch.utils.coldstart import load_native_state

    dims = (ENC_DEPTH, ENC_DIM, ENC_HEADS, DEC_DEPTH, DEC_DIM, DEC_HEADS)
    embed = 1 if ENC_DIM != DEC_DIM else 0  # proj_embed: one layer, run once per view
    k4_want = ENC_DEPTH * 4 + 2 * embed + DEC_DEPTH * 2 * 8
    layers_want = k4_want - embed
    want = {k: 0 for k in counters}
    want.update(K1=ENC_DEPTH + DEC_DEPTH * 2 * 2, K2=2 * ENC_DEPTH + DEC_DEPTH * 2 * 4)
    total = {k: 0 for k in counters}

    def counted(label, fn, forwards, k4=0):
        _reset(counters)
        out = fn()
        torch.cuda.synchronize()
        got = _read(counters)
        expect = {k: v * forwards for k, v in dict(want, K4=k4).items()}
        require(got == expect, f"48 {label}: launches {got}, want {expect}")
        for k in total:
            total[k] += got[k]
        return out, got

    def seeded(dtype):
        return serve.build_model(IMG, *dims, device="cuda", dtype=dtype, seed=SEED)

    def bf16_of(float_model):
        "The serving model's bf16 cast of ``float_model`` (heads fp32, as build_model's)."
        m = seeded(torch.bfloat16)
        m.load_state_dict(float_model.state_dict())
        return m

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    rng = np.random.RandomState(HELD_OUT_SEED)
    held = [tuple(torch.from_numpy(rng.randn(1, 3, IMG, IMG).astype(np.float32)).cuda() for _ in range(2))
            for _ in range(HELD_OUT_PAIRS)]

    @torch.no_grad()
    def outputs(m, impl="kernel"):
        "pts3d, conf (view 1), pts3d_in_other_view, conf (view 2) of the held-out pairs, concatenated."
        config.set_attention_impl(impl)
        try:
            res = [m.forward_pair(a, b) for a, b in held]
        finally:
            config.set_attention_impl("kernel")
        return [torch.cat([r[v][k] for r in res]) for k, v in (("pts3d", 0), ("conf", 0),
                                                               ("pts3d_in_other_view", 1), ("conf", 1))]

    def capture_layers(m, paths, pair):
        "fp32 (or the model's dtype) Hessians of the linears at ``paths``, over one pair."
        for part in ("encoder", "info_sharing"):
            gptq.install_hessian_capture(getattr(m, part), predicate=lambda p, _, s=part: f"{s}.{p}" in paths)
        with torch.no_grad():
            m.forward_pair(*pair)
        return gptq.harvest_hessians(m)

    # (a) the capture, on the bf16 model through the kernels
    float_model = seeded(torch.float32)
    cal = bf16_of(float_model)
    pairs = list(calibrate_gptq.calibration_pairs(IMG, CALIB_PAIRS, "cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (hessians, amax, n_pairs), _ = counted("capture", lambda: calibrate_gptq.capture(cal, pairs, "all"), CALIB_PAIRS)
    capture_s = time.perf_counter() - t0
    finite = all(torch.isfinite(h).all().item() for h in hessians.values())
    asym = max(((h - h.t()).abs().max() / h.abs().max()).item() for h in hessians.values())
    print(f"[48 transforms] (a) captured {len(hessians)} trunk linears (policy all) over {n_pairs} pairs of "
          f"{IMG}x{IMG} (RandomState(7)) through the kernels in {capture_s:.2f}s (install, forwards, harvest; "
          f"synchronised): K1 {want['K1']} and K2 {want['K2']} per forward; every H finite {finite}, max |H - H^T| / "
          f"max |H| {asym:.2e} (tol {HESSIAN_SYM_REL_TOL}) on {card}")
    require(len(hessians) == layers_want, f"48: {len(hessians)} layers captured, want {layers_want}")
    require(finite and asym <= HESSIAN_SYM_REL_TOL, f"48: a Hessian is non-finite or not symmetric ({asym})")

    # (b) the transforms are identities on the fp32 function; the Hessian updates equal a fresh capture
    ref = outputs(float_model)
    h3 = capture_layers(float_model, TRANSFORM_LAYERS, held[0])
    moved = seeded(torch.float32)
    folds = smooth.smooth_trunk(moved, amax, alpha=SMOOTH_ALPHA, hessians=h3)
    rotations = smooth.rotate_trunk(moved, hessians=h3, seed=0)
    out = outputs(moved)
    fresh = capture_layers(moved, TRANSFORM_LAYERS, held[0])
    del moved
    errs = [rel(a, b) for a, b in zip(out, ref)]
    h_errs = {p: ((h3[p] - fresh[p]).abs().max() / fresh[p].abs().max()).item() for p in TRANSFORM_LAYERS}
    print(f"[48 transforms] (b) smooth_trunk(alpha {SMOOTH_ALPHA}) {folds} folds + rotate_trunk(seed 0) {rotations} "
          f"rotations on the fp32 model (TF32 off), kernel path before vs after on the held-out pairs, rel: pts3d "
          f"{errs[0]:.2e}, conf {errs[1]:.2e}, pts3d_in_other_view {errs[2]:.2e}, conf2 {errs[3]:.2e} (tol "
          f"{MODEL_FP32_REL_TOL}); analytic Hessian updates vs a fresh fp32 capture on the transformed model, max |a - "
          f"b| / max |b|: " + ", ".join(f"{p} {e:.2e}" for p, e in h_errs.items()) + f" (tol {HESSIAN_UPDATE_REL_TOL})")
    require(max(errs) <= MODEL_FP32_REL_TOL, f"48: the transforms moved the fp32 outputs by {errs}")
    require(max(h_errs.values()) <= HESSIAN_UPDATE_REL_TOL, f"48: Hessian updates off a fresh capture: {h_errs}")

    # (c) GPTQ of every captured layer in fp32 on the card; three layers against float64 on the CPU
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes, ratios = calibrate_gptq.gptq_layers(cal, hessians, dtype=torch.float32, diag_every=1, log=lambda s: None)
    torch.cuda.synchronize()
    gptq_s = time.perf_counter() - t0
    values = sorted(ratios.values())
    median, worst = float(np.median(values)), values[-1]
    linears = dict(cal.named_modules())
    for p in GPTQ_CPU_LAYERS:
        w, H = linears[p].weight.detach().t().cpu().double(), hessians[p].cpu()
        t0 = time.perf_counter()
        q64, s64 = gptq.gptq_int8(w, H)
        cpu_s = time.perf_counter() - t0
        q32, s32 = (t.cpu() for t in codes[p])
        e_card, e_cpu = calibrate_gptq.h_error(w, q32, s32, H), calibrate_gptq.h_error(w, q64, s64, H)
        share = (q32 == q64).double().mean().item()
        print(f"[48 transforms] (c) {p} (d_in {w.shape[0]}): fp32 codes on the card vs float64 on the CPU "
              f"({cpu_s:.1f}s): scales equal {torch.equal(s32, s64)}, codes equal {share:.6f}, H-metric error "
              f"{e_card:.6e} vs {e_cpu:.6e} ({abs(e_card - e_cpu) / e_cpu:.2e}, tol {GPTQ_H_ERR_REL_TOL})")
        require(abs(e_card - e_cpu) <= GPTQ_H_ERR_REL_TOL * e_cpu, f"48: GPTQ on the card off float64 at {p}")
    print(f"[48 transforms] (c) GPTQ of {len(codes)} layers in fp32 on the card in {gptq_s:.2f}s (blocksize 128, "
          f"percdamp 0.01; with the H-metric diagnostic on every layer); H-metric error ratio gptq/rtn over every "
          f"layer: median {median:.4f}, worst {worst:.4f}, best {values[0]:.4f} on {card}")
    require(len(codes) == layers_want and median < 1.0, f"48: GPTQ median H-ratio {median} over {len(codes)} layers")

    # (d) the ladder, each rung a bf16 cast of the (transformed) float model, quantized, through K4, K1 and K2
    plain = outputs(float_model, "naive")
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_gptq_", dir=REPO)
    try:
        npz = os.path.join(tmp, "gptq_dust3r.npz")
        calibrate_gptq.save_codes(npz, codes)
        bills, kept = {}, {}
        ladder = (("RTN", None, False, False), ("RTN + smooth", SMOOTH_ALPHA, False, False),
                  ("RTN + rotate", None, True, False), ("GPTQ", None, False, True),
                  ("GPTQ + smooth + rotate", SMOOTH_ALPHA, True, True))
        for name, alpha, rotate, with_gptq in ladder:
            rung_codes, extra = codes, ""
            if alpha is None and not rotate:
                m = bf16_of(float_model)
            else:
                h = {k: v.clone() for k, v in hessians.items()} if with_gptq else None
                f = seeded(torch.float32)
                if alpha is not None:
                    smooth.smooth_trunk(f, amax, alpha=alpha, hessians=h)
                if rotate:
                    smooth.rotate_trunk(f, hessians=h, seed=0)
                m = bf16_of(f)
                del f
                if with_gptq:  # GPTQ on the transformed weights against the analytically updated Hessians
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rung_codes, _ = calibrate_gptq.gptq_layers(m, h, dtype=torch.float32, diag_every=0)
                    torch.cuda.synchronize()
                    extra = f"; its GPTQ pass {time.perf_counter() - t0:.2f}s"
                    del h
            n_q = quant.quantize_trunk(m, "all")
            n_g = gptq.apply_gptq(m, rung_codes) if with_gptq else 0
            require(n_q == len(hessians) and n_g in (0, n_q), f"48 {name}: {n_q} quantized, {n_g} GPTQ layers")
            out, got = counted(name, lambda: outputs(m), HELD_OUT_PAIRS, k4_want)
            require(all(torch.isfinite(o).all().item() for o in out), f"48 {name}: non-finite output")
            bills[name] = [rel(a, b) for a, b in zip(out, plain)]
            print(f"[48 transforms] (d) {name:24s} pts3d bill vs the fp32 plain path {bills[name][0]:.4e} "
                  f"(pts3d_in_other_view {bills[name][2]:.4e}, conf {bills[name][1]:.4e}); {n_q} int8 layers, "
                  f"{n_g} with GPTQ codes; K4 {got['K4'] // HELD_OUT_PAIRS} per forward (phase 15: {k4_serving}), "
                  f"K1 {got['K1'] // HELD_OUT_PAIRS}, K2 {got['K2'] // HELD_OUT_PAIRS}{extra}")
            if name in ("RTN", "GPTQ", "GPTQ + smooth + rotate"):
                kept[name] = m
            del m
        require(k4_serving in (None, k4_want), f"48: phase 15's int8-linear rung ran {k4_serving} K4 per forward")
        require(bills["GPTQ"][0] < bills["RTN"][0], f"48: GPTQ's bill {bills['GPTQ'][0]} is not below RTN's")
        del cal, hessians, float_model
        torch.cuda.empty_cache()

        # (e) every K4 call of the last rung against its plain version on the same activations
        real, ulps, shares = quant.int8_matmul_dynamic, [], []

        def k4_checked(x, w_q, w_scale, bias=None, out_dtype=None):
            out = real(x, w_q, w_scale, bias, out_dtype)
            ref = i8.int8_matmul_dynamic_ref(x, w_q, w_scale, bias, out_dtype)
            x2 = x.reshape(-1, w_q.shape[0]).contiguous()
            x_q = torch.empty(x2.shape, dtype=torch.int8, device=x.device)  # the kernel's codes, from its C entry
            i8._launch(x2, x_q, torch.empty(x2.shape[0], device=x.device), w_q.t().contiguous(), w_scale, bias,
                       out.dtype, None)
            shares.append((x_q == i8.quantize_rows(x2)[0]).double().mean().item())
            ulps.append(_ulps(out, ref, 7 if out.dtype == torch.bfloat16 else 23))
            return out

        quant.int8_matmul_dynamic = k4_checked
        try:
            with torch.no_grad():
                kept["GPTQ + smooth + rotate"].forward_pair(*held[0])
        finally:
            quant.int8_matmul_dynamic = real
        print(f"[48 transforms] (e) every K4 call of one GPTQ + smooth + rotate forward ({len(ulps)} calls) against "
              f"its plain version on the same input: int8 codes equal, worst share {min(shares):.6f}; output max "
              f"{max(ulps):.2f} ulp (tol {K4_ULPS})")
        require(len(ulps) == k4_want and min(shares) == 1.0 and max(ulps) <= K4_ULPS,
                f"48: K4 against its plain version: {len(ulps)} calls, codes {min(shares)}, {max(ulps)} ulp")

        # (f) the serving entry points and the converter with the calibrated codes
        served = serve.build_model(IMG, *dims, device="cuda", seed=SEED, int8=True, gptq=npz)
        mine, theirs = served.state_dict(), kept.pop("GPTQ").state_dict()
        w_q_keys = [k for k in mine if k.endswith(".w_q")]
        require(len(w_q_keys) == layers_want and all(torch.equal(mine[k], theirs[k]) for k in w_q_keys),
                "48: serve.build_model(gptq=...) codes differ from the in-memory GPTQ model's")
        same = all(torch.equal(mine[k], theirs[k]) for k in mine)
        print(f"[48 transforms] (f) serve.build_model(int8=True, gptq={os.path.basename(npz)}): {len(w_q_keys)} w_q "
              f"bit-equal to the in-memory GPTQ rung's; every tensor equal {same}")
        del theirs
        pth, nsv = os.path.join(tmp, "dust3r.pth"), os.path.join(tmp, "dust3r_int8_gptq.nsv")
        f = seeded(torch.float32)
        torch.save({"model": {k: v.detach().cpu() for k, v in f.state_dict().items()}}, pth)
        del f
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        convert_checkpoints.main(["--serving", "--int8", "--gptq", npz, "--img-size", str(IMG), "--enc-depth",
                                  str(ENC_DEPTH), "--enc-dim", str(ENC_DIM), "--enc-heads", str(ENC_HEADS),
                                  "--dec-depth", str(DEC_DEPTH), "--dec-dim", str(DEC_DIM), "--dec-heads",
                                  str(DEC_HEADS), pth, nsv])
        convert_s = time.perf_counter() - t0
        _, meta = load_native_state(nsv)
        loaded = serve.build_model(IMG, *dims, device="cuda", checkpoint=nsv).state_dict()
        trunk = [k for k in mine if k.startswith(("encoder.", "info_sharing."))]  # the converter casts heads to bf16
        bad = [k for k in trunk if not torch.equal(loaded[k], mine[k])]
        print(f"[48 transforms] (f) convert_checkpoints --serving --int8 --gptq on the card in {convert_s:.1f}s: "
              f"meta quant_gptq_layers {meta.get('quant_gptq_layers')}, quant_layers {meta.get('quant_layers')}; read "
              f"back by serve.build_model(checkpoint=...), {len(trunk) - len(bad)} of {len(trunk)} trunk tensors "
              f"bit-equal to serve.build_model(int8, gptq)'s ({os.path.getsize(nsv)} bytes)")
        require(meta.get("quant_gptq_layers") == layers_want, f"48: the .nsv meta says {meta.get('quant_gptq_layers')}")
        require(not bad, f"48: {len(bad)} trunk tensors of the converted .nsv differ, e.g. {bad[:3]}")
        del served, mine, loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # serving: RTN against GPTQ + smooth + rotate, each alone on the card, in turns (a, b, b, a)
    frames = np.random.RandomState(SEED).randint(0, 256, size=(2 * BATCH * (SERVE_BATCHES + 1), IMG, IMG, 3),
                                                 dtype=np.uint8)
    served = {}
    for name in ("RTN", "GPTQ + smooth + rotate", "GPTQ + smooth + rotate", "RTN"):
        for other in kept:
            kept[other].to("cuda" if other == name else "cpu")
        torch.cuda.empty_cache()
        fn = serve.make_serving_fn(kept[name], "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, pairs, seconds = serve.serve_frames(fn, frames, BATCH, "cuda")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        require(all(torch.isfinite(o).all().item() for o in out), f"48 {name}: non-finite serving output")
        served.setdefault(name, []).append((pairs / seconds, peak))
        del out, fn
    for name, runs in served.items():
        print(f"[48 transforms] (f) serve_frames {name}: " + ", ".join(f"{r:.3f}" for r, _ in runs) + f" pairs/s at "
              f"{IMG}x{IMG} batch {BATCH}, {BATCH * (SERVE_BATCHES + 1)} pairs after one warm-up batch per run (CUDA "
              f"events; runs in turns RTN, transformed, transformed, RTN); max_memory_allocated "
              + ", ".join(f"{p} bytes ({p / 2**30:.3f} GiB)" for _, p in runs) + f" on {card}")
    del kept
    torch.cuda.empty_cache()
    return total


# --- Phases 49-50: the Cosmos causal video tokenizer and PE's language side -------------------------------------------

# Phase 49: (tokenizer, spatial compression, side, batch, dtype) through CausalVideoTokenizer at the published widths
# (CV8x8x8: FACTORIZED, haar patch 4, 16 latent channels; DV8x16x16: FSQ levels 8, 8, 8, 5, 5, 5), temporal
# compression 8, clips of VIDEO_FRAMES frames (5 after the 3D patching, 3 latent frames). The configs'
# attn_resolutions ([32] at resolution 1024) match no pyramid level (the encoder's 256, 128, 64; the decoder's 64, 128,
# 256), so only the two mid blocks attend: K1 VIDEO_K1 times per autoencode at D = 512 over B * 3 latent frames of
# (side / sc)^2 tokens. The 3D convs are F.conv3d (no K7, even under the 3x3-conv kernel); the causal temporal
# attention is the explicit einsum.
VIDEO_RUNS = [("CV", 8, 512, 2, "bf16"), ("CV", 8, 512, 1, "fp32"), ("DV", 16, 512, 2, "bf16"),
              ("CV", 8, 1024, 1, "bf16")]
VIDEO_FRAMES, VIDEO_TEMPORAL, VIDEO_LATENT_FRAMES, VIDEO_K1 = 17, 8, 3, 2
# K1 at the paths' shapes, (name, B, Nq, Nk, H, D, dtypes): the video mid blocks (B * 3 latent frames), PE-Core-L14-336's
# vision blocks over 8 images of 577 tokens and its attention pool (one probe over 577 keys, 8 heads of 128), and the
# Llama BaseTransformer at batch 2 (16 query heads, the 4 kv heads repeated). CV at 1024 runs in bf16 only: its fp32
# output, an average over 16384 keys, is small enough that the fp32 sums' 5.5e-7 read 2.6e-6 of its norm, above phase
# 47's norm-relative bar, which no fp32 path at that key count is held to (phase 38 holds (1, 16384) at max abs).
BOTH = ("bf16", "fp32")
K1_NEW_SHAPES = [("CV8x8x8 512 x2", 6, 4096, 4096, 1, 512, BOTH), ("DV8x16x16 512 x2", 6, 1024, 1024, 1, 512, BOTH),
                 ("CV8x8x8 1024 x1", 3, 16384, 16384, 1, 512, ("bf16",)),
                 ("PE-Core-L14 blocks", 8, 577, 577, 16, 64, BOTH), ("PE-Core-L14 pool", 8, 1, 577, 8, 128, BOTH),
                 ("Llama 1024 GQA", 2, 1024, 1024, 16, 64, BOTH)]
# Phase 50: PE-Core-L14-336 CLIP (ViT-L/14 at 336: 24 blocks, 16 heads of 64, a cls token, the attention pool of 8
# heads of 128; the text tower: 24 blocks of 1024, 16 heads, a context of 32), 8 images and 8 token sequences
PE_CLIP, PE_CLIP_BATCH, PE_EOT = "PE-Core-L14-336", 8, 49407
LLAMA_BATCH, LLAMA_DIM, LLAMA_HEADS, LLAMA_KV_HEADS = 2, 1024, 16, 4


def new_k1_times(torch, fa, card, seed):
    """K1 at K1_NEW_SHAPES, q, k and v strided views of one tensor: bf16 in ulps of max(|plain|, 1/64) (the control
    without the last key tile), fp32 at phase 47's bars; each timed by CUDA graphs beside the plain version, SDPA (at D
    = 512 its memory-efficient backend alone, which the default call runs) and the bound. Returns {name: {"bf16" |
    "fp32": timing record}} and the worst bf16 max abs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    times, worst = {}, 0.0
    for name, B, Nq, Nk, H, D, dtypes in K1_NEW_SHAPES:
        times[name] = {}
        lost = Nk % (fa.WIDE_ROWS if D > fa.WIDE_FROM else 128) or min(Nk - 1, 64)
        for dt in (getattr(torch, {"bf16": "bfloat16", "fp32": "float32"}[d]) for d in dtypes):
            q = torch.randn(B, Nq, 3, H, D, device="cuda", generator=gen).to(dt)[:, :, 0]
            k, v = torch.randn(B, Nk, 2, H, D, device="cuda", generator=gen).to(dt).unbind(2)
            out, ref = fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v)
            tag = f"49-50 K1 {name} ({B},{Nq},{Nk},{H},{D}) {'bf16' if dt == torch.bfloat16 else 'fp32'}"
            if dt == torch.bfloat16:
                err = _ulps(out, ref, 7, floor=K1_MV_ULP_FLOOR)
                control = _ulps(fa.flash_attention_ref(q, k[:, :-lost], v[:, :-lost]), ref, 7, floor=K1_MV_ULP_FLOOR)
                worst = max(worst, (out.float() - ref.float()).abs().max().item())
                require(err <= K1_MV_ULPS and control >= K1_MV_CONTROL_ULPS, f"{tag}: {err} ulps (tol {K1_MV_ULPS}), "
                        f"the control {control} (>= {K1_MV_CONTROL_ULPS})")
                check = f"{err:.2f} ulps (tol {K1_MV_ULPS}), the control without the last {lost} keys {control:.1f}"
                b = attention_bound(B, Nq, Nk, H, D)
            else:
                err, rel = (out - ref).abs().max().item(), ((out - ref).norm() / ref.norm()).item()
                require(err <= K1_FP32_TOL and rel <= ZOO_K1_FP32_REL_TOL, f"{tag}: max abs {err}, rel {rel}")
                check = f"max abs {err:.2e} (tol {K1_FP32_TOL}), ||err|| / ||plain|| {rel:.2e}"
                b = bound({"tf32x3": 4 * B * H * Nq * Nk * D}, (2 * Nq + 2 * Nk) * B * H * D * 4)
            del out, ref
            ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v), iters=5)
            plain_ms = graph_ms(torch, lambda: fa.flash_attention_ref(q, k, v), iters=3)
            lib_ms, lib_name = graph_ms(torch, lambda: sdpa(q, k, v), iters=5), "default"
            if D > 256:  # flash takes D <= 256: the default call runs the memory-efficient backend, timed alone
                try:
                    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                        lib_ms, lib_name = graph_ms(torch, lambda: sdpa(q, k, v), iters=5), "memory-efficient"
                except RuntimeError:  # it does not take these inputs: the default call's time stands
                    pass
            times[name]["bf16" if dt == torch.bfloat16 else "fp32"] = dict(ms=ms, plain_ms=plain_ms,
                                                                           library_ms=lib_ms, bound=b)
            print(f"[{tag}] {check}; {ms:.4f} ms ({4 * B * H * Nq * Nk * D / ms / 1e9:.1f} TFLOP/s), plain "
                  f"{plain_ms:.4f} ms, SDPA ({lib_name}) {lib_ms:.4f} ms ({ms / lib_ms:.3f}x), bound {b[0]:.4f} ms "
                  f"({b[1]}), share of the bound {b[0] / ms:.3f} (CUDA graphs) on {card}")
            del q, k, v
            torch.cuda.empty_cache()
    return times, worst


def phase_cosmos_video(torch, np, config, fa, c3, counters, card):
    """Phase 49: CV and DV through CausalVideoTokenizer at VIDEO_RUNS (seed 0, clips from RandomState(0) clipped to
    [-1, 1], the published widths, nothing cut), the 3x3-conv kernel switched on: one autoencode with exact launches
    (K1 VIDEO_K1, nothing else) with every K1 call held against its plain version on the same activations (bf16 in
    ulps with the dropped-tile control, fp32 at phase 47's bars); the kernel path against the plain path (attention
    "naive") on the same weights: the pre-quantization latent within COSMOS_REL_TOL, the reconstruction (DV: the
    decoder on the plain path's indices) within COSMOS_REC_REL_TOL in bf16 (COSMOS_REL_TOL in fp32) and no farther
    from the fp32 plain path than COSMOS_RUNG_SLACK x the plain bf16 path's distance; DV's FSQ indices that flip;
    frames/s, device ms and peak memory; the video CLI once on the card. Returns the launches."""
    from uniception_tpu_torch.models.libs.cosmos_tokenizer.video_lib import CausalVideoTokenizer

    total = {k: 0 for k in counters}

    def nrel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for kind, comp, side, B, dt in VIDEO_RUNS:
        tag = f"49 {kind}{VIDEO_TEMPORAL}x{comp}x{comp} {VIDEO_FRAMES}x{side}^2 x{B} {dt}"
        bf16 = dt == "bf16"
        tok = CausalVideoTokenizer(kind, comp, VIDEO_TEMPORAL, device="cuda",
                                   dtype=torch.bfloat16 if bf16 else None, seed=SEED)
        clip = np.random.RandomState(SEED).randn(B, 3, VIDEO_FRAMES, side, side).astype(np.float32).clip(-1, 1)
        x = torch.from_numpy(clip).cuda()

        def latent(t):  # the encoder's continuous output: CV's latent, DV's before the FSQ
            with torch.no_grad():
                return t.model.quant_conv(t.model.encoder(x))

        config.set_conv3x3_impl("kernel")
        try:
            config.set_attention_impl("naive")
            try:
                plain_lat, plain_enc = latent(tok), tok.encode(x)
                plain_auto = tok.autoencode(x)
                plain_rec = plain_auto if kind == "CV" else tok.decode(plain_enc[0]).float().cpu().numpy()
                exact = None
                if bf16:  # the same weights in fp32 on the plain path: where the bf16 rung itself lands
                    twin = CausalVideoTokenizer(kind, comp, VIDEO_TEMPORAL, device="cuda", seed=SEED)
                    exact = twin.autoencode(x) if kind == "CV" else twin.decode(plain_enc[0]).cpu().numpy()
                    del twin
                torch.cuda.synchronize()
            finally:
                config.set_attention_impl("kernel")
            want = {**{k: 0 for k in counters}, "K1": VIDEO_K1}
            calls = {}
            fa.flash_attention.head_dims.clear()
            with cosmos_calls_checked(torch, fa, c3, calls, control=True):
                out = counted_forward(torch, counters, lambda: tok.autoencode(x), tag, want, total)
            dims = dict(fa.flash_attention.head_dims)
            require(dims == {COSMOS_D: VIDEO_K1}, f"{tag}: K1 by head dim {dims}")
            if bf16:
                print(f"[{tag}] every K1 call against its plain version on the same activations: {calls['K1']:.2f} "
                      f"ulps of max(|plain|, 1/64) (tol {K1_MV_ULPS}); the plain version without the last key tile "
                      f"{calls['K1 control']:.1f} ulps at the least (>= {K1_MV_CONTROL_ULPS})")
                require(calls["K1"] <= K1_MV_ULPS and calls["K1 control"] >= K1_MV_CONTROL_ULPS, f"{tag}: {calls}")
            else:
                print(f"[{tag}] every K1 call against its plain version on the same activations: max abs "
                      f"{calls['K1']:.2e} (tol {K1_FP32_TOL}), ||err|| / ||plain|| {calls['K1 rel']:.2e} (tol "
                      f"{ZOO_K1_FP32_REL_TOL})")
                require(calls["K1"] <= K1_FP32_TOL and calls["K1 rel"] <= ZOO_K1_FP32_REL_TOL, f"{tag}: {calls}")
            require(out.shape == clip.shape and np.isfinite(out).all(), f"{tag}: reconstruction {out.shape}")
            tol = COSMOS_REL_TOL[dt]
            lat = latent(tok)
            grid = side // comp
            require(tuple(lat.shape) == (B, 16 if kind == "CV" else 6, VIDEO_LATENT_FRAMES, grid, grid),
                    f"{tag}: latent {tuple(lat.shape)}")
            rel_lat = _rel(lat, plain_lat)
            detail = f"latent {tuple(lat.shape)} {rel_lat:.3e} (tol {tol})"
            require(rel_lat <= tol, f"{tag}: latent kernels vs plain {rel_lat} > {tol}")
            if kind == "CV":
                rec, what = out, "reconstruction"
            else:
                idx, codes = tok.encode(x)
                flips = (idx != plain_enc[0]).float().mean().item()
                detail += (f"; FSQ indices {tuple(idx.shape)}: {flips:.4%} flip (printed, not held); codes "
                           f"{_rel(codes, plain_enc[1]):.3e}; the reconstruction through the flipped indices "
                           f"{nrel(out, plain_auto):.3e}")
                rec, what = tok.decode(plain_enc[0]).float().cpu().numpy(), "decoder on the plain path's indices"
            rel_rec = nrel(rec, plain_rec)
            rec_tol = tol if exact is None else COSMOS_REC_REL_TOL
            rung = ""
            if exact is not None:
                d_plain, d_kernel = nrel(plain_rec, exact), nrel(rec, exact)
                rung = (f"; from the fp32 plain path: the plain path {d_plain:.3e}, the kernels {d_kernel:.3e} "
                        f"(<= {COSMOS_RUNG_SLACK} x the plain path's)")
                require(d_kernel <= COSMOS_RUNG_SLACK * d_plain, f"{tag}: the kernels land {d_kernel} from the fp32 "
                        f"path, the plain path {d_plain}")
            print(f"[{tag}] kernels vs plain path ||kernel - plain|| / ||plain||: {detail}; {what} {rel_rec:.3e} "
                  f"(tol {rec_tol}){rung}; mean |recon - input| {np.abs(out - clip).mean():.4f}")
            require(rel_rec <= rec_tol, f"{tag}: {what} kernels vs plain {rel_rec} > {rec_tol}")
            forward_timing(torch, lambda: tok.autoencode(x), B * VIDEO_FRAMES, "frames",
                           f"{B} clips of {VIDEO_FRAMES} frames per autoencode", tag, card)
        finally:
            config.set_conv3x3_impl("torch")
        del tok, x, plain_lat, plain_enc, plain_auto, plain_rec, exact, out, rec, lat
        gc.collect()
        torch.cuda.empty_cache()

    cmd = [sys.executable, "-m", "uniception_tpu_torch.models.libs.cosmos_tokenizer.video_cli", "--device", "cuda",
           "--frames", str(VIDEO_FRAMES), "--size", "512", "--dtype", "bfloat16"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    fmt = (r"autoencode: input \(1, 3, 17, 512, 512\) -> recon \(1, 3, 17, 512, 512\), mean abs err \d+\.\d{4}")
    import re

    require(proc.returncode == 0 and re.fullmatch(fmt, line), f"49 CLI: rc {proc.returncode}\n{proc.stdout}\n"
            f"{proc.stderr[-2000:]}")
    print(f"[49 CLI] {' '.join(cmd[2:])} on the card in {time.perf_counter() - t0:.1f} s (process start, build check, "
          f"weights, one autoencode): {line}")
    return total


def phase_pe_language(torch, np, config, fa, counters, card):
    """Phase 50: PE-Core-L14-336 CLIP through CLIP.from_config (seed 0) in bf16 and fp32 on PE_CLIP_BATCH images at
    336^2 and as many token sequences of the context's 32 ids (RandomState(0); each row's EOT its highest id):
    encode_image with exact launches (K1 24 at D = 64, 1 at D = 128) and encode_text with none, each against the plain
    path (attention "naive"), the logit scale unchanged; the Llama BaseTransformer (1024 wide, 16 heads over 4 kv
    heads, the args' 8 layers and max_seqlen 1024) at batch 2: mask=None with K1 once a layer against the plain path,
    mask="causal" with no launch; images/s, texts/s and device ms. Returns the launches and K1's by head dim."""
    from uniception_tpu_torch.models.libs.perception_encoder.pe import CLIP, PE_TEXT_CONFIG, PE_VISION_CONFIG
    from uniception_tpu_torch.models.libs.perception_encoder.transformer import BaseTransformer, BaseTransformerArgs

    total, by_dim = {k: 0 for k in counters}, {}
    none = {k: 0 for k in counters}
    vcfg, tcfg = PE_VISION_CONFIG[PE_CLIP], PE_TEXT_CONFIG[PE_CLIP]

    def seen(dims):
        for d, n in dims.items():
            by_dim[d] = by_dim.get(d, 0) + n

    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.randn(PE_CLIP_BATCH, 3, vcfg.image_size, vcfg.image_size).astype(np.float32)).cuda()
    ids = rng.randint(1, PE_EOT, (PE_CLIP_BATCH, tcfg.context_length))
    ids[np.arange(PE_CLIP_BATCH), rng.randint(1, tcfg.context_length, PE_CLIP_BATCH)] = PE_EOT
    text = torch.from_numpy(ids).cuda()
    for dt in ("bf16", "fp32"):
        tol = MODEL_REL_TOL if dt == "bf16" else MODEL_FP32_REL_TOL
        model = CLIP.from_config(PE_CLIP, device="cuda", dtype=torch.bfloat16 if dt == "bf16" else None,
                                 generator=torch.Generator(device="cuda").manual_seed(SEED)).eval()
        heads = vcfg.width // vcfg.heads
        tag = f"50 CLIP {PE_CLIP} {dt}"
        fa.flash_attention.head_dims.clear()

        def enc_image():
            with torch.inference_mode():
                return [model.encode_image(images)]

        def enc_text():
            with torch.inference_mode():
                return [model.encode_text(text)]

        img = impl_against(torch, config, counters, enc_image, f"{tag} encode_image",
                           {**none, "K1": vcfg.layers + 1}, total, tol, "kernel", "naive")
        dims = dict(fa.flash_attention.head_dims)
        require(dims == {heads: vcfg.layers, vcfg.width // vcfg.attn_pooler_heads: 1}, f"{tag}: K1 by head dim {dims}")
        seen(dims)
        txt = impl_against(torch, config, counters, enc_text, f"{tag} encode_text", none, total, tol, "kernel",
                           "naive")
        with torch.inference_mode():
            scale = model()[2].item()
        require(img[0].shape == (PE_CLIP_BATCH, vcfg.output_dim) and txt[0].shape == (PE_CLIP_BATCH, tcfg.output_dim)
                and math.isclose(scale, 1 / 0.07, rel_tol=1e-6), f"{tag}: {img[0].shape}, {txt[0].shape}, {scale}")
        print(f"[{tag}] image features {tuple(img[0].shape)}, text features {tuple(txt[0].shape)}, exp(logit_scale) "
              f"{scale:.6f} (1 / 0.07); K1 by head dim {dims}")
        forward_timing(torch, enc_image, PE_CLIP_BATCH, "images", f"{PE_CLIP_BATCH} images at 336^2", f"{tag} image",
                       card, top=6)
        forward_timing(torch, enc_text, PE_CLIP_BATCH, "texts", f"{PE_CLIP_BATCH} texts of {tcfg.context_length}",
                       f"{tag} text", card, top=6)
        del model, img, txt
        torch.cuda.empty_cache()

    args = BaseTransformerArgs(dim=LLAMA_DIM, n_heads=LLAMA_HEADS, n_kv_heads=LLAMA_KV_HEADS)
    h = torch.from_numpy(rng.randn(LLAMA_BATCH, args.max_seqlen, LLAMA_DIM).astype(np.float32)).cuda()
    for dt in ("bf16", "fp32"):
        tol = MODEL_REL_TOL if dt == "bf16" else MODEL_FP32_REL_TOL
        model = BaseTransformer(args, device="cuda", dtype=torch.bfloat16 if dt == "bf16" else None,
                                generator=torch.Generator(device="cuda").manual_seed(SEED)).eval()
        tag = f"50 BaseTransformer {LLAMA_DIM} x{args.n_layers} GQA {LLAMA_HEADS}/{LLAMA_KV_HEADS} x{LLAMA_BATCH} {dt}"
        x = h.to(torch.bfloat16) if dt == "bf16" else h

        def run(mask):
            with torch.inference_mode():
                return [model(x, mask=mask)]

        fa.flash_attention.head_dims.clear()
        impl_against(torch, config, counters, lambda: run(None), f"{tag} mask=None", {**none, "K1": args.n_layers},
                     total, tol, "kernel", "naive")
        dims = dict(fa.flash_attention.head_dims)
        require(dims == {LLAMA_DIM // LLAMA_HEADS: args.n_layers}, f"{tag}: K1 by head dim {dims}")
        seen(dims)
        out = counted_forward(torch, counters, lambda: run("causal"), f"{tag} mask=causal", none, total)
        require(torch.isfinite(out[0]).all().item(), f"{tag}: causal output not finite")
        forward_timing(torch, lambda: run(None), LLAMA_BATCH, "sequences", f"{LLAMA_BATCH} x {args.max_seqlen} tokens",
                       f"{tag} mask=None", card, top=6)
        del model, x, out
        torch.cuda.empty_cache()
    return total, by_dim


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
    from uniception_tpu_torch.models.factory.flow import UFMFlow
    from uniception_tpu_torch.models.factory.multiview import MultiViewPointmapModel
    from uniception_tpu_torch.models.utils import config
    from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
    from uniception_tpu_torch.nn import blocks, lora, quant
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

    phase_checkpoints(torch, serve, card)
    bucketed = phase_bucketed(torch, F, np, serve, config, quant, fa, c3, counters, card)
    flow = phase_flow(torch, np, serve, config, counters, card)
    multiview = phase_multiview(torch, np, serve, config, blocks, quant, fa, fused, i8, counters, card)
    served = {k: served[k] + bucketed[k] + flow[k] + multiview[k] for k in counters}

    phase_k3_long(torch, fa, card)
    tc = _train_counters(fa, rope, c3, fused)
    new_train = {}
    config.set_conv3x3_impl("kernel")  # the DPT heads' convs on K7, forward; backward cuDNN's (Conv3x3Function)
    try:
        _tadd(new_train, phase_train_dpt(torch, np, train, serve, training, config, DUSt3R, tc, card))
        _tadd(new_train, phase_train_mixed_ar(torch, np, train, serve, training, config, DUSt3R, tc, card))
        _tadd(new_train, phase_train_flow(torch, np, train, serve, training, config, UFMFlow, tc, card))
    finally:
        config.set_conv3x3_impl("torch")
    _tadd(new_train, phase_train_multiview(torch, np, serve, training, config, fa, MultiViewPointmapModel, tc, card))
    _tadd(new_train, phase_train_lora(torch, np, train, serve, training, config, lora, DUSt3R, tc, card))
    _tadd(new_train, phase_train_fused(torch, np, train, serve, training, config, DUSt3R, tc, card))
    _tadd(new_train, phase_resume(torch, train, training, tc, card))
    print(f"[30 training] launches over phases 24-30's counted steps and entry-point runs: {new_train}")

    dino = phase_dinov2(torch, np, serve, config, blocks, fused, counters, card)
    k1_times(torch, fa, card, DINO_K1_SHAPES, "32 K1", SEED + 32)
    dino_k5_k6_times(torch, F, fused, fa, make_patch_positions, card)
    surgery = phase_dino_surgery(torch, np, serve, config, fa, counters, card)
    dino = {k: dino[k] + surgery[k] for k in counters}
    print(f"[33 dino] launches over phases 31 and 33's counted forwards: {dino}")

    k1_err = max(k1_err, phase_zoo_k1(torch, fa, rope, make_patch_positions, card))
    zoo = phase_zoo(torch, np, serve, config, counters, card)
    print(f"[35 zoo] launches over phase 35's counted forwards: {zoo}")
    heads, k7_518 = phase_heads(torch, F, np, serve, config, c3, counters, card)
    diff, k2_diff = phase_diff(torch, np, serve, config, rope, counters, card, DUSt3R)
    print(f"[37 heads] launches over phases 36-37's counted forwards: heads {heads}, differential {diff}; "
          f"K7 at DPT-Large's refinenet1 RCU (2, 148, 148, 256): {k7_518}; K2 at (2, 1024, 12, 64): {k2_diff}")

    k1_512_err, k1_512 = phase_cosmos_k1(torch, fa, card)
    k1_err = max(k1_err, k1_512_err)
    cosmos = phase_cosmos_tokenizers(torch, F, np, config, fa, c3, counters, card)
    cosmos_enc = phase_cosmos_encoder_and_head(torch, config, counters, card)
    cosmos = {k: cosmos[k] + cosmos_enc[k] for k in counters}
    print(f"[40 cosmos] launches over phases 39-40's counted runs: {cosmos}; K1 at (2, 4096, 1, 512): {k1_512}")

    from uniception_tpu_torch.ops import attention

    hd_worst, hd_times = phase_head_dim_kernels(torch, fa, fused, make_patch_positions, card)
    paths = {k: 0 for k in counters}
    _tadd(new_train, phase_train_example(torch, train, config, fa, tc, card))
    _tadd(new_train, phase_train_vitl_heads(torch, train, serve, training, config, fa, tc, card))
    for got in (phase_zoo_fused(torch, np, serve, config, blocks, fused, counters, card),
                phase_zoo_int8(torch, np, serve, config, attention, fa, counters, card, DUSt3R),
                phase_pe_pool(torch, np, serve, config, fa, counters, card)):
        paths = {k: paths[k] + got[k] for k in counters}
    print(f"[46 head dims] launches over phases 42-46's counted runs: {paths} and training {new_train}; by head dim "
          f"{HD_SEEN}")
    redesign_worst, redesign = phase_redesigned(torch, fa, card)
    # phase 15's int8-linear rung served SERVE_BATCHES + 1 batches after one warm-up: its K4 launches per forward
    transforms = phase_int8_transforms(torch, np, serve, config, quant, i8, counters, card,
                                       rungs["int8-linear"]["launches"]["K4"] / (SERVE_BATCHES + 2))
    print(f"[48 transforms] launches over phase 48's counted runs: {transforms}")
    video = phase_cosmos_video(torch, np, config, fa, c3, counters, card)
    language, language_dims = phase_pe_language(torch, np, config, fa, counters, card)
    new_k1, new_k1_worst = new_k1_times(torch, fa, card, SEED + 49)
    print(f"[50 language] launches over phases 49-50's counted runs: video {video}, language {language} (K1 by head "
          f"dim {language_dims})")

    def entry(name, source, replaces, n, err, m):
        return {"name": name, "route": "cuda", "source": f"uniception_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound"][0], "bound_by": m["bound"][1], "library_ms": m["library_ms"]}

    kernels = [
        entry("flash_attention_fwd", "flash_attention.cu", "uniception_tpu/ops/flash_attention.py:194",
              launches["flash_attention_fwd"] + trained["flash_attention_fwd"] + served["K1"] + new_train["K1"]
              + dino["K1"] + zoo["K1"] + heads["K1"] + diff["K1"] + cosmos["K1"] + paths["K1"] + transforms["K1"]
              + video["K1"] + language["K1"], max(k1_err, hd_worst["K1"], redesign_worst["K1 fp32"], new_k1_worst), k1),
        entry("flash_attention_bwd", "flash_attention_bwd.cu", "uniception_tpu/ops/flash_attention.py:436",
              trained["flash_attention_bwd"] + new_train["K3"], max(k3_err, hd_worst["K3"], redesign_worst["K3"]), k3),
        entry("rope2d", "rope.cu", "uniception_tpu/ops/rope.py:126",
              launches["rope2d"] + trained["rope2d_fwd"] + trained["rope2d_bwd"] + served["K2"] + new_train["K2"]
              + new_train["K2-bwd"] + zoo["K2"] + diff["K2"] + paths["K2"] + transforms["K2"], k2_err, k2),
        entry("int8_matmul_dynamic", "int8_matmul.cu", "uniception_tpu/ops/int8_matmul.py:50",
              served["K4"] + transforms["K4"], k4_err, k4),
        entry("fused_qkv_rope_attention", "fused_attention.cu", "uniception_tpu/ops/fused_attention.py:244",
              fused_path["K5-self"] + multiview["K5-self"] + new_train["K5-self"] + dino["K5-self"] + paths["K5-self"],
              max(k5_err["self"], hd_worst["K5"]), k5["self"]),
        entry("fused_cross_rope_attention", "fused_attention.cu", "uniception_tpu/ops/fused_attention.py:325",
              fused_path["K5-cross"] + new_train["K5-cross"], k5_err["cross"], k5["cross"]),
        entry("flash_attention_int8", "flash_attention_int8.cu", "uniception_tpu/ops/flash_attention.py:130",
              served["K6"] + dino["K6"] + paths["K6"], max(k6_err, hd_worst["K6"]), k6),
        entry("conv3x3_nhwc", "conv3x3.cu", "uniception_tpu/ops/conv3x3.py:47",
              served["K7"] + new_train["K7"] + zoo["K7"] + heads["K7"] + diff["K7"] + cosmos["K7"], k7_err, k7),
        entry("sv_only", "flash_attention.cu", "scripts/sweep_attention.py:75", k8["launches"], k8_err, k8),
    ]
    # the new head dims' shapes (phase 41's timings at the paths' shapes), launches from phases 42-46 at that D
    names = {"K1": ("flash_attention_fwd", "flash_attention.cu", "uniception_tpu/ops/flash_attention.py:194"),
             "K3": ("flash_attention_bwd", "flash_attention_bwd.cu", "uniception_tpu/ops/flash_attention.py:436"),
             "K5": ("fused_qkv_rope_attention", "fused_attention.cu", "uniception_tpu/ops/fused_attention.py:244"),
             "K6": ("flash_attention_int8", "flash_attention_int8.cu", "uniception_tpu/ops/flash_attention.py:130")}
    for kernel, name, B, Nq, Nk, H, D in HD_TIMED:
        fn, source, replaces = names[kernel]
        kernels.append(entry(f"{fn} D={D} ({name}, ({B},{Nq},{Nk},{H},{D}))", source, replaces,
                             HD_SEEN.get(kernel, {}).get(D, 0), hd_worst[kernel], hd_times[kernel][name]))
    # phase 47: K1's fp32 kernel at the training example's fp32 path (D = 16; phase 42's launches at that D, all fp32)
    name, B, Nq, Nk, H, D = K47_K1_F32[4]
    kernels.append(entry(f"flash_attention_fwd fp32 D={D} ({name}, ({B},{Nq},{Nk},{H},{D}))", "flash_attention.cu",
                         "uniception_tpu/ops/flash_attention.py:194", HD_SEEN.get("K1", {}).get(D, 0),
                         redesign_worst["K1 fp32"], redesign["K1 fp32"][name]))
    # phases 49-50: K1 at the video tokenizer's and CLIP's shapes, launches from those phases' runs at that head dim
    for name, B, Nq, Nk, H, D, _ in K1_NEW_SHAPES:
        n = video["K1"] if D == COSMOS_D else language_dims.get(D, 0)
        for dt, rec in new_k1[name].items():
            kernels.append(entry(f"flash_attention_fwd {dt} D={D} ({name}, ({B},{Nq},{Nk},{H},{D}))",
                                 "flash_attention.cu", "uniception_tpu/ops/flash_attention.py:194", n, new_k1_worst,
                                 rec))
    require(all(k["launches"] > 0 for k in kernels), f"a kernel was never launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
