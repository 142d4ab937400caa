"""
Times K4 (the int8 matmul) at the nine trunk shapes, K5 (the fused qkv +
RoPE + attention, self and cross) at its three main-path shapes, K1 (the
flash-attention forward) and K8 (the S.V diagnostic) at K8's five shapes, and
K3 (the backward) and K6 (the int8 attention, both modes, and its prep alone)
at the encoder's (4, 1024, 16, 64), K1's fp32 kernel at chip_smoke.py's
K47_K1_F32 shapes (``k1_f32``), K3 above D = 64 at its K47_K3 shapes
(``k3_wide``), K1's wide bf16 kernel at its K47_K1_WIDE shapes (``k1_wide``)
and K3's fp32 kernels at its K47_K3_F32 shapes (``k3_f32``) on the card, by
CUDA-graph replay, with the kernel package imported from ``--root``: this
checkout or an unpacked earlier commit, so that two trees are compared on
one card in one call (run them in turns: a, b, b, a). ``--only`` names the
groups to time (all by default). The shapes, inputs and timer are
``chip_smoke.py``'s. Prints the card's name and power limit, then one JSON
object of milliseconds per call.

    python3 uniception_tpu_torch/utils/kernel_times.py [--root DIR] [--only k1_wide,k3_f32]
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GROUPS = ("k4", "k5", "k1", "k8", "k3", "k6", "k1_f32", "k3_wide", "k1_wide", "k3_f32")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO, help="the checkout whose uniception_tpu_torch is timed")
    parser.add_argument("--only", default=",".join(GROUPS), help=f"comma-separated groups of {GROUPS}")
    args = parser.parse_args()
    root, only = os.path.abspath(args.root), set(args.only.split(","))
    if not only <= set(GROUPS):
        parser.error(f"--only: unknown groups {sorted(only - set(GROUPS))}")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
    from uniception_tpu_torch.ops import flash_attention as fa
    from uniception_tpu_torch.ops import fused_attention as fused
    from uniception_tpu_torch.ops import int8_matmul as i8
    from uniception_tpu_torch.ops import sv_only as sv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    out = {"root": os.path.relpath(root, REPO), **{g: {} for g in GROUPS if g in only}}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    for name, M, K, N in cs.K4_SHAPES if "k4" in only else ():
        x = torch.randn(M, K, device="cuda", generator=gen).bfloat16()
        w_q = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8).t()
        w_scale = torch.rand(1, N, device="cuda", generator=gen) * 1e-3 + 1e-5
        bias = torch.randn(N, device="cuda", generator=gen)
        out["k4"][name] = cs.graph_ms(torch, lambda: i8.int8_matmul_dynamic(x, w_q, w_scale, bias))
    for name, B, Nq, Nk, C, H, qgrid, kgrid in cs.K5_CASES[:3] if "k5" in only else ():
        case = cs.K5Case(torch, fused, make_patch_positions, gen, B, Nq, Nk, C, H, qgrid, kgrid)
        args = case.args(torch.bfloat16, True)
        out["k5"][name] = cs.graph_ms(torch, lambda: case.kernel(*args))
    for name, B, Nq, Nk, H in cs.K8_CASES if only & {"k1", "k8"} else ():
        q = torch.randn(B, Nq, H, 64, device="cuda", generator=gen).bfloat16()
        k, v = (torch.randn(B, Nk, H, 64, device="cuda", generator=gen).bfloat16() for _ in range(2))
        if "k1" in only:
            out["k1"][name] = cs.graph_ms(torch, lambda: fa.flash_attention(q, k, v))
        if "k8" in only:
            out["k8"][name] = cs.graph_ms(torch, lambda: sv.sv_only(q, k, v))
    q, k, v, dout = (torch.randn(4, 1024, 16, 64, device="cuda", generator=gen).bfloat16() for _ in range(4))
    if "k3" in only:
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        out["k3"]["encoder 512"] = cs.graph_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout))
    for mode in ("int8", "int8pv") if "k6" in only else ():
        out["k6"][f"encoder 512 {mode}"] = cs.graph_ms(torch, lambda: fa.flash_attention_int8(q, k, v, mode=mode))
        out["k6"][f"encoder 512 {mode} prep"] = cs.graph_ms(torch, lambda: fa.flash_attention_int8_prep(k, v, mode))
    for name, B, Nq, Nk, H, D in cs.K47_K1_F32 if "k1_f32" in only else ():
        q, k, v = cs._hd_qkv(torch, gen, B, Nq, Nk, H, D, torch.float32)
        out["k1_f32"][name] = cs.graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v))
    for name, B, Nq, Nk, H, D in cs.K47_K1_WIDE if "k1_wide" in only else ():
        q, k, v = cs._hd_qkv(torch, gen, B, Nq, Nk, H, D, torch.bfloat16)
        out["k1_wide"][name] = cs.graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v))
    for group, shapes, dt in (("k3_wide", cs.K47_K3, torch.bfloat16), ("k3_f32", cs.K47_K3_F32, torch.float32)):
        for name, B, Nq, Nk, H, D in shapes if group in only else ():
            q, k, v = cs._hd_qkv(torch, gen, B, Nq, Nk, H, D, dt)
            dout = torch.randn(B, Nq, H, D, device="cuda", generator=gen).to(dt)
            o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
            out[group][name] = cs.graph_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
