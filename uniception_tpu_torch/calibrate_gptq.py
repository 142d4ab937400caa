"""
GPTQ calibration of the int8 serving trunk (counterpart of scripts/calibrate_gptq.py).

Captures each trunk linear's input Hessian (H = E[x x^T], fp32 with TF32 off)
by running the bf16 model on calibration pairs, then re-rounds every captured
weight with GPTQ (nn/gptq.py) on the symmetric per-output-channel grid that
round-to-nearest uses: serving cost is unchanged, only the int8 codes move.
Saves an npz of ``{path.w_q, path.w_scale}`` in the JAX package's layout (loop
paths, (in, out) codes), which ``serve --gptq``, ``convert_checkpoints --int8
--gptq`` and the JAX package's ``apply_gptq`` all read, and prints the
per-layer weight error in the calibration metric, ||W - Q s||_H, against RTN's.

Weights: ``--sd`` (any checkpoint ``serve --checkpoint`` reads), or ``--cache``
(the ``sd.*`` entries of an oracle ``.npz``, through the same loader). With
neither, the port calibrates its own seeded model (seed 0) and says so; the
JAX script builds the upstream torch model there, which this package does not
import. Inputs: random images from ``RandomState(7)`` (kept disjoint from the
evaluation seed 42), or consecutive frames of ``--image-dir`` (needs PIL).

The forwards run through the kernels (the "kernel" attention implementation:
K1, K2) on a GPU, and through the plain versions on the CPU.

Usage:
    python -m uniception_tpu_torch.calibrate_gptq [--img 512] [--pairs 2] [--out gptq_dust3r.npz]
    python -m uniception_tpu_torch.calibrate_gptq --device cpu --img 32 --pairs 1 \\
        --enc-depth 1 --enc-dim 256 --enc-heads 4 --dec-depth 1 --dec-dim 256 --dec-heads 4 --out tiny.npz

(a tiny model for the CPU whose linears reach the 65,536-parameter floor of
``quantize_trunk`` and of the capture: narrower ones are neither quantized nor
calibrated).
"""

import argparse
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from uniception_tpu_torch.models.encoders.image_normalizations import normalize_image
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn.gptq import gptq_int8, harvest_act_amax, harvest_hessians, install_hessian_capture
from uniception_tpu_torch.nn.quant import quantize_int8, trunk_policy

__all__ = ["calibration_pairs", "capture", "h_error", "gptq_layers", "save_codes", "main"]

CALIB_SEED = 7  # not the evaluation seed 42: calibration and evaluation stay disjoint


def calibration_pairs(img: int, pairs: int, device, image_dir: Optional[str] = None) -> Iterator[tuple]:
    "(img1, img2) (1, 3, img, img) fp32 on ``device``, normalized as forward_pair expects."
    device = torch.device(device)
    if image_dir:
        try:
            from PIL import Image
        except ImportError as e:
            raise SystemExit("--image-dir needs PIL (pip package Pillow), which is not installed here") from e
        files = sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if len(files) < 2:
            raise SystemExit(f"--image-dir needs >= 2 frames, found {len(files)}")
        frames = []
        for f in files[: 2 * pairs]:
            im = np.asarray(Image.open(f).convert("RGB").resize((img, img)), np.float32) / 255.0
            frames.append(normalize_image(np.transpose(im, (2, 0, 1))[None], "dust3r"))
        for i in range(0, len(frames) - 1, 2):
            yield torch.from_numpy(frames[i]).to(device), torch.from_numpy(frames[i + 1]).to(device)
    else:
        rng = np.random.RandomState(CALIB_SEED)
        for _ in range(pairs):
            a = rng.randn(1, 3, img, img).astype(np.float32)
            b = rng.randn(1, 3, img, img).astype(np.float32)
            yield torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


@torch.no_grad()
def capture(model: nn.Module, pairs, policy: str = "all"):
    """Install Hessian captures on the trunk's linears under ``policy`` (the
    layers ``quantize_trunk`` converts), run ``forward_pair`` on each pair and
    harvest. Returns (hessians, amax, pairs run); the linears are unwrapped."""
    enc_pred, dec_pred = trunk_policy(policy)
    n = install_hessian_capture(model.encoder, predicate=enc_pred)
    n += install_hessian_capture(model.info_sharing, predicate=dec_pred)
    count = 0
    try:
        for img1, img2 in pairs:
            model.forward_pair(img1, img2)
            count += 1
    finally:
        amax = harvest_act_amax(model)
        hessians = harvest_hessians(model)
    if len(hessians) != n:
        raise RuntimeError(f"harvested {len(hessians)} Hessians from {n} captures")
    if n == 0:
        raise SystemExit(f"no trunk linear under policy {policy!r} has the 65,536 parameters quantize_trunk needs")
    return hessians, amax, count


def _trunk_linears(model: nn.Module, paths) -> Dict[str, nn.Linear]:
    "The float linears of ``model`` at the dotted ``paths`` (raises if any is missing)."
    found = {p: m for p, m in model.named_modules() if p in paths and isinstance(m, nn.Linear)}
    if set(found) != set(paths):
        raise KeyError(f"linears not found: {sorted(set(paths) - set(found))[:8]}")
    return found


def h_error(w: torch.Tensor, q: torch.Tensor, s: torch.Tensor, H: torch.Tensor) -> float:
    "sqrt(tr(E^T H E)) with E = w - q s, all (in, out) / (in, in) in H's dtype: the calibration metric."
    E = w.to(H.dtype) - q.to(H.dtype) * s.to(H.dtype)
    return float(torch.sqrt(torch.clamp((H @ E * E).sum(), min=0.0)))


def gptq_layers(model: nn.Module, hessians: Dict[str, torch.Tensor], *, blocksize: int = 128, percdamp: float = 0.01,
                dtype: torch.dtype = torch.float32, diag_every: int = 10, log=print):
    """GPTQ on every captured layer of ``model``, in sorted path order, on each
    weight's device. Returns (codes {path: (w_q (in, out), w_scale (1, out))},
    {path: H-metric error ratio gptq / rtn} for every ``diag_every``-th layer)."""
    linears = _trunk_linears(model, hessians)
    codes, ratios = {}, {}
    t0 = time.time()
    for i, (p, lin) in enumerate(sorted(linears.items())):
        w = lin.weight.detach().t()  # (in, out)
        H = hessians[p].to(w.device, dtype)
        w_q, w_s = gptq_int8(w, H, blocksize=blocksize, percdamp=percdamp, dtype=dtype)
        codes[p] = (w_q, w_s)
        if diag_every and i % diag_every == 0:
            r_q, r_s = quantize_int8(w.float(), axis=0)
            wf = w.to(dtype)
            ratios[p] = h_error(wf, w_q, w_s, H) / max(h_error(wf, r_q, r_s, H), 1e-30)
            log(f"  [{i + 1}/{len(linears)}] {p}: H-err gptq/rtn = {ratios[p]:.3f} ({time.time() - t0:.0f}s)")
    return codes, ratios


def save_codes(path: str, codes: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
    "Write ``codes`` as the npz that ``nn.gptq.load_gptq_npz`` (either package) reads."
    out = {}
    for p, (w_q, w_s) in codes.items():
        out[f"{p}.w_q"] = w_q.cpu().numpy()
        out[f"{p}.w_scale"] = w_s.cpu().numpy()
    np.savez(path, **out)


def _model(args, device) -> nn.Module:
    "The bf16 calibration model: --sd, the --cache oracle's sd.* entries, or the port's seeded model."
    from uniception_tpu_torch import serve
    from uniception_tpu_torch.utils.coldstart import abstract_construct, materialize

    size = (args.img, args.img)
    dims = (args.enc_depth, args.enc_dim, args.enc_heads, args.dec_depth, args.dec_dim, args.dec_heads)
    head = "dpt" if args.model == "flow" else "linear"
    if args.sd:
        model = serve.build_model(args.img, *dims, device=device, head=head, model=args.model, checkpoint=args.sd)
        if model.quant_spec is not None:
            raise SystemExit(f"{args.sd} is quantized: calibrate on a float checkpoint")
        print(f"weights from {args.sd}")
        return model
    if args.cache:
        data = np.load(args.cache)
        sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
        model = abstract_construct(lambda: serve.make_model(args.model, size, dims, dtype=torch.bfloat16, head=head,
                                                            head_dtype=None, landscape_only=False))
        materialize(model, state_dict=sd, ignore=model.checkpoint_alias_patterns(), device=device)
        print(f"weights from the oracle cache {args.cache}")
        return model.eval()
    print("no --sd or --cache: calibrating the port's own seeded model (seed 0), not the upstream torch model")
    return serve.build_model(args.img, *dims, device=device, head=head, model=args.model, seed=0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="dust3r", choices=["dust3r", "flow"],
                   help="the composed model to calibrate (both have encoder + info_sharing trunks)")
    p.add_argument("--img", type=int, default=512)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--cache", default=None, help="oracle .npz whose sd.* entries are the weights")
    p.add_argument("--sd", default=None, help="checkpoint (.pth/.pt/.bin, .npz, .nsv) instead of seeded weights")
    p.add_argument("--out", default="gptq_dust3r.npz")
    p.add_argument("--policy", default="all", help="trunk policy of the captured layers (nn/quant.py trunk_policy)")
    p.add_argument("--blocksize", type=int, default=128)
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--image-dir", default=None,
                   help="directory of frames (.png/.jpg), consecutive frames paired (needs PIL); default: random "
                        "images from RandomState(7)")
    p.add_argument("--dtype", default="f32", choices=["f32", "f64"], help="GPTQ's factorization dtype")
    p.add_argument("--diag-every", type=int, default=10,
                   help="compute the H-metric gptq/rtn diagnostic on every Nth layer")
    p.add_argument("--enc-depth", type=int, default=24)
    p.add_argument("--enc-dim", type=int, default=1024)
    p.add_argument("--enc-heads", type=int, default=16)
    p.add_argument("--dec-depth", type=int, default=12)
    p.add_argument("--dec-dim", type=int, default=768)
    p.add_argument("--dec-heads", type=int, default=12)
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to calibrate on the CPU")
    model = _model(args, device)
    prev = config.get_attention_impl()
    config.set_attention_impl("kernel" if device.type == "cuda" else "naive")
    try:
        t0 = time.time()
        hessians, _, n_pairs = capture(model, calibration_pairs(args.img, args.pairs, device, args.image_dir),
                                       args.policy)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"captured Hessians of {len(hessians)} trunk linears (policy={args.policy}) over {n_pairs} pairs in "
              f"{time.time() - t0:.1f}s")
    finally:
        config.set_attention_impl(prev)
    t0 = time.time()
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    codes, ratios = gptq_layers(model, hessians, blocksize=args.blocksize, percdamp=args.percdamp, dtype=dtype,
                                diag_every=args.diag_every)
    save_codes(args.out, codes)
    values = list(ratios.values())
    print(f"GPTQ done: {len(codes)} layers -> {args.out} in {time.time() - t0:.1f}s; H-metric error ratio gptq/rtn "
          f"(sampled every {args.diag_every}) median {np.median(values):.3f} worst {max(values):.3f}")
    return {"layers": len(codes), "out": args.out, "ratios": ratios}


if __name__ == "__main__":
    main()
