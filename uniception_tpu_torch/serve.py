"""
Two-view DUSt3R serving loop: the plain (non-bucketed, no-artifact) path of
examples/serve_dust3r.py, in PyTorch.

    uint8 frames (B, H, W, 3)
      -> device (pinned host staging, non_blocking copy; uint8 = 4x fewer bytes than fp32)
      -> float / 255, then (x - mean) / std with the dust3r norm, on the device
      -> DUSt3R.forward_pair (bf16 trunk through the CUDA kernels; linear or DPT heads)

Weights are random, from a fixed seed (no checkpoint loading yet); the trunk
runs in bfloat16. ``--int8`` quantizes the trunk's linears to int8 after the
bf16 cast (nn/quant.py), as bench.py does. The full int8-DPT rung is reached
from Python only: the int8 attention and the 3x3 conv kernel are chosen with
``config.set_attention_quant`` and ``config.set_conv3x3_impl`` and the heads'
dtype with ``build_model``'s ``head_dtype``; the command line serves fp32
heads with the bf16 attention kernel.

Usage:
    python -m uniception_tpu_torch.serve --img-size 512 --batch 2 --pairs 8
    python -m uniception_tpu_torch.serve --head dpt --int8
    python -m uniception_tpu_torch.serve --device cpu --img-size 32 \\
        --enc-depth 2 --enc-dim 64 --enc-heads 4 --dec-depth 2 --dec-dim 48 --dec-heads 4
"""

import argparse
import time
from typing import Optional

import numpy as np
import torch

from uniception_tpu_torch.models.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.nn.quant import quantize_trunk

__all__ = ["build_model", "make_frame_normalizer", "make_serving_fn", "serve_frames", "main"]


def build_model(
    img_size: int,
    enc_depth: int = 24,
    enc_dim: int = 1024,
    enc_heads: int = 16,
    dec_depth: int = 12,
    dec_dim: int = 768,
    dec_heads: int = 12,
    *,
    device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    head: str = "linear",
    head_dtype: Optional[torch.dtype] = None,
    int8: bool = False,
    int8_policy: str = "all",
    int8_asym: str = "none",
) -> DUSt3R:
    """The serving DUSt3R (ManyAR patch embed, ``head`` "linear" or "dpt") with weights drawn from ``seed``.

    The trunk's parameters are cast to ``dtype``; ``head_dtype`` (None: fp32)
    is the heads' compute and parameter dtype. With ``int8`` the trunk's
    linears under ``int8_policy`` are then quantized to int8, those under
    ``int8_asym`` with zero-point activations (nn/quant.py trunk_policy).
    """
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    model = DUSt3R(
        name=f"dust3r_serve_{head}",
        img_size=(img_size, img_size),
        patch_embed_cls="ManyAR_PatchEmbed",
        pred_head_type=head,
        head_dtype=head_dtype,
        enc_embed_dim=enc_dim,
        enc_depth=enc_depth,
        enc_num_heads=enc_heads,
        info_sharing_dim=dec_dim,
        info_sharing_depth=dec_depth,
        info_sharing_num_heads=dec_heads,
        dtype=dtype,
        param_dtype=dtype,  # serving casts the trunk's parameters themselves
        device=device,
        generator=generator,
    )
    if head_dtype is not None:
        for module in model.heads():  # serving casts the heads' parameters too
            module.to(head_dtype)
    if int8:
        quantize_trunk(model, int8_policy, asym=int8_asym)
    return model.eval()


def make_frame_normalizer(data_norm_type: str, device):
    """Return ``prep(frames_u8) -> (B, 3, H, W) fp32`` on ``device``: uint8
    (B, H, W, 3) frames (arrays or CPU tensors) staged through pinned memory
    on CUDA, then ``(x / 255 - mean) / std`` on the device."""
    device = torch.device(device)
    norm = IMAGE_NORMALIZATION_DICT[data_norm_type]
    mean = torch.tensor(norm.mean, dtype=torch.float32, device=device).view(1, 3, 1, 1)
    std = torch.tensor(norm.std, dtype=torch.float32, device=device).view(1, 3, 1, 1)

    def prep(frames_u8):
        x = torch.as_tensor(frames_u8)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"want uint8 (B, H, W, 3) frames, got {x.dtype} {tuple(x.shape)}")
        if device.type == "cuda":
            x = x.pin_memory()
        x = x.to(device, non_blocking=True)
        return (x.permute(0, 3, 1, 2).float() / 255.0 - mean) / std

    return prep


def make_serving_fn(model: DUSt3R, device):
    """Return ``serve(img1_u8, img2_u8) -> (pts3d, conf, pts3d_in_other_view, conf2)``.

    The inputs are uint8 (B, H, W, 3) arrays or CPU tensors; the outputs are
    BHWC fp32 tensors on ``device``.
    """
    device = torch.device(device)
    prep = make_frame_normalizer(model.data_norm_type, device)

    @torch.inference_mode()
    def serve(img1_u8, img2_u8):
        img1, img2 = prep(img1_u8), prep(img2_u8)
        B, _, H, W = img1.shape
        true_shape = torch.tensor([H, W], dtype=torch.int32, device=device).expand(B, 2)
        res1, res2 = model.forward_pair(img1, img2, true_shape1=true_shape, true_shape2=true_shape)
        return res1["pts3d"], res1["conf"], res2["pts3d_in_other_view"], res2["conf"]

    return serve


def serve_frames(serve, frames: np.ndarray, batch: int, device):
    """Serve consecutive frame pairs of ``frames`` in batches of ``batch`` pairs.

    One warm-up batch runs first and is not timed. Returns (last outputs,
    pairs served in the timed run, seconds). On CUDA the time comes from CUDA
    events around the timed run.
    """
    device = torch.device(device)
    n_pairs = len(frames) // 2
    batches = [
        (frames[2 * i : 2 * (i + batch) : 2], frames[2 * i + 1 : 2 * (i + batch) : 2])
        for i in range(0, n_pairs - n_pairs % batch, batch)
    ]
    if not batches:
        raise ValueError(f"need at least {2 * batch} frames for one batch of {batch} pairs")
    out = serve(*batches[0])  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for img1, img2 in batches:
            out = serve(img1, img2)
        stop.record()
        torch.cuda.synchronize(device)
        seconds = start.elapsed_time(stop) / 1e3
    else:
        t0 = time.perf_counter()
        for img1, img2 in batches:
            out = serve(img1, img2)
        seconds = time.perf_counter() - t0
    return out, len(batches) * batch, seconds


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch", type=int, default=2, help="pairs per batch")
    p.add_argument("--pairs", type=int, default=8, help="total pairs to serve")
    p.add_argument("--enc-depth", type=int, default=24)
    p.add_argument("--enc-dim", type=int, default=1024)
    p.add_argument("--enc-heads", type=int, default=16)
    p.add_argument("--dec-depth", type=int, default=12)
    p.add_argument("--dec-dim", type=int, default=768)
    p.add_argument("--dec-heads", type=int, default=12)
    p.add_argument("--head", default="linear", choices=["linear", "dpt"])
    p.add_argument("--int8", action="store_true",
                   help="w8a8-quantize the trunk linears (bench.py's default); the heads stay fp32 and the attention "
                        "bf16: int8 attention, bf16 heads and the conv kernel are set from Python (see the module doc)")
    p.add_argument("--int8-policy", default="all", help="(--int8) mixed-precision trunk policy (nn/quant.py trunk_policy)")
    p.add_argument("--int8-asym", default="none", help="(--int8) which quantized layers use zero-point activations")
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to serve on the CPU")
    model = build_model(
        args.img_size, args.enc_depth, args.enc_dim, args.enc_heads, args.dec_depth, args.dec_dim, args.dec_heads,
        device=device, head=args.head, int8=args.int8, int8_policy=args.int8_policy, int8_asym=args.int8_asym,
    )
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, size=(2 * args.pairs, args.img_size, args.img_size, 3), dtype=np.uint8)
    out, pairs, seconds = serve_frames(make_serving_fn(model, device), frames, args.batch, device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{pairs} pairs in {seconds:.3f}s = {pairs / seconds:.2f} pairs/s on {where} (after one warm-up batch)")
    print("pts3d:", tuple(out[0].shape), "conf:", tuple(out[1].shape))
    return out


if __name__ == "__main__":
    main()
