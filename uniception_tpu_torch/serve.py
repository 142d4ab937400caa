"""
Two-view serving (counterpart of examples/serve_dust3r.py): DUSt3R (pointmaps)
or the UFM-style flow model (``UFMFlow``), from seeded random weights or a
checkpoint, on square frames or on arbitrary-size pairs through aspect buckets.

    uint8 frames (B, H, W, 3)
      -> device (pinned host staging, non_blocking copy; uint8 = 4x fewer bytes than fp32)
      -> float / 255, then (x - mean) / std with the dust3r norm, on the device
      -> forward_pair (bf16 trunk through the CUDA kernels; linear or DPT heads)

Checkpoints (``--checkpoint``): a torch-layout ``.pth``/``.pt``/``.bin`` or
``.npz`` (utils/checkpoint.py), or a native serving checkpoint (``.nsv``, or
an ``.npz`` written by ``convert_checkpoints --serving``; utils/coldstart.py)
in the JAX package's loop or scan layout. The model is built on the ``meta``
device and filled with one copy per dtype; a checkpoint quantized offline
(meta ``quant``, ``quant_policy``, ``quant_asym``) is served int8.

``--buckets``: pairs of any size are resized into the DUSt3R-512 aspect
family (scaled to ``--img-size``; for the flow model with portrait canvases
added) by ``data.bucketing.PairBucketedBatcher``; every bucket is warmed
once, then the pair stream is served through ``data.pipeline.prefetch_to_device``.
DUSt3R serves buckets with ``landscape_only``: portrait views ride the ManyAR
canvas and come back transposed (``extract_view`` unpacks them).

``--int8`` quantizes the trunk's linears after the bf16 cast (nn/quant.py).
``--attn``, ``--attn-quant``, ``--conv3x3`` and ``--gelu`` set the kernel
selection (models/utils/config.py) over what the environment variables
``UNICEPTION_TPU_ATTN``, ``_ATTN_QUANT``, ``_CONV3X3`` and ``_GELU`` chose at
import; the heads' dtype is ``build_model``'s ``head_dtype`` (fp32 from the
command line). ``--gptq PATH`` overwrites the int8 trunk's codes with
calibrated GPTQ codes (``python -m uniception_tpu_torch.calibrate_gptq``, or
the JAX package's ``scripts/calibrate_gptq.py``: the npz crosses unchanged);
it needs an int8 model (``--int8`` or a quantized checkpoint). Not ported from
the JAX example: its XLA compile cache and AOT artifacts (``--compile-cache``,
``--save-artifact``, ``--artifact``) and ``--no-scan`` (the port runs the
loop layout and reads both).

Usage:
    python -m uniception_tpu_torch.serve --img-size 512 --batch 2 --pairs 8
    python -m uniception_tpu_torch.serve --head dpt --int8
    python -m uniception_tpu_torch.serve --int8 --gptq gptq_dust3r.npz
    python -m uniception_tpu_torch.serve --model flow --head dpt --buckets --pairs 10
    python -m uniception_tpu_torch.serve --checkpoint dust3r.nsv --buckets
    python -m uniception_tpu_torch.serve --device cpu --img-size 32 \\
        --enc-depth 2 --enc-dim 64 --enc-heads 4 --dec-depth 2 --dec-dim 48 --dec-heads 4
"""

import argparse
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from uniception_tpu_torch.data.bucketing import (
    DUST3R_512_BUCKETS,
    PairBucketedBatcher,
    extract_view,
    with_portrait_buckets,
)
from uniception_tpu_torch.data.pipeline import make_frame_normalizer, prefetch_to_device
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.factory.flow import UFMFlow
from uniception_tpu_torch.models.factory.multiview import MultiViewPointmapModel
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn.gptq import apply_gptq, load_gptq_npz
from uniception_tpu_torch.nn.quant import quantize_linears, quantize_trunk
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.coldstart import (
    abstract_construct,
    is_native_state,
    load_native_state,
    materialize,
    stored_int8_layers,
)

__all__ = [
    "make_model",
    "build_model",
    "make_frame_normalizer",
    "make_serving_fn",
    "serve_frames",
    "scaled_buckets",
    "synthetic_pairs",
    "serve_bucketed",
    "main",
]


_GPTQ_NEEDS_INT8 = "--gptq requires an int8-quantized model (--int8 or a quantized checkpoint)"


def make_model(model: str, img_size, dims, *, dtype, head, head_dtype, landscape_only, device=None, generator=None,
               num_views: int = 4, attention_type: str = "alternating"):
    """The serving model's constructor (shared by the seeded and the checkpoint paths and the converter).
    ``num_views`` and ``attention_type`` configure the multi-view model only."""
    enc_depth, enc_dim, enc_heads, dec_depth, dec_dim, dec_heads = dims
    common = dict(
        img_size=img_size,
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
    if model == "multiview":  # the JAX factory's one configuration: PatchEmbedDust3R, one fp32 linear head
        if head != "linear" or head_dtype is not None or landscape_only:
            raise ValueError("the multi-view model has one fp32 linear head and no landscape_only: "
                             f"got head={head!r}, head_dtype={head_dtype}, landscape_only={landscape_only}")
        return MultiViewPointmapModel(name=f"mv_serve_{attention_type}", num_views=num_views,
                                      attention_type=attention_type, **common)
    common.update(pred_head_type=head, head_dtype=head_dtype)
    if model == "flow":  # no ManyAR: flow buckets carry the orientation in the canvas itself
        m = UFMFlow(name="ufm_flow_serve", **common)
    elif model == "dust3r":
        m = DUSt3R(name=f"dust3r_serve_{head}", patch_embed_cls="ManyAR_PatchEmbed", landscape_only=landscape_only,
                   **common)
    else:
        raise ValueError(f"unknown model {model!r}: 'dust3r', 'flow' or 'multiview'")
    if head_dtype is not None:
        for module in m.heads():  # serving casts the heads' parameters too
            module.to(head_dtype)
    return m


def build_model(
    img_size=512,
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
    model: str = "dust3r",
    checkpoint: Optional[str] = None,
    landscape_only: bool = False,
    num_views: int = 4,
    attention_type: str = "alternating",
    gptq: Optional[str] = None,
) -> nn.Module:
    """The serving model: ``model`` "dust3r" (ManyAR patch embed), "flow"
    (``UFMFlow``) or "multiview" (``MultiViewPointmapModel`` over ``num_views``
    frames with ``attention_type`` "alternating" or "global" info sharing;
    ``head`` "linear" only, fp32); ``head`` "linear" or "dpt"; ``img_size`` an
    int (square) or (h, w), which sets the flow adaptor's base shape.

    Weights: drawn from ``seed``, or with ``checkpoint`` read from it (built on
    the meta device, one host-to-device copy per dtype). The trunk's
    parameters are cast to ``dtype``; ``head_dtype`` (None: fp32) is the
    heads' compute and parameter dtype. With ``int8`` the trunk's linears
    under ``int8_policy`` are then quantized to int8, those under
    ``int8_asym`` with zero-point activations (nn/quant.py trunk_policy); a
    native checkpoint quantized offline is served int8 as its meta says.
    ``gptq`` names an npz of calibrated codes (nn/gptq.py load_gptq_npz) that
    then overwrite the quantized layers' codes; it needs an int8 model and
    raises SystemExit, before any model is built where it can tell, without
    one. The returned module's ``quant_spec`` is (policy, asym), or None when
    not quantized.
    """
    if gptq and not int8 and (checkpoint is None or not is_native_state(checkpoint)):
        raise SystemExit(_GPTQ_NEEDS_INT8)
    device = torch.device(device)
    size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
    dims = (enc_depth, enc_dim, enc_heads, dec_depth, dec_dim, dec_heads)
    kw = dict(dtype=dtype, head=head, head_dtype=head_dtype, landscape_only=landscape_only, num_views=num_views,
              attention_type=attention_type)
    quant_spec = (int8_policy, int8_asym) if int8 else None
    if checkpoint is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        m = make_model(model, size, dims, device=device, generator=generator, **kw)
        if int8:
            quantize_trunk(m, int8_policy, asym=int8_asym)
    elif is_native_state(checkpoint):
        arrays, meta = load_native_state(checkpoint)
        pre_quantized = meta.get("quant") is not None
        if gptq and not (int8 or pre_quantized):
            raise SystemExit(_GPTQ_NEEDS_INT8)
        if pre_quantized:
            quant_spec = (meta.get("quant_policy", "all"), meta.get("quant_asym", "none"))
            if not int8:
                print(f"checkpoint is {meta['quant']}-quantized; serving int8")

        def ctor():
            built = make_model(model, size, dims, **kw)
            if pre_quantized:  # the module tree the stored arrays hold: which linears are Int8Linear, with w_colsum
                q, zero_point = stored_int8_layers(built, arrays)
                for part in ("encoder", "info_sharing"):
                    quantize_linears(getattr(built, part), min_params=0, predicate=lambda p, _, s=part: f"{s}.{p}" in q,
                                     asym=lambda p, _, s=part: f"{s}.{p}" in zero_point)
            return built

        m = materialize(abstract_construct(ctor), arrays=arrays, device=device)
        if int8 and not pre_quantized:
            quantize_trunk(m, int8_policy, asym=int8_asym)
    else:
        ckpt = load_checkpoint(checkpoint)
        m = abstract_construct(lambda: make_model(model, size, dims, **kw))
        materialize(m, state_dict=ckpt["model"], ignore=m.checkpoint_alias_patterns(), device=device)
        if int8:
            quantize_trunk(m, int8_policy, asym=int8_asym)
    if gptq:
        n_g = apply_gptq(m, load_gptq_npz(gptq))
        print(f"GPTQ codes applied to {n_g} layers from {gptq}")
    m.quant_spec = quant_spec
    return m.eval()


def make_serving_fn(model: nn.Module, device):
    """Return ``serve(img1_u8, img2_u8, true_shape1=None, true_shape2=None)``.

    The images are uint8 (B, H, W, 3) arrays or tensors; the true shapes
    (B, 2) (h, w), default the canvas (give them on the CPU: DUSt3R then
    needs no device sync to see whether a row is portrait). DUSt3R returns
    (pts3d, conf, pts3d_in_other_view, conf2), UFMFlow (flow, flow_conf): BHWC
    fp32 tensors on ``device``.
    """
    device = torch.device(device)
    prep = make_frame_normalizer(model.data_norm_type, device)

    @torch.inference_mode()
    def serve(img1_u8, img2_u8, true_shape1=None, true_shape2=None):
        img1, img2 = prep(img1_u8), prep(img2_u8)
        if isinstance(model, UFMFlow):
            res = model.forward_pair(img1, img2)
            return res["flow"], res["flow_conf"]
        B, _, H, W = img1.shape
        canvas = torch.tensor([H, W], dtype=torch.int32).expand(B, 2)
        ts1 = canvas if true_shape1 is None else torch.as_tensor(true_shape1)
        ts2 = canvas if true_shape2 is None else torch.as_tensor(true_shape2)
        res1, res2 = model.forward_pair(img1, img2, true_shape1=ts1, true_shape2=ts2)
        return res1["pts3d"], res1["conf"], res2["pts3d_in_other_view"], res2["conf"]

    return serve


def _timed(device):
    "Start a wall-clock timer; the returned stop() synchronizes ``device`` first."
    device = torch.device(device)
    t0 = time.perf_counter()

    def stop():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    return stop


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


def scaled_buckets(img_size: int, patch: int = 16, portrait: bool = False) -> Tuple[Tuple[int, int], ...]:
    """The DUSt3R-512 aspect family scaled to ``img_size``, snapped to
    multiples of the patch with at least two patches per side (JAX
    ``_scaled_buckets``); ``portrait`` adds each canvas's transpose (flow)."""
    if img_size == 512:
        out = DUST3R_512_BUCKETS
    else:
        lo, s, buckets = 2 * patch, img_size / 512.0, []
        for h, w in DUST3R_512_BUCKETS:
            hw = (max(lo, int(round(h * s / patch)) * patch), max(lo, int(round(w * s / patch)) * patch))
            if hw[0] <= hw[1] and hw not in buckets:  # landscape canvases only
                buckets.append(hw)
        out = tuple(buckets)
    return with_portrait_buckets(out) if portrait else out


def synthetic_pairs(n_pairs: int, img_size: int, seed: int = 0) -> Iterator[tuple]:
    """JAX ``_bucket_loop``'s synthetic request stream: (key, img1, img2) HWC
    uint8 with aspect ratios 1.33/1.52/1.78/2.0/3.2 in turn, heights from
    img_size / 2 to 2 * img_size - 1, every third request portrait and every
    fourth with a second view transposed."""
    rng = np.random.RandomState(seed)
    for i in range(n_pairs):
        ar = [1.33, 1.52, 1.78, 2.0, 3.2][i % 5]
        h = rng.randint(img_size // 2, 2 * img_size)
        w = int(h * ar)
        if i % 3 == 2:  # every third request is portrait
            h, w = w, h
        img1 = rng.randint(0, 256, (h, w, 3), np.uint8)
        img2 = rng.randint(0, 256, (h, w, 3), np.uint8) if i % 4 else np.swapaxes(
            rng.randint(0, 256, (w, h, 3), np.uint8), 0, 1
        )
        yield i, img1, img2


def _image_files(image_dir: str):
    return sorted(
        os.path.join(image_dir, f) for f in os.listdir(image_dir) if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )


def _open_rgb(path: str, size: Optional[int] = None) -> np.ndarray:
    "An image file as HWC uint8 RGB (resized to size x size when given), through PIL."
    try:
        from PIL import Image
    except ImportError as e:  # the card's machine has no PIL
        raise SystemExit("--image-dir needs PIL (pip package Pillow), which is not installed here") from e
    im = Image.open(path).convert("RGB")
    if size is not None:
        im = im.resize((size, size), Image.BICUBIC)
    return np.asarray(im)


def image_dir_pairs(image_dir: str) -> Iterator[tuple]:
    "(key, img1, img2) of consecutive frames of a directory, at their native sizes (needs PIL)."
    files = _image_files(image_dir)
    for i in range(len(files) // 2):
        yield i, _open_rgb(files[2 * i]), _open_rgb(files[2 * i + 1])


def serve_bucketed(model: nn.Module, device, pairs, batch: int, buckets):
    """Serve a stream of (key, img1, img2) HWC uint8 pairs of any size through
    aspect buckets: each bucket warmed once, then every pair resized into its
    bucket by PairBucketedBatcher (ManyAR for DUSt3R, portrait canvases for
    the flow model), staged by prefetch_to_device and served.

    Returns a dict: ``pairs`` (real rows served; flush padding not counted),
    ``seconds`` (wall clock from the first request to the last result, host
    resizing included), ``per_bucket`` {(h, w): pairs}, ``batches`` [(h, w),
    ...] in serving order, ``warm_seconds``, and ``last`` = (outputs,
    true_shape2 numpy, meta) of the last batch.
    """
    device = torch.device(device)
    serve = make_serving_fn(model, device)
    flow = isinstance(model, UFMFlow)

    def run(hw, c1, c2, t1, t2):
        if flow:  # the JAX server builds each bucket's model with img_size = the bucket: the adaptor's base shape
            model.adaptor.value_adaptor.base_shape = list(hw)
        return serve(c1, c2, t1, t2)

    stop = _timed(device)
    for hw in buckets:
        z = np.zeros((batch, hw[0], hw[1], 3), np.uint8)
        ts = torch.tensor(hw, dtype=torch.int32).expand(batch, 2)
        run(hw, z, z, ts, ts)
    warm_seconds = stop()

    batcher = PairBucketedBatcher(batch, buckets, manyar=not flow)

    def emitted():
        for key, img1, img2 in pairs:
            for hw, c1, c2, t1, t2, meta in batcher.add(img1, img2, key=key):
                yield {"img1": c1, "img2": c2, "rest": (hw, t1, t2, meta)}
        for hw, c1, c2, t1, t2, meta in batcher.flush():
            yield {"img1": c1, "img2": c2, "rest": (hw, t1, t2, meta)}

    stats = {"pairs": 0, "per_bucket": {}, "batches": [], "warm_seconds": warm_seconds, "last": None}
    stop = _timed(device)
    for b in prefetch_to_device(emitted(), device):
        hw, t1, t2, meta = b["rest"]
        out = run(hw, b["img1"], b["img2"], torch.from_numpy(t1), torch.from_numpy(t2))
        stats["pairs"] += meta["n_valid"]
        stats["per_bucket"][hw] = stats["per_bucket"].get(hw, 0) + meta["n_valid"]
        stats["batches"].append(hw)
        stats["last"] = (out, t2, meta)
    stats["seconds"] = stop()
    return stats


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="dust3r", choices=["dust3r", "flow"],
                   help="dust3r (two-view pointmaps) or flow (UFMFlow: dense flow + confidence)")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch", type=int, default=2, help="pairs per batch")
    p.add_argument("--pairs", type=int, default=8, help="total pairs to serve")
    p.add_argument("--checkpoint", default=None,
                   help=".pth/.pt/.bin or .npz (torch layout), or a native serving checkpoint (.nsv, or an .npz "
                        "from convert_checkpoints --serving), loop or scan layout; default: seeded random weights")
    p.add_argument("--image-dir", default=None,
                   help="directory of frames, consecutive frames paired (needs PIL); default: synthetic frames")
    p.add_argument("--buckets", action="store_true",
                   help="serve arbitrary-size pairs through aspect buckets (data/bucketing.py), the DUSt3R-512 "
                        "family scaled to --img-size; every bucket is warmed once")
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
    p.add_argument("--gptq", default=None,
                   help="(--int8) npz of calibrated GPTQ codes (python -m uniception_tpu_torch.calibrate_gptq, or the "
                        "JAX package's scripts/calibrate_gptq.py): the same kernels and scales, better int8 codes")
    p.add_argument("--attn", choices=["kernel", "fused", "naive"], default=None,
                   help="attention implementation (default: UNICEPTION_TPU_ATTN, else kernel)")
    p.add_argument("--attn-quant", choices=["none", "int8", "int8pv"], default=None,
                   help="int8 attention of the single-key-block calls (default: UNICEPTION_TPU_ATTN_QUANT, else none)")
    p.add_argument("--conv3x3", choices=["torch", "kernel"], default=None,
                   help="the DPT head's 3x3 convs (default: UNICEPTION_TPU_CONV3X3, else torch)")
    p.add_argument("--gelu", choices=["exact", "tanh"], default=None,
                   help="GELU mode (default: UNICEPTION_TPU_GELU, else exact)")
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def apply_kernel_flags(args):
    "Set the kernel selection of the flags given (models/utils/config.py); a flag left out keeps its setting."
    for flag, setter in (("attn", config.set_attention_impl), ("attn_quant", config.set_attention_quant),
                         ("conv3x3", config.set_conv3x3_impl), ("gelu", config.set_gelu_mode)):
        value = getattr(args, flag)
        if value is not None:
            setter(value)


def main(argv=None):
    args = parse_args(argv)
    apply_kernel_flags(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to serve on the CPU")
    t_build = _timed(device)
    model = build_model(
        args.img_size, args.enc_depth, args.enc_dim, args.enc_heads, args.dec_depth, args.dec_dim, args.dec_heads,
        device=device, head=args.head, int8=args.int8, int8_policy=args.int8_policy, int8_asym=args.int8_asym,
        model=args.model, checkpoint=args.checkpoint, landscape_only=args.buckets and args.model == "dust3r",
        gptq=args.gptq,
    )
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    source = args.checkpoint or "seeded random weights"
    print(f"{args.model} ({args.head} head) from {source} in {t_build():.2f}s on {where}")
    if args.buckets:
        buckets = scaled_buckets(args.img_size, portrait=args.model == "flow")
        pairs = image_dir_pairs(args.image_dir) if args.image_dir else synthetic_pairs(args.pairs, args.img_size)
        stats = serve_bucketed(model, device, pairs, args.batch, buckets)
        print(f"{len(buckets)} buckets warmed in {stats['warm_seconds']:.2f}s: {list(buckets)}")
        if stats["pairs"] == 0:
            print("no pairs to serve (need >= 2 frames in --image-dir)")
            return stats
        counts = {f"{h}x{w}": n for (h, w), n in stats["per_bucket"].items()}
        print(f"{stats['pairs']} pairs in {stats['seconds']:.2f}s = {stats['pairs'] / stats['seconds']:.2f} pairs/s "
              f"across {len(counts)} buckets {counts} (host resizing included)")
        out, t2, _ = stats["last"]
        if args.model == "flow":
            print("flow:", tuple(out[0][0].shape), "flow_conf:", tuple(out[1][0].shape))
        else:
            print("pts3d_in_other_view (native orientation):", extract_view(out[2][0], t2[0]).shape)
        return stats
    if args.image_dir:
        frames = np.stack([_open_rgb(f, args.img_size) for f in _image_files(args.image_dir)])
    else:
        rng = np.random.RandomState(0)
        frames = rng.randint(0, 256, size=(2 * args.pairs, args.img_size, args.img_size, 3), dtype=np.uint8)
    out, pairs, seconds = serve_frames(make_serving_fn(model, device), frames, args.batch, device)
    print(f"{pairs} pairs in {seconds:.3f}s = {pairs / seconds:.2f} pairs/s on {where} (after one warm-up batch)")
    if args.model == "flow":
        print("flow:", tuple(out[0].shape), "flow_conf:", tuple(out[1].shape))
    else:
        print("pts3d:", tuple(out[0].shape), "conf:", tuple(out[1].shape))
    return out


if __name__ == "__main__":
    main()
