"""
Training on one device (counterpart of examples/train_dust3r.py), in PyTorch.

    synthetic uint8 pairs and targets (numpy, from a seed): pointmaps
    (DUSt3R), mixed landscape/portrait pairs on the ManyAR canvas
    (--mixed-ar), or dense flow with NaN at ~10% occluded pixels (--model flow)
      -> data.pipeline.DeterministicSampler (step-indexed) -> prefetch_to_device
         -> normalized on the device
      -> parallel.training.make_train_step: AdamW at a constant or
         warmup-cosine rate (--warmup-cosine), bf16 first moment (--mu-bf16),
         clipping, the non-finite guard, accumulation, a frozen encoder or
         LoRA adapters on the trunk (--lora) -> optional EMA
      -> save_train_state: every --ckpt-every steps in a thread, at a
         SIGTERM/SIGINT between steps (--preempt-safe; then exit 0) and at
         the end; --resume continues from --ckpt-dir, bit for bit the
         uninterrupted run.

One model width for encoder and decoder (``--embed-dim``, ``--depth``,
``--heads``), as in the JAX example; the CUDA kernels take a head dim of 64
(``--embed-dim`` / ``--heads``). ``--bf16`` computes the trunk in bf16 over
fp32 parameters and optimizer state. The device is explicit and the trainer
never moves to another one.

The checkpoint is this package's own (one file in --ckpt-dir, see
``save_train_state``); a JAX orbax train state is not read. Parameters from a
JAX run come across through the ``.npz``/``.nsv``/``.pth`` loaders
(``utils.weights``, ``utils.coldstart``). The multi-device flags --tp,
--zero1 and --fsdp (ROADMAP queue 1 item 12) and --scan (an XLA layout; the
port runs the loop layout and maps the scan layout's ``.nsv`` keys) raise.
The warmup-cosine horizon is the step this run ends at (the restored step
plus --steps), so a resumed run follows the uninterrupted run's schedule.

Usage:
    python -m uniception_tpu_torch.train --img 512 --embed-dim 1024 --depth 24 --heads 16 --bf16 --batch 2
    python -m uniception_tpu_torch.train --head dpt --mixed-ar --ckpt-dir ckpt --ckpt-every 100 --preempt-safe
    python -m uniception_tpu_torch.train --ckpt-dir ckpt --resume
    python -m uniception_tpu_torch.train --device cpu --steps 3 --lora 4
"""

import argparse
import os
import time

import numpy as np
import torch

from uniception_tpu_torch.data.pipeline import DeterministicSampler, make_frame_normalizer, prefetch_to_device
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.factory.flow import UFMFlow
from uniception_tpu_torch.nn.lora import apply_lora, lora_trainable
from uniception_tpu_torch.parallel.training import (
    PreemptionGuard,
    dust3r_confidence_loss,
    ema_init,
    ema_update,
    flow_confidence_loss,
    make_train_step,
    restore_train_state,
    save_train_state,
    warmup_cosine_decay_schedule,
)

__all__ = [
    "synthetic_dataset",
    "synthetic_mixed_dataset",
    "synthetic_flow_dataset",
    "DeterministicSampler",
    "parse_args",
    "build_model",
    "main",
]

MULTI_DEVICE = "ROADMAP queue 1 item 12 (multi-GPU)"


def synthetic_dataset(n: int, img: int, seed: int = 0):
    "Random uint8 image pairs + pointmap targets (the JAX example's stand-in for a real set)."
    rng = np.random.RandomState(seed)
    return {
        "img1": rng.randint(0, 256, (n, img, img, 3), np.uint8),
        "img2": rng.randint(0, 256, (n, img, img, 3), np.uint8),
        "pts1": rng.randn(n, img, img, 3).astype(np.float32),
        "pts2": rng.randn(n, img, img, 3).astype(np.float32),
    }


def synthetic_mixed_dataset(n: int, short: int, long: int, seed: int = 0):
    """Mixed landscape/portrait pairs in the ManyAR canvas convention: every
    sample lives in the (short, long) landscape canvas; a portrait sample
    (true shape (long, short)) is stored transposed, and so are its targets,
    the model's ``landscape_only`` output layout. Both views of a pair share
    the orientation."""
    rng = np.random.RandomState(seed)
    ts = np.where(
        (rng.rand(n) < 0.5)[:, None],
        np.tile([[short, long]], (n, 1)),
        np.tile([[long, short]], (n, 1)),
    ).astype(np.int32)
    return {
        "img1": rng.randint(0, 256, (n, short, long, 3), np.uint8),
        "img2": rng.randint(0, 256, (n, short, long, 3), np.uint8),
        "ts1": ts,
        "ts2": ts,
        "pts1": rng.randn(n, short, long, 3).astype(np.float32),
        "pts2": rng.randn(n, short, long, 3).astype(np.float32),
    }


def synthetic_flow_dataset(n: int, img: int, seed: int = 0):
    """Random uint8 image pairs + dense-flow targets for ``--model flow``:
    ~10% of the pixels are invalid (an occlusion stand-in) with a NaN flow
    target, as flow datasets store them."""
    rng = np.random.RandomState(seed)
    flow = rng.randn(n, img, img, 2).astype(np.float32)
    valid = (rng.rand(n, img, img) > 0.1).astype(np.float32)
    flow = np.where(valid[..., None] > 0, flow, np.nan)
    return {
        "img1": rng.randint(0, 256, (n, img, img, 3), np.uint8),
        "img2": rng.randint(0, 256, (n, img, img, 3), np.uint8),
        "flow": flow,
        "valid": valid,
    }


def parse_args(argv=None):
    """The JAX example's flags, plus --seed and --device. Argument errors (and the flags the port does not take)
    exit through ``argparse``'s error before any model is built."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="dust3r", choices=["dust3r", "flow"],
                    help="dust3r (two-view pointmaps) or flow (UFMFlow, flow_confidence_loss with an occlusion mask)")
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--embed-dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dataset-size", type=int, default=64)
    ap.add_argument("--tp", type=int, default=1, help=f"tensor parallel: not taken, {MULTI_DEVICE}")
    ap.add_argument("--zero1", action="store_true", help=f"not taken, {MULTI_DEVICE}")
    ap.add_argument("--fsdp", action="store_true", help=f"not taken, {MULTI_DEVICE}")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--head", choices=["linear", "dpt"], default="linear", help="prediction head family")
    ap.add_argument("--remat", action="store_true", help="gradient checkpointing (trunk and heads)")
    ap.add_argument("--head-remat", choices=["follow", "on", "off"], default="follow",
                    help="DPT-head gradient checkpointing apart from the trunk's")
    ap.add_argument("--scan", action="store_true", help="the JAX scan-over-blocks layout: not taken")
    ap.add_argument("--bf16", action="store_true", help="bf16 trunk compute (fp32 parameters and optimizer state)")
    ap.add_argument("--mu-bf16", action="store_true", help="AdamW's first moment in bf16")
    ap.add_argument("--mixed-ar", action="store_true",
                    help="mixed landscape/portrait ManyAR batches (landscape_only; canvas --img x 1.5 --img)")
    ap.add_argument("--norm-loss", action="store_true", help="scale-invariant loss (norm_mode='avg_dis')")
    ap.add_argument("--clip-grad", type=float, default=None, help="global-norm gradient clipping")
    ap.add_argument("--skip-nonfinite", action="store_true", help="skip any step whose gradients hold NaN/inf")
    ap.add_argument("--warmup-cosine", type=int, default=0, metavar="WARMUP_STEPS",
                    help="linear warmup then cosine decay to the run's last step (peak --lr); 0: constant")
    ap.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                    help="keep an EMA of the parameters; saved to <--ckpt-dir>_ema at the end")
    ap.add_argument("--metrics", action="store_true", help="print the gradient norm")
    ap.add_argument("--freeze-encoder", action="store_true", help="train the info sharing and heads only")
    ap.add_argument("--lora", type=int, default=0, metavar="RANK",
                    help="wrap the trunk's linears in rank-RANK LoRA adapters and train only those")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true", help="continue from the train state in --ckpt-dir")
    ap.add_argument("--preempt-safe", action="store_true",
                    help="on SIGTERM/SIGINT save at the next step boundary and exit 0 (needs --ckpt-dir)")
    ap.add_argument("--ckpt-every", type=int, default=0, metavar="N",
                    help="save every N steps in a thread, overlapping training")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and of the synthetic data")
    ap.add_argument("--device", default="cuda", help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.tp > 1 or args.zero1 or args.fsdp:
        ap.error(f"--tp > 1, --zero1 and --fsdp shard over several devices: {MULTI_DEVICE}")
    if args.scan:
        ap.error("--scan is the JAX package's XLA layout; this trainer runs the loop layout "
                 "(convert_checkpoints maps the scan layout's keys)")
    if args.preempt_safe and not args.ckpt_dir:
        ap.error("--preempt-safe requires --ckpt-dir (there is nowhere to save on SIGTERM)")
    if args.ckpt_every and not args.ckpt_dir:
        ap.error("--ckpt-every requires --ckpt-dir")
    if args.lora and args.freeze_encoder:
        ap.error("--lora and --freeze-encoder are separate finetune recipes; pick one")
    if args.model == "flow" and (args.mixed_ar or args.norm_loss):
        ap.error("--mixed-ar / --norm-loss are DUSt3R-specific (flow has no ManyAR convention and no pointmap "
                 "normalization)")
    return args


def build_model(args, device):
    "The model the flags describe, its weights drawn from ``--seed``."
    common = dict(
        img_size=(args.img, args.img * 3 // 2) if args.mixed_ar else (args.img, args.img),
        pred_head_type=args.head,
        enc_embed_dim=args.embed_dim,
        enc_depth=args.depth,
        enc_num_heads=args.heads,
        info_sharing_dim=args.embed_dim,
        info_sharing_depth=args.depth,
        info_sharing_num_heads=args.heads,
        gradient_checkpointing=args.remat,
        head_gradient_checkpointing={"follow": None, "on": True, "off": False}[args.head_remat],
        dtype=torch.bfloat16 if args.bf16 else None,
        device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed),
    )
    if args.model == "flow":
        return UFMFlow(name="train_example_flow", **common)
    return DUSt3R(name="train_example", patch_embed_cls="ManyAR_PatchEmbed" if args.mixed_ar else "PatchEmbedDust3R",
                  landscape_only=args.mixed_ar, **common)


def _loss_fn(args):
    "The step's loss; its four arguments are the batch's image slots and target slots."
    norm_mode = "avg_dis" if args.norm_loss else None
    if args.model == "flow":  # the flow target rides the first target slot, the valid mask the second
        def loss_fn(m, img1, img2, target_flow, valid):
            return flow_confidence_loss(m.forward_pair(img1, img2), target_flow, valid=valid > 0)
    elif args.mixed_ar:  # the true shapes ride the image slots
        def loss_fn(m, v1, v2, target1, target2):
            res1, res2 = m.forward_pair(v1["img"], v2["img"], true_shape1=v1["ts"], true_shape2=v2["ts"])
            return dust3r_confidence_loss(res1, res2, target1, target2, norm_mode=norm_mode)
    else:
        def loss_fn(m, img1, img2, target1, target2):
            res1, res2 = m.forward_pair(img1, img2)
            return dust3r_confidence_loss(res1, res2, target1, target2, norm_mode=norm_mode)
    return loss_fn


def _host_batches(args, sampler):
    """The sampler's batches as {img1, img2, pts1, pts2} (uint8 images, the two target slots) plus, with
    --mixed-ar, the true shapes in a tuple: not an array, so they stay on the host, where landscape_only reads
    them without waiting for the device."""
    for b in sampler:
        if args.model == "flow":
            yield {"img1": b["img1"], "img2": b["img2"], "pts1": b["flow"], "pts2": b["valid"]}
            continue
        out = {k: b[k] for k in ("img1", "img2", "pts1", "pts2")}
        if args.mixed_ar:
            out["ts"] = (torch.from_numpy(b["ts1"]), torch.from_numpy(b["ts2"]))
        yield out


def main(argv=None):
    "Train; returns the list of this run's per-step losses."
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to train on the CPU")
    model = build_model(args, device)
    trainable = None
    if args.lora:
        # adapters on the trunk's linears (min_params 1: the trunk is the scope), the heads stay full rank
        n_wrapped = apply_lora(model.encoder, args.lora, generator=torch.Generator(device).manual_seed(args.seed + 1),
                               min_params=1)
        n_wrapped += apply_lora(model.info_sharing, args.lora,
                                generator=torch.Generator(device).manual_seed(args.seed + 2), min_params=1)
        print(f"lora: wrapped {n_wrapped} linears at rank {args.lora}")
        trainable = lora_trainable
    elif args.freeze_encoder:
        trainable = lambda p: not p.startswith("encoder.")  # noqa: E731

    ctx = make_train_step(
        model,
        loss_fn=_loss_fn(args),
        learning_rate=args.lr,
        grad_accum=args.grad_accum,
        mu_dtype=torch.bfloat16 if args.mu_bf16 else None,
        clip_grad_norm=args.clip_grad,
        skip_nonfinite=args.skip_nonfinite,
        metrics=args.metrics,
        trainable=trainable,
    )
    n_params = sum(p.numel() for p in model.parameters())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"params={n_params / 1e6:.2f}M trainable={sum(p.numel() for p in ctx.params) / 1e6:.2f}M on {where}")

    ckpt_dir = os.path.abspath(args.ckpt_dir) if args.ckpt_dir else ""
    start_step = 0
    if args.resume and ckpt_dir and os.path.isdir(ckpt_dir):
        start_step = restore_train_state(ckpt_dir, ctx)
        print(f"resumed from {args.ckpt_dir} at step {start_step}")
    if args.warmup_cosine > 0:
        ctx.optimizer.lr = warmup_cosine_decay_schedule(
            0.0, args.lr, args.warmup_cosine, max(start_step + args.steps, args.warmup_cosine + 1))

    if args.model == "flow":
        data = synthetic_flow_dataset(args.dataset_size, args.img, args.seed)
    elif args.mixed_ar:
        data = synthetic_mixed_dataset(args.dataset_size, args.img, args.img * 3 // 2, args.seed)
    else:
        data = synthetic_dataset(args.dataset_size, args.img, args.seed)
    # step-indexed: the resumed run sees exactly the batches the uninterrupted run would have
    sampler = DeterministicSampler(data, args.batch, seed=1234, start_step=start_step)
    prep = make_frame_normalizer(model.data_norm_type, device)
    ema = ema_init(dict(model.named_parameters())) if args.ema > 0 else None
    guard = PreemptionGuard() if args.preempt_safe else None
    pending = None  # the in-flight asynchronous save: waited on before the next one

    def checkpoint(wait: bool):
        nonlocal pending
        if pending is not None:
            pending.wait_until_finished()
        pending = save_train_state(ckpt_dir, ctx, step=step_idx, wait=wait)

    losses, step_idx, preempted = [], start_step, False
    batches = prefetch_to_device(_host_batches(args, sampler), device)
    t0 = time.perf_counter()
    try:
        for b in batches:
            img1, img2 = prep(b["img1"]), prep(b["img2"])
            if args.mixed_ar:
                img1, img2 = {"img": img1, "ts": b["ts"][0]}, {"img": img2, "ts": b["ts"][1]}
            out = ctx.step(img1, img2, b["pts1"], b["pts2"])
            loss, aux = out if args.metrics else (out, None)
            if ema is not None:
                ema_update(ema, dict(model.named_parameters()), args.ema)
            losses.append(loss)  # read at the print steps and at the end: no wait for the device in between
            step_idx += 1
            if step_idx % max(1, args.steps // 10) == 0 or step_idx == start_step + 1:
                extra = f"  grad_norm {float(aux['grad_norm']):8.3f}" if aux is not None else ""
                print(f"step {step_idx:5d}  loss {float(loss):9.4f}  {time.perf_counter() - t0:6.1f}s{extra}",
                      flush=True)
            if guard is not None and guard.should_stop():
                # the step has updated the parameters: the resumed run continues from step_idx
                checkpoint(wait=True)
                print(f"preempted: saved at step {step_idx}; resume with --resume", flush=True)
                preempted = True
                break
            if step_idx >= start_step + args.steps:
                break
            if args.ckpt_every and (step_idx - start_step) % args.ckpt_every == 0:
                checkpoint(wait=False)
        if ckpt_dir and not preempted:
            checkpoint(wait=True)
            if ema is not None:
                save_train_state(ckpt_dir + "_ema", ema, step=step_idx)
            print(f"saved params+opt_state+step to {args.ckpt_dir} (resume with --resume)")
    finally:
        batches.close()
        if pending is not None:
            pending.wait_until_finished()
        if guard is not None:
            guard.close()
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
