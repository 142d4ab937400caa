"""
Two-view DUSt3R training on one device: the single-device subset of
examples/train_dust3r.py, in PyTorch.

    synthetic uint8 pairs + pointmap targets (numpy, from a seed)
      -> step-indexed sampler -> device, normalized (pinned staging on CUDA)
      -> parallel.training.make_train_step (AdamW, optional clipping,
         non-finite guard, accumulation, frozen encoder) -> optional EMA

One model width for encoder and decoder (``--embed-dim``, ``--depth``,
``--heads``), as in the JAX example; the CUDA kernels take a head dim of 64
(``--embed-dim`` / ``--heads``). ``--bf16`` computes the trunk in bf16 over
fp32 parameters and optimizer state. The device is explicit and the trainer
never moves to another one.

Usage:
    python -m uniception_tpu_torch.train --device cuda --img 224 --embed-dim 1024 --depth 24 --heads 16 --bf16
    python -m uniception_tpu_torch.train --device cpu --steps 3
"""

import argparse
import time

import numpy as np
import torch

from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.parallel.training import dust3r_confidence_loss, ema_init, ema_update, make_train_step
from uniception_tpu_torch.serve import make_frame_normalizer

__all__ = ["synthetic_dataset", "DeterministicSampler", "main"]


def synthetic_dataset(n: int, img: int, seed: int = 0):
    "Random uint8 image pairs + pointmap targets (the JAX example's stand-in for a real set)."
    rng = np.random.RandomState(seed)
    return {
        "img1": rng.randint(0, 256, (n, img, img, 3), np.uint8),
        "img2": rng.randint(0, 256, (n, img, img, 3), np.uint8),
        "pts1": rng.randn(n, img, img, 3).astype(np.float32),
        "pts2": rng.randn(n, img, img, 3).astype(np.float32),
    }


class DeterministicSampler:
    """Step-indexed batch sampler (uniception_tpu/data/pipeline.py): the k-th
    batch is a pure function of (seed, epoch shuffle, k), with each epoch's
    permutation drawn from ``SeedSequence([seed, epoch])``, so a run resumed
    at step k sees the batches the uninterrupted run would have seen."""

    def __init__(self, arrays, batch_size: int, *, seed: int = 0, start_step: int = 0):
        self.arrays, self.batch_size, self.seed, self.step = arrays, int(batch_size), int(seed), int(start_step)
        self._n = len(next(iter(arrays.values())))
        self.batches_per_epoch = self._n // self.batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(f"dataset ({self._n}) smaller than batch_size ({batch_size})")
        self._epoch, self._order = None, None

    def batch_at(self, step: int):
        "The batch of the given global step."
        epoch, pos = divmod(step, self.batches_per_epoch)
        if self._epoch != epoch:
            self._order = np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).permutation(self._n)
            self._epoch = epoch
        idx = self._order[pos * self.batch_size : (pos + 1) * self.batch_size]
        return {k: v[idx] for k, v in self.arrays.items()}

    def __iter__(self):
        while True:
            yield self.batch_at(self.step)
            self.step += 1


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--img", type=int, default=32)
    p.add_argument("--embed-dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dataset-size", type=int, default=64)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--bf16", action="store_true", help="bf16 trunk compute (fp32 parameters and optimizer state)")
    p.add_argument("--remat", action="store_true", help="gradient checkpointing of every trunk block")
    p.add_argument("--clip-grad", type=float, default=None, help="global-norm gradient clipping")
    p.add_argument("--skip-nonfinite", action="store_true", help="skip any step whose gradients hold NaN/inf")
    p.add_argument("--metrics", action="store_true", help="print the gradient norm")
    p.add_argument("--freeze-encoder", action="store_true", help="train the info sharing and heads only")
    p.add_argument("--norm-loss", action="store_true", help="scale-invariant loss (norm_mode='avg_dis')")
    p.add_argument("--ema", type=float, default=0.0, metavar="DECAY", help="keep an EMA of the parameters")
    p.add_argument("--seed", type=int, default=0, help="seed of the weights and of the synthetic data")
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    "Train; returns the list of per-step losses."
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to train on the CPU")
    model = DUSt3R(
        name="train_example",
        img_size=(args.img, args.img),
        patch_embed_cls="PatchEmbedDust3R",
        enc_embed_dim=args.embed_dim,
        enc_depth=args.depth,
        enc_num_heads=args.heads,
        info_sharing_dim=args.embed_dim,
        info_sharing_depth=args.depth,
        info_sharing_num_heads=args.heads,
        gradient_checkpointing=args.remat,
        dtype=torch.bfloat16 if args.bf16 else None,
        device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed),
    )
    norm_mode = "avg_dis" if args.norm_loss else None

    def loss_fn(m, img1, img2, target1, target2):
        res1, res2 = m.forward_pair(img1, img2)
        return dust3r_confidence_loss(res1, res2, target1, target2, norm_mode=norm_mode)

    ctx = make_train_step(
        model,
        loss_fn=loss_fn,
        learning_rate=args.lr,
        grad_accum=args.grad_accum,
        clip_grad_norm=args.clip_grad,
        skip_nonfinite=args.skip_nonfinite,
        metrics=args.metrics,
        trainable=(lambda p: not p.startswith("encoder.")) if args.freeze_encoder else None,
    )
    n_params = sum(p.numel() for p in model.parameters())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"params={n_params / 1e6:.2f}M trainable={sum(p.numel() for p in ctx.params) / 1e6:.2f}M on {where}")

    prep = make_frame_normalizer(model.data_norm_type, device)
    sampler = iter(DeterministicSampler(synthetic_dataset(args.dataset_size, args.img, args.seed), args.batch, seed=1234))
    ema = ema_init(dict(model.named_parameters())) if args.ema > 0 else None
    losses = []
    t0 = time.perf_counter()
    for step_idx in range(1, args.steps + 1):
        b = next(sampler)
        targets = [torch.from_numpy(b[k]).to(device, non_blocking=True) for k in ("pts1", "pts2")]
        out = ctx.step(prep(b["img1"]), prep(b["img2"]), *targets)
        loss, aux = out if args.metrics else (out, None)
        if ema is not None:
            ema_update(ema, dict(model.named_parameters()), args.ema)
        losses.append(float(loss))
        if step_idx % max(1, args.steps // 10) == 0 or step_idx == 1:
            extra = f"  grad_norm {float(aux['grad_norm']):8.3f}" if aux is not None else ""
            print(f"step {step_idx:5d}  loss {losses[-1]:9.4f}  {time.perf_counter() - t0:6.1f}s{extra}", flush=True)
    return losses


if __name__ == "__main__":
    main()
