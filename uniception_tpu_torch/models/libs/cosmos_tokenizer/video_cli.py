#!/usr/bin/env python
"""
The Cosmos video tokenizer CLI (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/video_cli.py): autoencode a
(1 + 8n)-frame clip through a CV or DV tokenizer and report the reconstruction error. The clip is seeded random
(RandomState(0)), as in the JAX package.

    python -m uniception_tpu_torch.models.libs.cosmos_tokenizer.video_cli --frames 17 --size 512 --dtype bfloat16
    python -m uniception_tpu_torch.models.libs.cosmos_tokenizer.video_cli --device cpu --size 32 --tokenizer DV
"""

import argparse

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--tokenizer", default="CV", choices=["CV", "DV"])
    parser.add_argument("--spatial-compression", type=int, default=8)
    parser.add_argument("--temporal-compression", type=int, default=8)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--frames", type=int, default=9)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--device", default="cuda", help="torch device (default: the card)")
    parser.add_argument("--dtype", default="float32", choices=sorted(_DTYPES), help="compute dtype")
    args = parser.parse_args(argv)

    from uniception_tpu_torch.models.libs.cosmos_tokenizer.video_lib import CausalVideoTokenizer

    tok = CausalVideoTokenizer(args.tokenizer, args.spatial_compression, args.temporal_compression, args.checkpoint,
                               device=args.device, dtype=_DTYPES[args.dtype])
    x = np.random.RandomState(0).randn(1, 3, args.frames, args.size, args.size).astype(np.float32).clip(-1, 1)
    recon = tok.autoencode(x)
    print(f"autoencode: input {x.shape} -> recon {recon.shape}, mean abs err {np.abs(recon - x).mean():.4f}")


if __name__ == "__main__":
    main()
