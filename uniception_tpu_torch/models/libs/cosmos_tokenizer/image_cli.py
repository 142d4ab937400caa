#!/usr/bin/env python
"""
The Cosmos image tokenizer CLI (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/image_cli.py): autoencode
an image through a CI or DI tokenizer and report the reconstruction error. Without ``--image`` the input is a seeded
random 256 x 256 image, as in the JAX package. ``.png`` files are read and written without PIL
(uniception_tpu_torch/utils/png.py); palette, 16-bit and interlaced PNG files and other formats need PIL.

    python -m uniception_tpu_torch.models.libs.cosmos_tokenizer.image_cli --image in.png --output out.png
    python -m uniception_tpu_torch.models.libs.cosmos_tokenizer.image_cli --device cpu --tokenizer DI
"""

import argparse

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _read(path: str) -> np.ndarray:
    """An (H, W, 3) uint8 RGB array. A ``.png`` that utils/png.py does not read (palette, 16-bit, interlaced) and
    every other format go through PIL, as the JAX CLI reads them; without PIL such a file raises, naming both."""
    refused = None
    if path.lower().endswith(".png"):
        from uniception_tpu_torch.utils.png import read_png

        try:
            return read_png(path)
        except ValueError as e:
            refused = e
    try:
        from PIL import Image
    except ImportError as e:
        why = f"utils/png.py refuses it ({refused}) and " if refused else ""
        raise ValueError(f"{path}: {why}PIL, which reads it, is not installed") from e
    return np.asarray(Image.open(path).convert("RGB"))


def _write(path: str, image: np.ndarray):
    if path.lower().endswith(".png"):
        from uniception_tpu_torch.utils.png import write_png

        return write_png(path, image)
    from PIL import Image

    Image.fromarray(image).save(path)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--tokenizer", default="CI", choices=["CI", "DI"])
    parser.add_argument("--spatial-compression", type=int, default=8)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--image", default=None, help="input image path (falls back to random)")
    parser.add_argument("--output", default=None, help="reconstruction output path")
    parser.add_argument("--device", default="cuda", help="torch device (default: the card)")
    parser.add_argument("--dtype", default="float32", choices=sorted(_DTYPES), help="compute dtype")
    args = parser.parse_args(argv)

    from uniception_tpu_torch.models.libs.cosmos_tokenizer.image_lib import ImageTokenizer

    tok = ImageTokenizer(args.tokenizer, args.spatial_compression, args.checkpoint, device=args.device,
                         dtype=_DTYPES[args.dtype])

    if args.image:
        img = _read(args.image).astype(np.float32) / 127.5 - 1.0
        x = img.transpose(2, 0, 1)[None]
    else:
        x = np.random.RandomState(0).randn(1, 3, 256, 256).astype(np.float32).clip(-1, 1)

    recon = tok.autoencode(x)
    err = np.abs(recon - x).mean()
    print(f"autoencode: input {x.shape} -> recon {recon.shape}, mean abs err {err:.4f}")
    if args.output:
        _write(args.output, ((recon[0].transpose(1, 2, 0) + 1) * 127.5).clip(0, 255).astype(np.uint8))
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
