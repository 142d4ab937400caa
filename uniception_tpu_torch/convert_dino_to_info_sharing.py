#!/usr/bin/env python
"""
Surgery: initialise a global- or alternating-attention info-sharing transformer from DINOv2 encoder blocks
(counterpart of scripts/convert_dino_to_info_sharing.py; reference scripts/convert_dino_to_info_sharing.py:42-80).

DINOv2 ``blocks[start:end]`` become ``self_attention_blocks.{0..end-start-1}`` and the encoder's final norm the
transformer's ``norm``, with the ``model.`` prefix stripped; the result is written as the ``.npz`` interchange file
(``utils/checkpoint.save_checkpoint``) with the JAX script's metadata (source, start, end), so either package
reads it. The check builds a ``MultiViewGlobalAttentionTransformer`` of the blocks' width and depth on the meta
device (no memory, no device) with LayerScale when the blocks have it and ``SwiGLUFFNFused`` when their MLP is
one, and prints the missing and unexpected keys; a shape that does not match raises.

    python -m uniception_tpu_torch.convert_dino_to_info_sharing dinov2_vitl14.pth info_sharing.npz --start 12 --end 24
"""

import argparse
from typing import Optional, Sequence

import numpy as np

from uniception_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["convert", "verify", "main"]


def convert(dino_state: dict, start: int, end: int) -> dict:
    "DINOv2 blocks[start:end] -> the info-sharing ``self_attention_blocks`` state, and the final norm (JAX :22-37)."
    out = {}
    for i, src in enumerate(range(start, end)):
        prefix, dst = f"blocks.{src}.", f"self_attention_blocks.{i}."
        for k, v in dino_state.items():
            k = k.replace("model.", "", 1) if k.startswith("model.") else k
            if k.startswith(prefix):
                out[dst + k[len(prefix):]] = v
    for k in ("norm.weight", "norm.bias", "model.norm.weight", "model.norm.bias"):
        if k in dino_state:
            out[k.replace("model.", "", 1)] = dino_state[k]
    return out


def verify(state: dict, depth: int):
    """(missing keys, unexpected keys) of ``state`` against a ``MultiViewGlobalAttentionTransformer`` of its width
    and ``depth`` (heads of 64), with LayerScale and SwiGLUFFNFused where the blocks have them, built on the meta
    device. Raises ValueError on a shape mismatch."""
    from uniception_tpu_torch.models.info_sharing.global_attention_transformer import (
        MultiViewGlobalAttentionTransformer,
    )
    from uniception_tpu_torch.nn.blocks import Mlp, SwiGLUFFNFused
    from uniception_tpu_torch.utils.coldstart import abstract_construct

    dim = np.shape(state[next(k for k in state if "attn.qkv.weight" in k)])[1]
    layer_scale = any(".ls1.gamma" in k for k in state)
    swiglu = any(".mlp.w12." in k for k in state)
    model = abstract_construct(lambda: MultiViewGlobalAttentionTransformer(
        name="verify", input_embed_dim=dim, dim=dim, depth=depth, num_heads=max(1, dim // 64),
        init_values=1.0 if layer_scale else None, mlp_layer=SwiGLUFFNFused if swiglu else Mlp))
    own = model.state_dict()
    for k in own.keys() & state.keys():
        if tuple(np.shape(state[k])) != tuple(own[k].shape):
            raise ValueError(f"Shape mismatch for {k}: checkpoint {np.shape(state[k])} vs model {tuple(own[k].shape)}")
    return [k for k in own if k not in state], [k for k in state if k not in own]


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dino_ckpt", help="DINOv2 checkpoint (.pth/.npz)")
    parser.add_argument("output", help="output info-sharing checkpoint (.npz)")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, required=True)
    parser.add_argument("--skip_verify", action="store_true")
    args = parser.parse_args(argv)

    state = convert(load_checkpoint(args.dino_ckpt)["model"], args.start, args.end)
    if not args.skip_verify:
        missing, unexpected = verify(state, args.end - args.start)
        print(f"verification: missing={len(missing)} unexpected={len(unexpected)}")
        if missing or unexpected:
            print(f"  missing_keys={missing}\n  unexpected_keys={unexpected}")
    save_checkpoint(args.output, state, source="dinov2_surgery", start=args.start, end=args.end)
    print(f"Wrote {args.output} with {len(state)} tensors")


if __name__ == "__main__":
    main()
