"""
Convert checkpoints (counterpart of scripts/convert_checkpoints.py).

    python -m uniception_tpu_torch.convert_checkpoints input.pth output.npz
    python -m uniception_tpu_torch.convert_checkpoints --dust3r vanilla_dust3r.pth output.npz
    python -m uniception_tpu_torch.convert_checkpoints --serving --head dpt input.pth dust3r.nsv
    python -m uniception_tpu_torch.convert_checkpoints --serving --model flow --int8 input.npz ufm.nsv
    python -m uniception_tpu_torch.convert_checkpoints --serving --int8 --gptq gptq_dust3r.npz input.pth dust3r.nsv

Without ``--serving``: a torch-layout ``.pth``/``.pt``/``.bin``/``.npz`` (the
reference's ``{"model": state_dict, **metadata}``) becomes the ``.npz``
interchange file (utils/checkpoint.py). ``--dust3r`` first renames a vanilla
DUSt3R/MASt3R state dict's keys to UniCeption's (:func:`remap_vanilla_dust3r`).

With ``--serving``: a native serving checkpoint (utils/coldstart.py) in the
JAX package's paths, bf16 (``--f32`` keeps fp32), in the scan layout the JAX
serving example reads by default (``--no-scan``: the loop layout); ``.nsv``
names the packed container, ``.npz`` the numpy zip. ``--int8`` quantizes the
trunk offline in the JAX converter's order (every parameter cast to bf16,
then ``quantize_trunk``) and records ``quant``, ``quant_layers``,
``quant_policy`` and ``quant_asym`` in the metadata as it does, so the file
serves int8 in either package. ``--gptq PATH`` (with ``--int8``) then embeds
calibrated GPTQ codes (nn/gptq.py) in place of the RTN codes and records their
count as ``quant_gptq_layers``; it works on the card by default (``--device``),
as the calibration and serving do, and refuses without one.
"""

import argparse

import torch

from uniception_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["remap_vanilla_dust3r", "main"]


def remap_vanilla_dust3r(state):
    """Vanilla DUSt3R/MASt3R state dict -> UniCeption DUSt3R keys (reference:
    examples/models/dust3r/convert_dust3r_weights_to_uniception.py:21-67).

    A shared-decoder checkpoint (no dec_blocks2) gets its decoder duplicated
    into the second view's branch, as the reference converter does.
    """
    if not any(k.startswith("dec_blocks2") for k in state):
        dup = {k.replace("dec_blocks", "dec_blocks2", 1): v for k, v in state.items() if k.startswith("dec_blocks.")}
        state = {**state, **dup}
    out = {}
    for k, v in state.items():
        nk = k
        if nk.startswith(("patch_embed.", "enc_blocks.")) or nk in ("enc_norm.weight", "enc_norm.bias"):
            nk = "encoder." + nk
        elif nk.startswith("dec_blocks2."):
            nk = nk.replace("dec_blocks2.", "info_sharing.multi_view_branches.1.")
        elif nk.startswith("dec_blocks."):
            nk = nk.replace("dec_blocks.", "info_sharing.multi_view_branches.0.")
        elif nk.startswith("decoder_embed."):
            nk = nk.replace("decoder_embed.", "info_sharing.proj_embed.")
        elif nk.startswith("dec_norm."):
            nk = nk.replace("dec_norm.", "info_sharing.norm.")
        elif nk.startswith(("downstream_head1.proj.", "downstream_head2.proj.")):
            head = nk[len("downstream_head")]
            nk = f"head{head}.linear." + nk.split(".proj.", 1)[1]
            # vanilla's nn.Linear (out, in) becomes LinearFeature's 1x1 conv (out, in, 1, 1)
            if nk.endswith(".weight") and getattr(v, "ndim", 0) == 2:
                v = v.reshape(v.shape[0], v.shape[1], 1, 1)
        elif nk.startswith(("downstream_head1.dpt.", "downstream_head2.dpt.")):
            head = nk[len("downstream_head")]
            sub = nk.split(".dpt.", 1)[1]
            # dpt.head.{0,2,4} is the regression processor; the rest is the DPT feature pyramid
            reg_map = {"0": "conv1", "2": "conv2.0", "4": "conv2.2"}
            if sub.startswith("head."):
                idx, rest = sub[len("head."):].split(".", 1)
                nk = f"dpt_regressor_head{head}.{reg_map[idx]}.{rest}"
            else:
                nk = f"dpt_feature_head{head}.{sub}"
        elif nk.startswith("downstream_head1."):
            nk = nk.replace("downstream_head1.", "head1.")
        elif nk.startswith("downstream_head2."):
            nk = nk.replace("downstream_head2.", "head2.")
        out[nk] = v
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("input", help="torch-layout checkpoint (.pth/.pt/.bin or .npz)")
    p.add_argument("output", help="output path: .npz, or with --serving .nsv (packed) or .npz (zip)")
    p.add_argument("--dust3r", action="store_true", help="apply the vanilla-DUSt3R key remapping")
    p.add_argument("--serving", action="store_true", help="write a native serving checkpoint (JAX paths and layout)")
    p.add_argument("--model", default="dust3r", choices=["dust3r", "flow"], help="(--serving) the model it belongs to")
    p.add_argument("--img-size", type=int, default=512, help="(--serving) model image size")
    p.add_argument("--head", default="linear", choices=["linear", "dpt"], help="(--serving) head type")
    p.add_argument("--enc-dim", type=int, default=1024, help="(--serving) encoder width")
    p.add_argument("--enc-depth", type=int, default=24, help="(--serving) encoder depth")
    p.add_argument("--enc-heads", type=int, default=16, help="(--serving) encoder heads")
    p.add_argument("--dec-dim", type=int, default=768, help="(--serving) info-sharing width")
    p.add_argument("--dec-depth", type=int, default=12, help="(--serving) info-sharing depth")
    p.add_argument("--dec-heads", type=int, default=12, help="(--serving) info-sharing heads")
    p.add_argument("--no-scan", action="store_true", help="(--serving) the loop layout instead of scan")
    p.add_argument("--f32", action="store_true", help="(--serving) keep fp32 parameters (default: bf16)")
    p.add_argument("--int8", action="store_true", help="(--serving) w8a8-quantize the trunk linears offline")
    p.add_argument("--int8-policy", default="all", help="(--int8) mixed-precision trunk policy (nn/quant.py)")
    p.add_argument("--int8-asym", default="none", help="(--int8) layers with zero-point activation quantization")
    p.add_argument("--gptq", default=None,
                   help="(--int8) npz of calibrated GPTQ codes (python -m uniception_tpu_torch.calibrate_gptq): embed "
                        "them in place of the RTN codes")
    p.add_argument("--device", default=None,
                   help="where the model is built and quantized: cuda (the default with --gptq; fails without a "
                        "GPU) or cpu (the default otherwise)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    ckpt = load_checkpoint(args.input)
    state = ckpt.pop("model")
    if args.dust3r:
        state = remap_vanilla_dust3r(state)
    meta = {k: v for k, v in ckpt.items() if isinstance(v, (str, int, float, bool))}
    if not args.serving:
        save_checkpoint(args.output, state, **meta)
        print(f"Wrote {args.output} with {len(state)} tensors, metadata={meta}")
        return args.output

    if args.f32 and args.int8:
        raise SystemExit("--f32 and --int8 are exclusive: the int8 trunk is quantized from bf16 parameters, "
                         "as serving quantizes it")
    if args.gptq and not args.int8:
        raise SystemExit("--gptq requires --int8: the codes replace the int8 trunk's RTN codes")
    device = torch.device(args.device or ("cuda" if args.gptq else "cpu"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to convert on the CPU")
    from uniception_tpu_torch.nn.gptq import apply_gptq, load_gptq_npz
    from uniception_tpu_torch.nn.quant import quantize_trunk
    from uniception_tpu_torch.serve import make_model
    from uniception_tpu_torch.utils.coldstart import abstract_construct, materialize, save_native_state

    for reserved in ("dtype", "path", "module", "layout"):  # save_native_state's own parameters
        if reserved in meta:
            meta[f"ckpt_{reserved}"] = meta.pop(reserved)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    dims = (args.enc_depth, args.enc_dim, args.enc_heads, args.dec_depth, args.dec_dim, args.dec_heads)
    model = abstract_construct(lambda: make_model(
        args.model, (args.img_size, args.img_size), dims, dtype=dtype, head=args.head, head_dtype=None,
        landscape_only=False,
    ))
    materialize(model, state_dict=state, ignore=model.checkpoint_alias_patterns(), device=device)
    save_dtype = None if args.f32 else torch.bfloat16
    if args.int8:
        # the JAX converter's order: every parameter cast to bf16 first, then the trunk quantized
        model.to(torch.bfloat16)
        n_q = quantize_trunk(model, args.int8_policy, asym=args.int8_asym)
        n_gptq = 0
        if args.gptq:
            n_gptq = apply_gptq(model, load_gptq_npz(args.gptq))
            print(f"embedded GPTQ codes for {n_gptq} layers from {args.gptq}")
        meta = {**meta, "quant": "int8-w8a8-dynamic", "quant_layers": n_q, "quant_gptq_layers": n_gptq,
                "quant_policy": args.int8_policy, "quant_asym": args.int8_asym}
        save_dtype = None  # each tensor already has its serving dtype (fp32 scales and int8 biases' fp32)
    save_native_state(args.output, model, dtype=save_dtype, layout="loop" if args.no_scan else "scan", **meta)
    kind = "int8" if args.int8 else ("f32" if args.f32 else "bf16")
    print(f"Wrote native serving checkpoint {args.output} ({kind}, {'loop' if args.no_scan else 'scan'} layout)")
    return args.output


if __name__ == "__main__":
    main()
