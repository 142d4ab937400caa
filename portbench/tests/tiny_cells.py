"""Tiny DUSt3R cells for the CPU tests: the benchmark's runners and family at small widths (the DPT head keeps
the widths the program fixes for it)."""

import types

from portbench.core.registry import load_module

# limits at these tiny widths, set from CPU readings (program and int8 control, five seeds each) as the cells' are:
# linear: xyz_rel 0.009-0.013 against 0.029-0.042; DPT: xyz_dev_rel 0.020-0.030 against 0.061-0.103,
# c_dev_rel 0.026-0.040 against 0.080-0.119
LIMITS = {"linear": {"xyz_rel": 0.02, "c_rel": 0.02}, "dpt": {"xyz_dev_rel": 0.045, "c_dev_rel": 0.055}}
# training, three seeds: grad_gap 0.011-0.026 against the fp8 control's 0.089-0.249; update_gap at most 0.029
TRAIN_LIMITS = {"grad_gap": 0.05, "update_gap": 0.1}


def tiny_arch(head: str, img: int = 32) -> dict:
    arch = dict(img_size=[img, img], patch_size=16, enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
                dec_embed_dim=48, dec_depth=2, dec_num_heads=4, rope_freq=100, head=head, output_dim=4)
    if head == "dpt":  # the program builds DPT at feature 256 and these layer widths; depth 2 hooks decoder 0 and 1
        arch.update(dpt_feature_dim=256, dpt_layer_dims=[96, 192, 384, 768], dpt_decoder_hooks=[0, 1])
    return arch


def tiny_cell(head: str, trunk: str = "bfloat16", limits=None):
    "A stand-in for core.registry.Cell with the serving runner, at tiny widths, 4 pairs a batch."
    cfg = dict(family="dust3r", arch=tiny_arch(head), precision=dict(trunk=trunk, head="float32"))
    tr = dict(kind="serve_closed", pairs_per_batch=4, distinct_batches=2, warmup_batches=1, sample_from_first=2,
              traced_batches=2, reference_block=2)
    cell = types.SimpleNamespace(name=f"tiny_{head}", chips=1, config=cfg, traffic=tr, per_layer=[], end_to_end=[],
                                 limits=dict(limits or LIMITS[head]))
    cell.family = lambda: load_module("models", "dust3r")
    cell.runner = lambda: load_module("traffic", "serve_closed")
    return cell


def tiny_train_cell(head: str = "linear", trunk: str = "bfloat16", limits=None):
    "A stand-in for core.registry.Cell with the training runner, at tiny widths, 2 pairs a step."
    cfg = dict(family="dust3r", arch=tiny_arch(head), precision=dict(trunk=trunk, head="float32"))
    tr = dict(kind="train_steps", pairs_per_step=2, distinct_batches=3, learning_rate=1e-4, weight_decay=0.05,
              alpha=0.2, traced_steps=1, reference_block=1)
    cell = types.SimpleNamespace(name=f"tiny_train_{head}", chips=1, config=cfg, traffic=tr, per_layer=[],
                                 end_to_end=[], limits=dict(limits or TRAIN_LIMITS))
    cell.family = lambda: load_module("models", "dust3r")
    cell.runner = lambda: load_module("traffic", "train_steps")
    return cell

