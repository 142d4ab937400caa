"""The operation counts of portbench/models/dust3r.py against torch's FlopCounterMode on the plain reference."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.core.registry import load_module
from portbench.reference.dust3r import ReferenceDUSt3R
from portbench.tests.tiny_cells import tiny_arch

torch.set_num_threads(2)


@pytest.mark.parametrize("head,img", [("linear", 32), ("linear", 64), ("dpt", 32), ("dpt", 48)])
def test_forward_flops_match_the_flop_counter(head, img):
    fam = load_module("models", "dust3r")
    arch = tiny_arch(head, img)
    ref = fam.build_reference(arch, fam.draw_weights(arch, 3, "cpu"))
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, img, img, 3), dtype=np.uint8))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref(frames, frames)
    assert counter.get_total_flops() == fam.forward_flops_per_pair(arch)


def test_published_sizes():
    "DUSt3R ViT-L 512: about 2.07 TFLOP a pair with the linear head, and the DPT heads add about 0.50."
    fam = load_module("models", "dust3r")
    lin = tiny_arch("linear") | dict(img_size=[512, 512], enc_embed_dim=1024, enc_depth=24, enc_num_heads=16,
                                     dec_embed_dim=768, dec_depth=12, dec_num_heads=12)
    dpt = lin | dict(head="dpt", dpt_feature_dim=256, dpt_layer_dims=[96, 192, 384, 768], dpt_decoder_hooks=[5, 8])
    assert 2.05e12 < fam.forward_flops_per_pair(lin) < 2.09e12
    assert 0.48e12 < fam.forward_flops_per_pair(dpt) - fam.forward_flops_per_pair(lin) < 0.52e12
    calls = fam.attention_calls(lin, 16)
    assert len(calls) == 72 and calls[0] == (32, 16, 1024, 1024, 64) and calls[-1] == (16, 12, 1024, 1024, 64)
    assert fam.attention_bytes((1, 1, 10, 20, 8)) == 2 * 8 * (2 * 10 + 2 * 20)


def test_weights_are_drawn_from_the_seed():
    fam = load_module("models", "dust3r")
    arch = tiny_arch("linear")
    a, b, c = (fam.draw_weights(arch, s, "cpu") for s in (2**31 + 9, 2**31 + 9, 5))
    assert list(a) == [k for k, _ in fam.weight_specs(arch)]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.enc_blocks.0.attn.qkv.weight"], c["encoder.enc_blocks.0.attn.qkv.weight"])
    w = a["encoder.enc_blocks.1.mlp.fc2.weight"]  # N(0, 1 / fan_in)
    assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1) < 0.1
    assert abs(float(a["encoder.enc_norm.weight"].mean()) - 1) < 0.1
    assert isinstance(ReferenceDUSt3R(arch), torch.nn.Module)
