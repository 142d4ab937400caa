"""
Checkpoint loading in the port (uniception_tpu_torch/utils/checkpoint.py and
the factories' ``pretrained_checkpoint_path``) against the JAX package's files
on the CPU: a seeded DUSt3R (linear and DPT) and UFMFlow saved by the JAX
package's ``save_checkpoint`` (.npz) and as a ``torch.save`` .pth of its
torch-layout state dict load into the port with the same forward, bit for
bit, as ``load_state_dict_numpy``; a DPT .pth that carries the reference's
``head{1,2}.*`` aliases loads strictly; and the port's .npz reads in the JAX
package.
"""

import functools

import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.factory.flow import UFMFlow as JaxUFMFlow
from uniception_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from uniception_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.factory.flow import UFMFlow
from uniception_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from uniception_tpu_torch.utils.weights import load_state_dict_numpy
from tests.test_torch_dpt import _carry

SMALL = dict(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=48,
             info_sharing_depth=2, info_sharing_num_heads=4)
MODELS = {"dust3r": (DUSt3R, JaxDUSt3R), "flow": (UFMFlow, JaxUFMFlow)}


@functools.lru_cache(maxsize=None)
def _jax_state(model, head):
    "A seeded JAX model's torch-layout state dict (numpy), through the port's seeded init."
    cls, jcls = MODELS[model]
    kw = dict(name=model, pred_head_type=head, **SMALL)
    jmod, _ = _carry(lambda: jcls(rngs=nnx.Rngs(0), **kw), cls(generator=torch.Generator().manual_seed(3), **kw))
    return state_dict_from_module(jmod), kw


def _tensors(state):
    return {k: torch.tensor(np.asarray(v)) for k, v in state.items()}


def _forward(model):
    rng = np.random.RandomState(5)
    img1, img2 = (torch.from_numpy(rng.randn(1, 3, 32, 32).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        out = model.forward_pair(img1, img2)
    return [t for res in (out if isinstance(out, tuple) else (out,)) for _, t in sorted(res.items())]


@pytest.mark.parametrize("fmt", ["npz", "pth"])
@pytest.mark.parametrize("model,head", [("dust3r", "linear"), ("dust3r", "dpt"), ("flow", "linear"), ("flow", "dpt")])
def test_pretrained_checkpoint_loads_bit_for_bit(tmp_path, model, head, fmt):
    state, kw = _jax_state(model, head)
    path = str(tmp_path / f"m.{fmt}")
    if fmt == "npz":
        jax_save_checkpoint(path, state, data_norm_type="dust3r")
    else:
        torch.save({"model": _tensors(state)}, path)
    cls = MODELS[model][0]
    loaded = cls(pretrained_checkpoint_path=path, **kw).eval()
    direct = cls(**kw)
    load_state_dict_numpy(direct, state)
    for a, b in zip(_forward(loaded), _forward(direct.eval())):
        assert torch.equal(a, b)


def test_dpt_pth_with_head_aliases_loads_strictly(tmp_path):
    "The reference's DPT state dicts also hold head{1,2}.* (its nn.Sequential of the two head parts)."
    state, kw = _jax_state("dust3r", "dpt")
    state, aliased = dict(state), dict(state)
    for k, v in state.items():
        if k.startswith("dpt_feature_head1."):
            aliased["head1.0." + k[len("dpt_feature_head1."):]] = v
        if k.startswith("dpt_regressor_head2."):
            aliased["head2.1." + k[len("dpt_regressor_head2."):]] = v
    aliased["dpt_feature_head1.scratch.layer1_rn.weight"] = state["dpt_feature_head1.input_process.0.1.weight"]
    path = str(tmp_path / "aliased.pth")
    torch.save(_tensors(aliased), path)  # a bare state dict
    loaded = DUSt3R(pretrained_checkpoint_path=path, **kw)
    assert torch.equal(loaded.state_dict()["dpt_feature_head1.input_process.0.1.weight"],
                       torch.from_numpy(np.asarray(state["dpt_feature_head1.input_process.0.1.weight"])))
    del state["dpt_regressor_head1.conv1.weight"]
    torch.save(_tensors(state), path)
    with pytest.raises(KeyError, match="missing"):  # strict: a missing key still fails
        DUSt3R(pretrained_checkpoint_path=path, **kw)


def test_port_npz_loads_in_jax_and_back(tmp_path):
    model = DUSt3R(name="d", generator=torch.Generator().manual_seed(0), **SMALL)
    state = model.state_dict()
    state["encoder.enc_norm.weight"] = state["encoder.enc_norm.weight"].bfloat16()  # widened to fp32 on save
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, state, data_norm_type="dust3r", step=3)
    ref = jax_load_checkpoint(path)
    mine = load_checkpoint(path)
    assert ref["data_norm_type"] == mine["data_norm_type"] == "dust3r" and mine["step"] == 3
    assert sorted(ref["model"]) == sorted(mine["model"]) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(mine["model"][k], v.float().numpy())
        np.testing.assert_array_equal(ref["model"][k], mine["model"][k])
    with pytest.raises(ValueError):
        save_checkpoint(str(tmp_path / "x.pth"), state)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "x.ckpt"))
