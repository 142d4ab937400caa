"""
The port's UFM-style flow model (uniception_tpu_torch/models/factory/flow.py)
and its flow adaptor against the JAX package on the CPU: FlowAdaptor /
FlowWithConfidenceAdaptor in every scale strategy and in the
normalized-coordinate mode, and UFMFlow.forward_pair with the linear and the
DPT head. Weights go from the port's seeded modules to JAX modules built from
zeros; inputs come from numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.flow import UFMFlow as JaxUFMFlow
from uniception_tpu.models.prediction_heads.adaptors import FlowWithConfidenceAdaptor as JaxFlowAdaptor
from uniception_tpu.models.prediction_heads.base import AdaptorInput as JaxAdaptorInput
from uniception_tpu_torch.models.factory.flow import UFMFlow
from uniception_tpu_torch.models.prediction_heads.adaptors import FlowWithConfidenceAdaptor
from uniception_tpu_torch.models.prediction_heads.base import AdaptorInput
from tests.test_torch_dpt import _carry, _composed_tol

TOL = 5e-5  # fp32 max abs, the repo's parity bar
SMALL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=48, info_sharing_depth=2,
             info_sharing_num_heads=4)
MODES = [
    dict(scale_strategy="none"),
    dict(scale_strategy="scale_width"),
    dict(scale_strategy="scale_height"),
    dict(scale_strategy="scale_both"),
    dict(scale_strategy="scale_both", output_normalized_coordinate=True),
]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "normalized" if len(m) > 1 else m["scale_strategy"])
def test_flow_adaptor_matches_jax(mode):
    kw = dict(name="flow", flow_mean=(0.3, -0.2), flow_std=(2.0, 3.0), base_shape=(16, 24),
              output_normalized_coordinate=False, confidence_type="exp", vmin=1, vmax=float("inf"))
    kw.update(mode)
    x = np.random.RandomState(0).randn(2, 3, 20, 36).astype(np.float32)
    ref = JaxFlowAdaptor(**kw)(JaxAdaptorInput(adaptor_feature=jnp.asarray(x), output_shape_hw=(20, 36)))
    out = FlowWithConfidenceAdaptor(**kw)(AdaptorInput(adaptor_feature=torch.from_numpy(x), output_shape_hw=(20, 36)))
    for got, want in ((out.value, ref.value), (out.confidence, ref.confidence)):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL * max(1.0, float(np.abs(np.asarray(want)).max()))


def test_flow_adaptor_rejects_what_it_does_not_take():
    kw = dict(name="flow", flow_mean=(0, 0), flow_std=(1, 1), base_shape=(8, 8), output_normalized_coordinate=False,
              confidence_type="exp", vmin=1, vmax=float("inf"))
    with pytest.raises(ValueError):
        FlowWithConfidenceAdaptor(scale_strategy="bogus", **kw)(
            AdaptorInput(adaptor_feature=torch.zeros(1, 3, 4, 4), output_shape_hw=(4, 4)))
    with pytest.raises(ValueError):
        FlowWithConfidenceAdaptor(scale_strategy="none", **kw).value_adaptor(
            AdaptorInput(adaptor_feature=torch.zeros(1, 3, 4, 4), output_shape_hw=(4, 4)))


@pytest.mark.parametrize("head,mode", [("linear", MODES[1]), ("dpt", MODES[3]), ("dpt", MODES[4])],
                         ids=["linear-scale_width", "dpt", "dpt-normalized"])
def test_ufm_flow_matches_jax(head, mode):
    kw = dict(name="ufm", img_size=(32, 48), pred_head_type=head, flow_mean=(0.1, 0.2), flow_std=(1.5, 0.5),
              flow_base_shape=(16, 32), **mode, **SMALL)
    jmod, tmod = _carry(lambda: JaxUFMFlow(rngs=nnx.Rngs(0), **kw),
                        UFMFlow(generator=torch.Generator().manual_seed(1), **kw))
    rng = np.random.RandomState(2)
    img1, img2 = (rng.randn(2, 3, 32, 48).astype(np.float32) for _ in range(2))
    ref = jmod.forward_pair(jnp.asarray(img1), jnp.asarray(img2))
    with torch.no_grad():
        out = tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2))
    assert sorted(out) == ["flow", "flow_conf"]
    assert tuple(out["flow"].shape) == (2, 32, 48, 2) and tuple(out["flow_conf"].shape) == (2, 32, 48, 1)
    for key in out:
        want = np.asarray(ref[key])
        assert np.abs(out[key].numpy() - want).max() <= _composed_tol(want), key
    assert out["flow_conf"].min().item() >= 1.0


def test_ufm_flow_state_dict_keys_match_jax_export():
    from uniception_tpu.utils.torch_compat import state_dict_from_module
    from tests.test_torch_quant import jax_module

    for head in ("linear", "dpt"):
        kw = dict(name="ufm", img_size=(32, 32), pred_head_type=head, **SMALL)
        exported = state_dict_from_module(jax_module(lambda: JaxUFMFlow(rngs=nnx.Rngs(0), **kw)))
        own = UFMFlow(**kw).state_dict()
        assert sorted(own) == sorted(exported)
        assert all(tuple(v.shape) == exported[k].shape for k, v in own.items())
