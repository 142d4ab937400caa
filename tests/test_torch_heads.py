"""
The port's prediction heads against the JAX package on the CPU, in fp32: MLPFeature, MLPHead, PoseHead, GlobalHead,
MoGeConvFeature (square and non-square) and its UV plane, DPTSegmentationProcessor, DPTFeatureDoubleUpsampling,
DPTOutputAdapter and DPTFeature with batch norm; then the slice as a whole at a small size, a 2-block DINOv2-S IFR
-> DPT + regression processor + AdaptorMap, and -> PoseHead + CamTranslationPlusQuatsAdaptor. Each JAX module is
built from seeded numpy weights and carried across by ``state_dict_from_module`` -> ``load_state_dict_numpy``
(strict); its batch-norm statistics, which the JAX export leaves out, are set on both sides. Inputs come from numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.encoders import dinov2 as jdinov2
from uniception_tpu.models.encoders.base import ViTEncoderInput as JaxViTEncoderInput
from uniception_tpu.models.prediction_heads import adaptors as jad
from uniception_tpu.models.prediction_heads import dpt as jdpt
from uniception_tpu.models.prediction_heads import base as jbase
from uniception_tpu.models.prediction_heads import mlp_feature as jmlpf
from uniception_tpu.models.prediction_heads import mlp_head as jmlph
from uniception_tpu.models.prediction_heads import moge_conv as jmoge
from uniception_tpu.models.prediction_heads import pose_head as jpose
from uniception_tpu.nn import dpt_parts as jparts
from uniception_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from uniception_tpu.utils.torch_compat import _leaf_entries, state_dict_from_module
from uniception_tpu_torch.models.encoders import dinov2
from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
from uniception_tpu_torch.models.prediction_heads import adaptors as tad
from uniception_tpu_torch.models.prediction_heads import base as tbase
from uniception_tpu_torch.models.prediction_heads import dpt as tdpt
from uniception_tpu_torch.models.prediction_heads import global_head as tglobal
from uniception_tpu_torch.models.prediction_heads import mlp_feature as tmlpf
from uniception_tpu_torch.models.prediction_heads import mlp_head as tmlph
from uniception_tpu_torch.models.prediction_heads import moge_conv as tmoge
from uniception_tpu_torch.models.prediction_heads import pose_head as tpose
from uniception_tpu_torch.nn import dpt_parts as tparts
from uniception_tpu_torch.utils.weights import load_state_dict_numpy
from tests.test_torch_quant import jax_module

TOL = 5e-5  # fp32 max abs per component, the repo's parity bar
INF = float("inf")

# the JAX modules' forward, compiled: one compile costs a fraction of an eager call's op-by-op compiles on the CPU
_jax_forward = nnx.jit(lambda m, *args: m(*args))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    "Two intra-op threads: small CPU modules in several test workers (see tests/test_torch_training_paths.py)."
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def seeded_jax(ctor, seed=0):
    """The JAX module ``ctor()`` builds, every parameter drawn from numpy with ``seed`` (no initializer compiled):
    norm scales and LayerScale gammas around 1, the DiffTransformer lambdas at 0.1, the rest around 0 at about
    1/sqrt(fan-in)."""
    jmod = jax_module(ctor)
    rng = np.random.RandomState(seed)
    for dotted, _, attr, var in _leaf_entries(jmod):
        shape = tuple(var.shape)
        if attr.startswith("lambda_"):
            arr = rng.randn(*shape) * 0.1
        elif attr in ("scale", "gamma") or (attr == "weight" and len(shape) == 1):
            arr = 1.0 + rng.randn(*shape) * 0.2
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
            arr = rng.randn(*shape) * 0.5 / np.sqrt(max(fan_in, 1))
        var.set_value(jnp.asarray(arr.astype(np.float32)))
    return jmod


def carry(jmod, tmod, seed=1):
    """Load the JAX module's export strictly into the port module; every nnx.BatchNorm's running statistics (not in
    the export) are drawn from numpy and set on both. Returns the port module in eval mode."""
    arrays = state_dict_from_module(jmod)
    rng = np.random.RandomState(seed)
    for path, mod in nnx.iter_modules(jmod):
        if isinstance(mod, nnx.BatchNorm):
            key = ".".join(str(p) for p in path)
            mean = (rng.randn(*mod.mean.shape) * 0.3).astype(np.float32)
            var = (0.5 + rng.rand(*mod.var.shape)).astype(np.float32)
            mod.mean.set_value(jnp.asarray(mean))
            mod.var.set_value(jnp.asarray(var))
            arrays.update({f"{key}.running_mean": mean, f"{key}.running_var": var,
                           f"{key}.num_batches_tracked": np.zeros((), np.int64)})
    load_state_dict_numpy(tmod, arrays)
    return tmod.eval()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol, err


def _feats(rng, shapes):
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    return arrays, [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def test_mlp_feature_matches_jax():
    kw = dict(input_feature_dim="16*2", patch_size=4, output_dim=3)
    jmod = seeded_jax(lambda: jmlpf.MLPFeature(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tmlpf.MLPFeature(**kw))
    assert tmod.input_feature_dim == 32 and tmlpf.feature_dim("768*2") == 1536
    _, (x,), (jx,) = _feats(np.random.RandomState(0), [(2, 32, 3, 5)])
    with torch.no_grad():
        out = tmod(tbase.PredictionHeadInput(last_feature=x)).decoded_channels
    assert tuple(out.shape) == (2, 3, 12, 20)
    _close(out, _jax_forward(jmod, jbase.PredictionHeadInput(last_feature=jx)).decoded_channels)


def test_mlp_head_matches_jax():
    kw = dict(input_feature_dim=24, output_dim=5, num_mlp_layers=3, hidden_dim=40)
    jmod = seeded_jax(lambda: jmlph.MLPHead(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tmlph.MLPHead(**kw))
    _, (x,), (jx,) = _feats(np.random.RandomState(1), [(2, 24, 7)])
    with torch.no_grad():
        out = tmod(tbase.PredictionHeadTokenInput(last_feature=x)).decoded_channels
    assert tuple(out.shape) == (2, 5, 7)
    _close(out, _jax_forward(jmod, jbase.PredictionHeadTokenInput(last_feature=jx)).decoded_channels)


@pytest.mark.parametrize("kind", ["pose", "global"])
def test_summary_heads_match_jax(kind):
    if kind == "pose":
        kw = dict(patch_size=2, input_feature_dim=24, num_resconv_block=2, rot_representation_dim=4)
        jctor, tcls, width = jpose.PoseHead, tpose.PoseHead, 7
    else:
        kw = dict(patch_size=2, input_feature_dim=24, num_resconv_block=1, output_representation_dim=3)
        jctor, tcls, width = jpose.GlobalHead, tglobal.GlobalHead, 3
    jmod = seeded_jax(lambda: jctor(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tcls(**kw))
    _, (x,), (jx,) = _feats(np.random.RandomState(2), [(2, 24, 3, 5)])
    with torch.no_grad():
        out = tmod(tbase.PredictionHeadInput(last_feature=x)).decoded_channels
    assert tuple(out.shape) == (2, width)
    _close(out, _jax_forward(jmod, jbase.PredictionHeadInput(last_feature=jx)).decoded_channels)


def test_res_conv_block_with_a_skip_projection_matches_jax():
    jmod = seeded_jax(lambda: jpose.ResConvBlock(16, 24, rngs=nnx.Rngs(0)))
    tmod = carry(jmod, tpose.ResConvBlock(16, 24))
    (a,), (x,), _ = _feats(np.random.RandomState(3), [(2, 16, 3, 4)])
    with torch.no_grad():
        out = tmod(x)
    _close(out, np.transpose(np.asarray(_jax_forward(jmod, jnp.asarray(a.transpose(0, 2, 3, 1)))), (0, 3, 1, 2)))


@pytest.mark.parametrize("hw", [(37, 49), (24, 24), (5, 3)])
def test_normalized_view_plane_uv_matches_jax(hw):
    h, w = hw
    for aspect in (None, 1.7):
        out = tmoge.normalized_view_plane_uv(w, h, aspect_ratio=aspect)
        ref = np.asarray(jmoge.normalized_view_plane_uv(w, h, aspect_ratio=aspect))
        assert tuple(out.shape) == ref.shape == (h, w, 2)
        assert np.abs(out.numpy() - ref).max() <= 1e-7


@pytest.mark.parametrize("grid,target", [((3, 3), (42, 42)), ((3, 4), (37, 49))], ids=["square", "37x49"])
def test_moge_conv_matches_jax(grid, target):
    kw = dict(patch_size=14, num_features=2, input_feature_dims=24, dim_out=[3, 1], dim_proj=32,
              dim_upsample=[32, 32, 32], num_res_blocks=1, last_res_blocks=1, last_conv_channels=32,
              last_conv_size=3)
    jmod = seeded_jax(lambda: jmoge.MoGeConvFeature(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tmoge.MoGeConvFeature(**kw))
    norm = tmod.upsample_blocks[0][1].layers[0]
    assert isinstance(norm, tmoge.GroupNorm) and norm.eps == 1e-6  # flax's epsilon, not torch's 1e-5
    _, feats, jfeats = _feats(np.random.RandomState(4), [(2, 24, *grid)] * 2)
    with torch.no_grad():
        out = tmod(tbase.PredictionHeadLayeredInput(list_features=feats, target_output_shape=target)).decoded_channels
    ref = _jax_forward(jmod, jbase.PredictionHeadLayeredInput(list_features=jfeats, target_output_shape=target))
    assert tuple(out.shape) == (2, 4, *target)
    _close(out, ref.decoded_channels)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "silu", "elu"])
def test_moge_residual_block_activations_match_jax(activation):
    kw = dict(in_channels=32, out_channels=48, hidden_channels=64, activation=activation)
    jmod = seeded_jax(lambda: jmoge.ResidualConvBlock(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tmoge.ResidualConvBlock(**kw))
    (a,), (x,), _ = _feats(np.random.RandomState(5), [(2, 32, 5, 6)])
    with torch.no_grad():
        out = tmod(x)
    _close(out, np.transpose(np.asarray(_jax_forward(jmod, jnp.asarray(a.transpose(0, 2, 3, 1)))), (0, 3, 1, 2)))


def _dpt_input(x, jx, shape):
    return (tdpt.DPTFeatureInput(features_upsampled_8x=x, target_output_shape=shape),
            jdpt.DPTFeatureInput(features_upsampled_8x=jx, target_output_shape=shape))


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
def test_dpt_segmentation_processor_matches_jax(use_bn):
    kw = dict(input_feature_dim=32, output_dim=3, hidden_dim=24, use_bn=use_bn)
    jmod = seeded_jax(lambda: jdpt.DPTSegmentationProcessor(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tdpt.DPTSegmentationProcessor(**kw))
    _, (x,), (jx,) = _feats(np.random.RandomState(6), [(2, 32, 8, 12)])
    tin, jin = _dpt_input(x, jx, (29, 45))
    tmod.train()  # batch norm keeps its running statistics in training mode too, as nnx.BatchNorm(use_running_average)
    with torch.no_grad():
        out = tmod(tin).decoded_channels
    assert tuple(out.shape) == (2, 3, 29, 45)
    _close(out, _jax_forward(jmod, jin).decoded_channels)


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
def test_dpt_feature_double_upsampling_matches_jax(use_bn):
    kw = dict(patch_size=4, hooks=[0, 1], input_feature_dims=[24, 40], layer_dims=[16, 32], feature_dim=24,
              use_bn=use_bn)
    jmod = seeded_jax(lambda: jdpt.DPTFeatureDoubleUpsampling(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tdpt.DPTFeatureDoubleUpsampling(**kw))
    _, feats, jfeats = _feats(np.random.RandomState(7), [(2, 24, 3, 5), (2, 40, 3, 5)])
    with torch.no_grad():
        out = tmod(tbase.PredictionHeadLayeredInput(list_features=feats, target_output_shape=(12, 20)))
    ref = _jax_forward(jmod, jbase.PredictionHeadLayeredInput(list_features=jfeats, target_output_shape=(12, 20)))
    assert tuple(out.features_upsampled_8x.shape) == (2, 24, 6, 10)
    _close(out.features_upsampled_8x, ref.features_upsampled_8x)


def test_dpt_feature_with_batch_norm_matches_jax():
    kw = dict(patch_size=4, hooks=[0, 1, 2, 3], input_feature_dims=[24, 16, 16, 16], layer_dims=[8, 16, 24, 32],
              feature_dim=16, use_bn=True)
    jmod = seeded_jax(lambda: jdpt.DPTFeature(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tdpt.DPTFeature(**kw))
    assert tmod.scratch.refinenet1.resConfUnit1.conv1.bias is None
    _, feats, jfeats = _feats(np.random.RandomState(8), [(2, 24, 3, 5)] + [(2, 16, 3, 5)] * 3)
    with torch.no_grad():
        out = tmod(tbase.PredictionHeadLayeredInput(list_features=feats, target_output_shape=(12, 20)))
    ref = _jax_forward(jmod, jbase.PredictionHeadLayeredInput(list_features=jfeats, target_output_shape=(12, 20)))
    assert tuple(out.features_upsampled_8x.shape) == (2, 16, 24, 40)
    _close(out.features_upsampled_8x, ref.features_upsampled_8x)


@pytest.mark.parametrize("head_type,use_bn", [("regression", False), ("semseg", False), ("semseg", True)],
                         ids=["regression", "semseg", "semseg_bn"])
def test_dpt_output_adapter_matches_jax(head_type, use_bn):
    kw = dict(num_channels=2, patch_size=4, hooks=(0, 1, 2, 3), layer_dims=(8, 16, 24, 32), feature_dim=16,
              last_dim=8, use_bn=use_bn, dim_tokens_enc=24, head_type=head_type)
    jmod = seeded_jax(lambda: jparts.DPTOutputAdapter(rngs=nnx.Rngs(0), **kw))
    tmod = carry(jmod, tparts.DPTOutputAdapter(**kw))
    _, tokens, jtokens = _feats(np.random.RandomState(9), [(2, 4 * 6, 24)] * 4)
    with torch.no_grad():
        out = tmod(tokens, (16, 24))
    ref = nnx.jit(lambda m, t: m(t, (16, 24)))(jmod, jtokens)  # the image size is static
    assert tuple(out.shape) == (2, 2, 64, 96)
    _close(out, ref)
    with pytest.raises(RuntimeError, match="init"):
        tparts.DPTOutputAdapter(num_channels=1, feature_dim=16, last_dim=8)(tokens, (16, 24))


CHECKPOINTED = {  # (JAX constructor, port constructor) of each head that takes pretrained_checkpoint_path
    "mlp_feature": (lambda **k: jmlpf.MLPFeature(32, 4, 3, rngs=nnx.Rngs(0), **k),
                    lambda **k: tmlpf.MLPFeature(32, 4, 3, **k)),
    "mlp_head": (lambda **k: jmlph.MLPHead(24, 5, rngs=nnx.Rngs(0), **k), lambda **k: tmlph.MLPHead(24, 5, **k)),
    "pose": (lambda **k: jpose.PoseHead(2, 24, rngs=nnx.Rngs(0), **k), lambda **k: tpose.PoseHead(2, 24, **k)),
    "global": (lambda **k: jpose.GlobalHead(2, 24, rngs=nnx.Rngs(0), **k), lambda **k: tglobal.GlobalHead(2, 24, **k)),
    "moge": (lambda **k: jmoge.MoGeConvFeature(14, 2, 24, [3, 1], 32, [32, 32, 32], rngs=nnx.Rngs(0), **k),
             lambda **k: tmoge.MoGeConvFeature(14, 2, 24, [3, 1], 32, [32, 32, 32], **k)),
}


@pytest.mark.parametrize("head", sorted(CHECKPOINTED))
def test_heads_load_a_jax_checkpoint_strictly(head, tmp_path):
    "A head's pretrained_checkpoint_path reads the JAX package's .npz of a seeded JAX head: every tensor equal."
    jctor, tctor = CHECKPOINTED[head]
    arrays = state_dict_from_module(seeded_jax(jctor, seed=11))
    path = str(tmp_path / f"{head}.npz")
    jax_save_checkpoint(path, arrays)
    tmod = tctor(pretrained_checkpoint_path=path)
    own = tmod.state_dict()
    assert sorted(own) == sorted(arrays)
    assert all(np.array_equal(own[k].numpy(), arrays[k]) for k in arrays)


# --- the slice as a whole: DINOv2 IFR -> DPT / pose heads -> adaptors ---

ENCODER = dict(name="dinov2", size="small", with_registers=True, keep_first_n_layers=2, indices=[0, 1])
RAYS = dict(ray_directions_mode="linear", ray_directions_normalize_to_unit_sphere=True,
            ray_directions_normalize_to_unit_image_plane=False, ray_directions_vmin=-INF, ray_directions_vmax=INF,
            ray_directions_clamp_min_of_z_dir=False, ray_directions_z_dir_min=1, depth_mode="exp", depth_vmin=0,
            depth_vmax=INF, confidence_type="sigmoid", confidence_vmin=0.0, confidence_vmax=1.0)
POSE = dict(cam_trans_mode="linear", cam_trans_vmin=-INF, cam_trans_vmax=INF, quaternions_mode="linear",
            quaternions_normalize=True, quaternions_vmin=-INF, quaternions_vmax=INF)


def _slice_modules():
    "(JAX modules, port modules): the encoder, DPTFeature, its regression processor and the pose head."
    dpt_kw = dict(patch_size=14, hooks=[0, 0, 1, 1], input_feature_dims=384, layer_dims=[16, 24, 32, 48],
                  feature_dim=32)
    ctors = [
        (lambda: jdinov2.DINOv2IntermediateFeatureReturner(rngs=nnx.Rngs(0), **ENCODER),
         lambda: dinov2.DINOv2IntermediateFeatureReturner(**ENCODER)),
        (lambda: jdpt.DPTFeature(rngs=nnx.Rngs(0), **dpt_kw), lambda: tdpt.DPTFeature(**dpt_kw)),
        (lambda: jdpt.DPTRegressionProcessor(32, 6, rngs=nnx.Rngs(0)), lambda: tdpt.DPTRegressionProcessor(32, 6)),
        (lambda: jpose.PoseHead(14, 384, rngs=nnx.Rngs(0)), lambda: tpose.PoseHead(14, 384)),
    ]
    jmods, tmods = [], []
    for seed, (jctor, tctor) in enumerate(ctors):
        jmods.append(seeded_jax(jctor, seed))
        tmods.append(carry(jmods[-1], tctor()))
    return jmods, tmods


@nnx.jit
def _jax_slice(enc, feature, regressor, pose, image):
    levels = [o.features for o in enc(JaxViTEncoderInput(image=image, data_norm_type="dinov2"))]
    dense = regressor(feature(jbase.PredictionHeadLayeredInput(list_features=levels, target_output_shape=(28, 42))))
    pose_out = pose(jbase.PredictionHeadInput(last_feature=levels[-1]))
    return dense.decoded_channels, pose_out.decoded_channels


def test_dinov2_to_heads_and_adaptors_slice_matches_jax():
    jmods, tmods = _slice_modules()
    image = np.random.RandomState(10).randn(2, 3, 28, 42).astype(np.float32)
    jdense, jpose_out = _jax_slice(*jmods, jnp.asarray(image))
    jdense_map = jbase.AdaptorMap(jad.RayDirectionsPlusDepthWithConfidenceAndMaskAdaptor("rays", **RAYS))
    jpose_map = jbase.AdaptorMap(jad.CamTranslationPlusQuatsAdaptor("pose", **POSE))
    jrays = jdense_map(jbase.PixelTaskOutput(decoded_channels=jdense))["rays"]
    jcam = jpose_map(jbase.SummaryTaskOutput(decoded_channels=jpose_out))["pose"]

    enc, feature, regressor, pose = tmods
    dense_map = tbase.AdaptorMap(tad.RayDirectionsPlusDepthWithConfidenceAndMaskAdaptor("rays", **RAYS))
    pose_map = tbase.AdaptorMap(tad.CamTranslationPlusQuatsAdaptor("pose", **POSE))
    with torch.no_grad():
        levels = [o.features for o in enc(ViTEncoderInput(image=torch.from_numpy(image), data_norm_type="dinov2"))]
        assert [tuple(f.shape) for f in levels] == [(2, 384, 2, 3)] * 2  # an odd grid: path_4 is cropped
        dense = regressor(feature(tbase.PredictionHeadLayeredInput(list_features=levels,
                                                                   target_output_shape=(28, 42))))
        rays = dense_map(dense)["rays"]
        cam = pose_map(pose(tbase.PredictionHeadInput(last_feature=levels[-1])))["pose"]
    _close(dense.decoded_channels, jdense)
    for name in ("value", "confidence", "logits", "mask"):
        _close(getattr(rays, name), getattr(jrays, name))
    assert tuple(rays.value.shape) == (2, 4, 28, 42) and tuple(cam.value.shape) == (2, 7)
    _close(cam.value, jcam.value)
