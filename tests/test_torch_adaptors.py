"""
The port's adaptors against the JAX package on the CPU: every adaptor class under every mode the JAX package takes
(one parametrised test), AdaptorMap's channel slicing over dense and summary outputs, Covariance2DAdaptor.decode,
the error types and their moment for invalid modes, the package root's exports, and DUSt3R with non-"exp" depth and
confidence modes end to end. Inputs come from numpy; adaptors hold no weights.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import uniception_tpu.models.prediction_heads as jph
from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.prediction_heads import adaptors as jad
from uniception_tpu.models.prediction_heads.base import AdaptorInput as JaxAdaptorInput
from uniception_tpu.models.prediction_heads.base import AdaptorMap as JaxAdaptorMap
from uniception_tpu.models.prediction_heads.base import SummaryTaskOutput as JaxSummaryTaskOutput
from uniception_tpu.utils.torch_compat import state_dict_from_module
import uniception_tpu_torch.models.prediction_heads as tph
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.prediction_heads import adaptors as tad
from uniception_tpu_torch.models.prediction_heads.base import AdaptorInput, AdaptorMap, SummaryTaskOutput
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

TOL = 5e-5  # fp32, per output component, relative to max(1, |ref|): exp modes scale with their output
INF = float("inf")

RAY = dict(ray_directions_mode="linear", ray_directions_normalize_to_unit_sphere=True,
           ray_directions_normalize_to_unit_image_plane=False, ray_directions_vmin=-INF, ray_directions_vmax=INF,
           ray_directions_clamp_min_of_z_dir=False, ray_directions_z_dir_min=1)
RAY_PLANE = {**RAY, "ray_directions_normalize_to_unit_sphere": False,
             "ray_directions_normalize_to_unit_image_plane": True, "ray_directions_clamp_min_of_z_dir": True,
             "ray_directions_z_dir_min": 0.5}
DEPTH = dict(depth_mode="exp", depth_vmin=0, depth_vmax=INF)
DEPTH_SQ = dict(depth_mode="square", depth_vmin=0.1, depth_vmax=4.0)
ORIGINS = dict(ray_origins_mode="linear", ray_origins_vmin=-INF, ray_origins_vmax=INF)
ORIGINS_EXP = dict(ray_origins_mode="exp", ray_origins_vmin=-2.0, ray_origins_vmax=2.0)
QUATS = dict(quaternions_mode="linear", quaternions_normalize=True, quaternions_vmin=-INF, quaternions_vmax=INF)
SCENE_FLOW = dict(scene_flow_mode="linear", scene_flow_vmin=-INF, scene_flow_vmax=INF)
POINTMAP = dict(pointmap_mode="z_exp", pointmap_vmin=-INF, pointmap_vmax=INF)
CONF = dict(confidence_type="exp", confidence_vmin=1, confidence_vmax=INF)
CONF_SIG = dict(confidence_type="sigmoid", confidence_vmin=0.5, confidence_vmax=3.0)
CONF_SOFT = dict(confidence_type="softmax", confidence_vmin=0, confidence_vmax=1)


def _modes(cls, *modes, bounds=((0, INF),)):
    return [(cls, (m,), dict(vmin=lo, vmax=hi)) for m in modes for lo, hi in bounds]


# (class name, positional arguments after the name, keyword arguments): every class under every mode it takes
CASES = (
    [("FlowAdaptor", ((1.0, -2.0), (3.0, 0.5), (4, 6), s), {}) for s in
     ("none", "scale_width", "scale_height", "scale_both")]
    + [("FlowAdaptor", ((0.0, 0.0), (1.0, 1.0), (4, 6), "none"), dict(output_normalized_coordinate=True))]
    + _modes("ScaleAdaptor", "linear", "square", "exp", bounds=((0, INF), (-INF, INF), (0.2, 2.0)))
    + _modes("DepthAdaptor", "linear", "square", "exp", bounds=((0, INF), (-INF, INF), (0.2, 2.0)))
    + _modes("SceneFlowAdaptor", "linear", "square", "exp", bounds=((-INF, INF), (-1.0, 1.0)))
    + _modes("PointMapAdaptor", "linear", "square", "exp", "z_exp", bounds=((-INF, INF), (-1.5, 1.5)))
    + _modes("RayOriginsAdaptor", "linear", "square", "exp", bounds=((-INF, INF), (-1.5, 1.5)))
    + _modes("CamTranslationAdaptor", "linear", "square", "exp", bounds=((-INF, INF), (-1.5, 1.5)))
    + [("RayDirectionsAdaptor", ("linear", sphere, plane), dict(vmin=lo, vmax=hi, clamp_min_of_z_dir=clamp,
                                                                z_dir_min=0.3))
       for sphere, plane in ((True, False), (False, True), (False, False))
       for lo, hi in ((-INF, INF), (-1.0, 1.0)) for clamp in (False, True)]
    + [("QuaternionsAdaptor", ("linear", norm), dict(vmin=lo, vmax=hi))
       for norm in (True, False) for lo, hi in ((-INF, INF), (-0.5, 0.5))]
    + [("ConfidenceAdaptor", ("exp", 1, INF), {}), ("ConfidenceAdaptor", ("exp", 0.5, 4.0), {}),
       ("ConfidenceAdaptor", ("sigmoid", 0, 1), {}), ("ConfidenceAdaptor", ("sigmoid", 0.5, 3.0), {}),
       ("ConfidenceAdaptor", ("softmax", 0, 1), {})]
    + [("Covariance2DAdaptor", (), dict(low_confidence_init=low)) for low in (False, True)]
    + [("MaskAdaptor", (), {})]
    + [("RayDirectionsPlusDepthAdaptor", (), {**RAY, **DEPTH}),
       ("RayDirectionsPlusDepthAdaptor", (), {**RAY_PLANE, **DEPTH_SQ}),
       ("RayDirectionsPlusDepthPlusSceneFlowAdaptor", (), {**RAY, **DEPTH, **SCENE_FLOW}),
       ("CamTranslationPlusQuatsAdaptor", (), dict(cam_trans_mode="exp", cam_trans_vmin=-INF, cam_trans_vmax=INF,
                                                   **QUATS)),
       ("RayMapAdaptor", (), {**ORIGINS, **RAY}),
       ("RayMapPlusDepthAdaptor", (), {**ORIGINS_EXP, **RAY_PLANE, **DEPTH}),
       ("RayMapPlusDepthPlusQuatsAdaptor", (), {**ORIGINS, **RAY, **DEPTH_SQ, **QUATS}),
       ("PointMapPlusRayDirectionsPlusDepthAdaptor", (), {**POINTMAP, **RAY, **DEPTH})]
    + [("FlowWithConfidenceAdaptor", ((1.0, -2.0), (3.0, 0.5), (4, 6), "scale_both", False, "sigmoid", 0.0, 2.0), {}),
       ("PointMapWithConfidenceAdaptor", ("linear", -INF, INF, "sigmoid", 0, 1), {}),
       ("PointMapWithConfidenceAdaptor", ("square", -INF, INF, "exp", 1, INF), {}),
       ("PointMapWithConfidenceAdaptor", ("exp", -INF, INF, "softmax", 0, 1), {}),
       ("PointMapPlusRayDirectionsPlusDepthWithConfidenceAdaptor", (), {**POINTMAP, **RAY, **DEPTH, **CONF}),
       ("RayDirectionsPlusDepthWithConfidenceAdaptor", (), {**RAY, **DEPTH, **CONF_SIG}),
       ("RayDirectionsPlusDepthPlusSceneFlowWithConfidenceAdaptor", (), {**RAY, **DEPTH, **SCENE_FLOW, **CONF}),
       ("RayMapPlusDepthWithConfidenceAdaptor", (), {**ORIGINS, **RAY, **DEPTH, **CONF_SOFT}),
       ("RayMapPlusDepthPlusQuatsWithConfidenceAdaptor", (), {**ORIGINS, **RAY, **DEPTH, **QUATS, **CONF})]
    + [("PointMapWithMaskAdaptor", (mode, -INF, INF), {}) for mode in ("linear", "square", "exp", "z_exp")]
    + [("PointMapPlusRayDirectionsPlusDepthWithMaskAdaptor", (), {**POINTMAP, **RAY, **DEPTH}),
       ("RayDirectionsPlusDepthWithMaskAdaptor", (), {**RAY_PLANE, **DEPTH}),
       ("RayDirectionsPlusDepthPlusSceneFlowWithMaskAdaptor", (), {**RAY, **DEPTH_SQ, **SCENE_FLOW}),
       ("RayMapPlusDepthWithMaskAdaptor", (), {**ORIGINS, **RAY, **DEPTH}),
       ("RayMapPlusDepthPlusQuatsWithMaskAdaptor", (), {**ORIGINS_EXP, **RAY, **DEPTH, **QUATS})]
    + [("PointMapWithConfidenceAndMaskAdaptor", ("z_exp", -INF, INF, "exp", 1, INF), {}),
       ("PointMapWithConfidenceAndMaskAdaptor", ("exp", -2.0, 2.0, "sigmoid", 0, 1), {}),
       ("PointMapPlusRayDirectionsPlusDepthWithConfidenceAndMaskAdaptor", (), {**POINTMAP, **RAY, **DEPTH, **CONF}),
       ("RayDirectionsPlusDepthWithConfidenceAndMaskAdaptor", (), {**RAY, **DEPTH, **CONF_SIG}),
       ("RayDirectionsPlusDepthPlusSceneFlowWithConfidenceAndMaskAdaptor", (),
        {**RAY, **DEPTH, **SCENE_FLOW, **CONF_SOFT}),
       ("RayMapPlusDepthWithConfidenceAndMaskAdaptor", (), {**ORIGINS, **RAY_PLANE, **DEPTH, **CONF}),
       ("RayMapPlusDepthPlusQuatsWithConfidenceAndMaskAdaptor", (), {**ORIGINS, **RAY, **DEPTH, **QUATS, **CONF})]
)


def _outputs(out):
    "The tensor fields of an adaptor output, by name."
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}


def _same(out, ref):
    assert type(out).__name__ == type(ref).__name__
    fields = _outputs(out)
    assert sorted(fields) == sorted(f for f in vars(ref) if not f.startswith("_"))
    for name, got in fields.items():
        want = np.asarray(getattr(ref, name), np.float32)
        got = got.detach().numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), name
        assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= TOL, name


def test_every_adaptor_class_is_exercised():
    assert sorted(tad.__all__) == sorted(jad.__all__)
    assert len(tad.__all__) == 41
    assert {case[0] for case in CASES} | {"ValueWithConfidenceAdaptor", "ValueWithMaskAdaptor",
                                          "ValueWithConfidenceAndMaskAdaptor"} == set(tad.__all__)


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_adaptor_matches_jax(case):
    name, args, kw = case
    tmod, jmod = getattr(tad, name)("a", *args, **dict(kw)), getattr(jad, name)("a", *args, **dict(kw))
    assert tmod.required_channels == jmod.required_channels
    x = (np.random.RandomState(len(name)).randn(2, tmod.required_channels, 4, 6) * 0.7).astype(np.float32)
    with torch.no_grad():
        out = tmod(AdaptorInput(adaptor_feature=torch.from_numpy(x), output_shape_hw=(4, 6)))
    _same(out, jmod(JaxAdaptorInput(adaptor_feature=jnp.asarray(x), output_shape_hw=(4, 6))))


@pytest.mark.parametrize("family", ["ValueWithConfidenceAdaptor", "ValueWithMaskAdaptor",
                                    "ValueWithConfidenceAndMaskAdaptor"])
def test_value_with_families_take_any_value_adaptor(family):
    def parts(mod):
        value = mod.RayOriginsAdaptor("v", "square", -INF, INF)
        conf = mod.ConfidenceAdaptor("c", "sigmoid", 0.0, 2.0)
        mask = mod.MaskAdaptor("m")
        return {"ValueWithConfidenceAdaptor": (value, conf), "ValueWithMaskAdaptor": (value, mask),
                "ValueWithConfidenceAndMaskAdaptor": (value, conf, mask)}[family]

    tmod, jmod = getattr(tad, family)("a", *parts(tad)), getattr(jad, family)("a", *parts(jad))
    x = np.random.RandomState(7).randn(2, tmod.required_channels, 3, 5).astype(np.float32)
    with torch.no_grad():
        out = tmod(AdaptorInput(torch.from_numpy(x), (3, 5)))
    _same(out, jmod(JaxAdaptorInput(jnp.asarray(x), (3, 5))))


def test_adaptor_map_slices_dense_and_summary_outputs():
    def dense(mod):
        return [mod.RayDirectionsPlusDepthWithConfidenceAndMaskAdaptor("rays", **RAY, **DEPTH, **CONF_SIG),
                mod.DepthAdaptor("depth", "linear"), mod.ConfidenceAdaptor("conf", "softmax", 0, 1)]

    def summary(mod):
        return [mod.CamTranslationPlusQuatsAdaptor("pose", cam_trans_mode="linear", cam_trans_vmin=-INF,
                                                   cam_trans_vmax=INF, **QUATS),
                mod.ScaleAdaptor("scale", "exp")]

    rng = np.random.RandomState(3)
    for build, shape in ((dense, (2, 8, 5, 7)), (summary, (2, 8))):
        tmap, jmap = AdaptorMap(*build(tad)), JaxAdaptorMap(*build(jad))
        assert tmap.required_channels == jmap.required_channels == shape[1]
        assert tmap.adaptor_order == jmap.adaptor_order
        x = rng.randn(*shape).astype(np.float32)
        with torch.no_grad():
            by_input = tmap(AdaptorInput(torch.from_numpy(x), shape[2:]))
            by_head = tmap(SummaryTaskOutput(decoded_channels=torch.from_numpy(x)))  # reads .decoded_channels
        ref = jmap(JaxSummaryTaskOutput(decoded_channels=jnp.asarray(x)))
        assert list(by_input) == list(ref) == tmap.adaptor_order
        for name in ref:
            _same(by_input[name], ref[name])
            _same(by_head[name], ref[name])
    assert list(by_head["pose"].value.shape) == [2, 7]  # a (B, C) summary: output_shape_hw = ()


def test_covariance_decode_matches_jax():
    x = np.random.RandomState(5).randn(2, 3, 4, 4).astype(np.float32)
    out = tad.Covariance2DAdaptor.decode(torch.from_numpy(x), "exp_tanh")
    _same(out, jad.Covariance2DAdaptor.decode(jnp.asarray(x), "exp_tanh"))
    shifted = tad.Covariance2DAdaptor("c", low_confidence_init=True)(AdaptorInput(torch.from_numpy(x), (4, 4)))
    assert torch.equal(out.covariance, shifted.covariance)  # decode applies the low-confidence shift
    with pytest.raises(ValueError):
        tad.Covariance2DAdaptor.decode(torch.from_numpy(x), "cholesky")
    with pytest.raises(ValueError):
        jad.Covariance2DAdaptor.decode(jnp.asarray(x), "cholesky")


# (class name, arguments): each constructs in both packages and raises ValueError when called
BAD_AT_CALL = [
    ("DepthAdaptor", ("cube",)), ("ScaleAdaptor", ("cube",)), ("SceneFlowAdaptor", ("cube",)),
    ("PointMapAdaptor", ("cube",)), ("RayOriginsAdaptor", ("cube",)), ("CamTranslationAdaptor", ("cube",)),
    ("RayDirectionsAdaptor", ("exp", True, False)), ("QuaternionsAdaptor", ("exp", True)),
    ("ConfidenceAdaptor", ("tanh", 0, 1)), ("Covariance2DAdaptor", ("cholesky",)),
    ("FlowAdaptor", ((0.0, 0.0), (1.0, 1.0), (4, 6), "scale_diagonal")),
]


@pytest.mark.parametrize("name,args", BAD_AT_CALL, ids=[c[0] for c in BAD_AT_CALL])
def test_invalid_modes_raise_value_error_when_called(name, args):
    tmod, jmod = getattr(tad, name)("a", *args), getattr(jad, name)("a", *args)
    x = np.zeros((1, tmod.required_channels, 2, 2), np.float32)
    with pytest.raises(ValueError):
        tmod(AdaptorInput(torch.from_numpy(x), (2, 2)))
    with pytest.raises(ValueError):
        jmod(JaxAdaptorInput(jnp.asarray(x), (2, 2)))


@pytest.mark.parametrize("args", [("exp", 2, 1), ("sigmoid", 0, INF), ("sigmoid", -1, 1)],
                         ids=["vmin>vmax", "sigmoid-infinite", "sigmoid-negative"])
def test_invalid_confidence_bounds_raise_at_construction(args):
    with pytest.raises(ValueError):
        tad.ConfidenceAdaptor("c", *args)
    with pytest.raises(AssertionError):  # the JAX package asserts at the same moment
        jad.ConfidenceAdaptor("c", *args)


def test_package_root_exports_the_jax_names():
    want = {n for n, v in vars(jph).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert set(tph.__all__) == want and len(tph.__all__) == len(want)
    assert all(hasattr(tph, n) for n in want)


ENC = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4)
DEC = dict(info_sharing_dim=48, info_sharing_depth=2, info_sharing_num_heads=4)


@pytest.mark.parametrize("depth_mode,conf_mode", [(("linear", -INF, INF), ("sigmoid", 0.0, 1.0)),
                                                  (("square", -INF, INF), ("exp", 1, INF)),
                                                  (("z_exp", -5.0, 5.0), ("sigmoid", 1.0, 4.0))],
                         ids=["linear-sigmoid", "square-exp", "z_exp-sigmoid"])
def test_dust3r_with_other_modes_matches_jax(depth_mode, conf_mode):
    kw = dict(name="dust3r", img_size=(32, 48), depth_mode=depth_mode, conf_mode=conf_mode, **ENC, **DEC)
    jmod = JaxDUSt3R(rngs=nnx.Rngs(0), **kw)
    tmod = DUSt3R(**kw)
    load_state_dict_numpy(tmod, state_dict_from_module(jmod))
    rng = np.random.RandomState(2)
    img1, img2 = (rng.randn(2, 3, 32, 48).astype(np.float32) for _ in range(2))
    ref = jmod.forward_pair(jnp.asarray(img1), jnp.asarray(img2))
    with torch.no_grad():
        out = tmod.eval().forward_pair(torch.from_numpy(img1), torch.from_numpy(img2))
    for res, jres in zip(out, ref):
        assert sorted(res) == sorted(jres)
        for key in res:
            want = np.asarray(jres[key])
            got = res[key].numpy()
            assert got.shape == want.shape and np.isfinite(got).all()
            assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= TOL, key
