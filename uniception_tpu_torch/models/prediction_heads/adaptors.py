"""
Task adaptors: activation and unnormalization from decoded channels to physical quantities (counterpart of
uniception_tpu/models/prediction_heads/adaptors.py; reference uniception/models/prediction_heads/adaptors.py:25-2252).

The whole family: Flow, Scale, Depth, SceneFlow, PointMap, RayOrigins, RayDirections, CamTranslation, Quaternions,
RayMap, Confidence, Covariance2D, Mask, the "Plus" channel-concatenation composites and the ValueWith{Confidence,
Mask, ConfidenceAndMask} families, under the reference's class names and constructor signatures. Every mode the
JAX package takes is taken here: linear / square / exp (and PointMap's z_exp), confidence exp / sigmoid / softmax,
the RayDirections normalisations and z clamp, Covariance2D's exp_tanh.

Stateless elementwise math over (B, C, H, W) tensors (a summary head's (B, C) too, where the mode allows). An
unknown mode raises ValueError when the adaptor is called, as in the JAX package; the JAX package's construction
asserts (vmin < vmax, finite sigmoid bounds, two flow statistics) raise ValueError here, at construction.
"""

import math
from typing import List, Tuple, Union

import torch
from torch import nn

from uniception_tpu_torch.models.prediction_heads.base import (
    AdaptorInput,
    AdaptorOutput,
    Covariance2DAdaptorOutput,
    MaskAdaptorOutput,
    RegressionAdaptorOutput,
    RegressionWithConfidenceAdaptorOutput,
    RegressionWithConfidenceAndMaskAdaptorOutput,
    RegressionWithMaskAdaptorOutput,
    UniCeptionAdaptorBase,
)

__all__ = [
    "FlowAdaptor",
    "ScaleAdaptor",
    "DepthAdaptor",
    "SceneFlowAdaptor",
    "PointMapAdaptor",
    "RayOriginsAdaptor",
    "RayDirectionsAdaptor",
    "RayDirectionsPlusDepthAdaptor",
    "RayDirectionsPlusDepthPlusSceneFlowAdaptor",
    "CamTranslationAdaptor",
    "QuaternionsAdaptor",
    "CamTranslationPlusQuatsAdaptor",
    "RayMapAdaptor",
    "RayMapPlusDepthAdaptor",
    "RayMapPlusDepthPlusQuatsAdaptor",
    "PointMapPlusRayDirectionsPlusDepthAdaptor",
    "ConfidenceAdaptor",
    "Covariance2DAdaptor",
    "MaskAdaptor",
    "ValueWithConfidenceAdaptor",
    "FlowWithConfidenceAdaptor",
    "PointMapWithConfidenceAdaptor",
    "PointMapPlusRayDirectionsPlusDepthWithConfidenceAdaptor",
    "RayDirectionsPlusDepthWithConfidenceAdaptor",
    "RayDirectionsPlusDepthPlusSceneFlowWithConfidenceAdaptor",
    "RayMapPlusDepthWithConfidenceAdaptor",
    "RayMapPlusDepthPlusQuatsWithConfidenceAdaptor",
    "ValueWithMaskAdaptor",
    "PointMapWithMaskAdaptor",
    "PointMapPlusRayDirectionsPlusDepthWithMaskAdaptor",
    "RayDirectionsPlusDepthWithMaskAdaptor",
    "RayDirectionsPlusDepthPlusSceneFlowWithMaskAdaptor",
    "RayMapPlusDepthWithMaskAdaptor",
    "RayMapPlusDepthPlusQuatsWithMaskAdaptor",
    "ValueWithConfidenceAndMaskAdaptor",
    "PointMapWithConfidenceAndMaskAdaptor",
    "PointMapPlusRayDirectionsPlusDepthWithConfidenceAndMaskAdaptor",
    "RayDirectionsPlusDepthWithConfidenceAndMaskAdaptor",
    "RayDirectionsPlusDepthPlusSceneFlowWithConfidenceAndMaskAdaptor",
    "RayMapPlusDepthWithConfidenceAndMaskAdaptor",
    "RayMapPlusDepthPlusQuatsWithConfidenceAndMaskAdaptor",
]

_INF = float("inf")


def _no_bounds(vmin, vmax) -> bool:
    return vmin == -_INF and vmax == _INF


def _clip(x: torch.Tensor, vmin, vmax) -> torch.Tensor:
    "``jnp.clip(x, vmin, vmax)``, skipped when both bounds are infinite."
    return x if _no_bounds(vmin, vmax) else x.clamp(vmin, vmax)


def _mode_scale(x: torch.Tensor, mode: str) -> torch.Tensor:
    "linear / square / exp elementwise scaling (DepthAdaptor semantics, adaptors.py:214-257)."
    if mode == "linear":
        return x
    if mode == "square":
        return x**2
    if mode == "exp":
        return torch.exp(x)
    raise ValueError(f"Invalid mode: {mode}")


def _mode_scale_radial(x: torch.Tensor, mode: str) -> torch.Tensor:
    "Scale the distance to the origin over the channel axis (PointMap / RayOrigins / CamTranslation semantics)."
    if mode == "linear":
        return x
    d = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    unit = x / d.clamp(min=1e-8)
    if mode == "square":
        return unit * d.square()
    if mode == "exp":
        return unit * torch.expm1(d)
    raise ValueError(f"Invalid mode: {mode}")


def _unit_norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-8)


# ---------------------------------------------------------------------------
# Atomic adaptors
# ---------------------------------------------------------------------------


class FlowAdaptor(UniCeptionAdaptorBase):
    """Optical-flow unnormalization (adaptors.py:25-167).

    Default mode: ``x * std * s + mean * s``, the per-axis scale s from ``scale_strategy`` ("none", "scale_width",
    "scale_height", "scale_both") and the output shape against ``base_shape``. ``output_normalized_coordinate``: the
    network predicts target-pixel positions in [-1, 1]; they become pixels, ``0.5 * (x + 1) * (W, H) + 0.5``, and
    the source pixel centres (0.5, 0.5 at the top-left) are subtracted.
    """

    def __init__(
        self,
        name: str,
        flow_mean: Union[Tuple[float, float], List[float]],
        flow_std: Union[Tuple[float, float], List[float]],
        base_shape: Tuple[int, int],
        scale_strategy: str,
        output_normalized_coordinate: bool = False,
    ):
        super().__init__(name, required_channels=2)
        self.flow_mean = tuple(float(v) for v in flow_mean)
        self.flow_std = tuple(float(v) for v in flow_std)
        if len(self.flow_mean) != 2 or len(self.flow_std) != 2:
            raise ValueError("flow_mean and flow_std need two entries (x, y)")
        self.base_shape = list(base_shape)
        self.scale_strategy = scale_strategy
        self.output_normalized_coordinate = output_normalized_coordinate

    def _get_xy_scale(self, output_shape):
        if self.scale_strategy == "none":
            return 1.0, 1.0
        if self.scale_strategy == "scale_width":
            s = output_shape[1] / self.base_shape[1]
            return s, s
        if self.scale_strategy == "scale_height":
            s = output_shape[0] / self.base_shape[0]
            return s, s
        if self.scale_strategy == "scale_both":
            return output_shape[1] / self.base_shape[1], output_shape[0] / self.base_shape[0]
        raise ValueError(f"Invalid scaling strategy: {self.scale_strategy}")

    def forward(self, adaptor_input: AdaptorInput) -> RegressionAdaptorOutput:
        x = adaptor_input.adaptor_feature
        if x.shape[1] != 2:
            raise ValueError(f"FlowAdaptor requires BCHW format with 2 channels, got {x.shape[1]}")
        H, W = adaptor_input.output_shape_hw
        if not self.output_normalized_coordinate:
            scale = torch.tensor(self._get_xy_scale((H, W)), dtype=x.dtype, device=x.device).view(1, 2, 1, 1)
            mean = torch.tensor(self.flow_mean, dtype=x.dtype, device=x.device).view(1, 2, 1, 1) * scale
            std = torch.tensor(self.flow_std, dtype=x.dtype, device=x.device).view(1, 2, 1, 1) * scale
            return RegressionAdaptorOutput(value=x * std + mean)
        wh = torch.tensor([W, H], dtype=torch.float32, device=x.device).view(1, 2, 1, 1)
        x = 0.5 * (x + 1) * wh + 0.5
        xs = torch.arange(W, dtype=torch.float32, device=x.device) + 0.5
        ys = torch.arange(H, dtype=torch.float32, device=x.device) + 0.5
        coords = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=0)[None]  # (1, 2, H, W)
        return RegressionAdaptorOutput(value=x - coords)


class _ScaledAdaptor(UniCeptionAdaptorBase):
    "An elementwise linear / square / exp adaptor clipped to [vmin, vmax]; ``radial`` scales the norm instead."

    radial = False
    output_type = RegressionAdaptorOutput

    def __init__(self, name: str, required_channels: int, mode: str, vmin: float, vmax: float):
        super().__init__(name, required_channels=required_channels)
        self.mode, self.vmin, self.vmax = mode, vmin, vmax
        self.no_bounds = _no_bounds(vmin, vmax)

    def forward(self, adaptor_input: AdaptorInput):
        scale = _mode_scale_radial if self.radial else _mode_scale
        return self.output_type(value=_clip(scale(adaptor_input.adaptor_feature, self.mode), self.vmin, self.vmax))


class ScaleAdaptor(_ScaledAdaptor):
    "Scalar scale-factor prediction (adaptors.py:170-211)."

    output_type = AdaptorOutput

    def __init__(self, name: str, mode: str, vmin: float = 0, vmax: float = _INF):
        super().__init__(name, 1, mode, vmin, vmax)


class DepthAdaptor(_ScaledAdaptor):
    "Depth activation (adaptors.py:214-257)."

    def __init__(self, name: str, mode: str, vmin: float = 0, vmax: float = _INF):
        super().__init__(name, 1, mode, vmin, vmax)


class SceneFlowAdaptor(_ScaledAdaptor):
    "Scene-flow activation (adaptors.py:260-296)."

    def __init__(self, name: str, mode: str, vmin: float = -_INF, vmax: float = _INF):
        super().__init__(name, 3, mode, vmin, vmax)


class PointMapAdaptor(_ScaledAdaptor):
    """Pointmap activation (adaptors.py:299-355): the distance to the origin scaled by the mode (exp: expm1(d)), or
    "z_exp": z becomes exp(z) and x, y are multiplied by it."""

    radial = True

    def __init__(self, name: str, mode: str, vmin: float = -_INF, vmax: float = _INF):
        super().__init__(name, 3, mode, vmin, vmax)

    def forward(self, adaptor_input: AdaptorInput) -> RegressionAdaptorOutput:
        if self.mode != "z_exp":
            return super().forward(adaptor_input)
        xyz = adaptor_input.adaptor_feature
        z = torch.exp(xyz[:, 2:3])
        return RegressionAdaptorOutput(value=_clip(torch.cat([xyz[:, :2] * z, z], dim=1), self.vmin, self.vmax))


class RayOriginsAdaptor(_ScaledAdaptor):
    "Ray-origins activation (adaptors.py:358-406)."

    radial = True

    def __init__(self, name: str, mode: str, vmin: float = -_INF, vmax: float = _INF):
        super().__init__(name, 3, mode, vmin, vmax)


class CamTranslationAdaptor(_ScaledAdaptor):
    "Camera-translation activation (adaptors.py:609-657)."

    radial = True
    output_type = AdaptorOutput

    def __init__(self, name: str, mode: str, vmin: float = -_INF, vmax: float = _INF):
        super().__init__(name, 3, mode, vmin, vmax)


class RayDirectionsAdaptor(UniCeptionAdaptorBase):
    """Ray-directions activation (adaptors.py:409-484): "linear" only (another mode raises ValueError when called),
    clipped to [vmin, vmax], z clamped to at least ``z_dir_min`` with ``clamp_min_of_z_dir``, then normalised to the
    unit sphere or, failing that, to the unit image plane (divided by z)."""

    def __init__(
        self,
        name: str,
        mode: str,
        normalize_to_unit_sphere: bool,
        normalize_to_unit_image_plane: bool,
        vmin: float = -_INF,
        vmax: float = _INF,
        clamp_min_of_z_dir: bool = False,
        z_dir_min: float = 1,
    ):
        super().__init__(name, required_channels=3)
        self.mode = mode
        self.normalize_to_unit_sphere = normalize_to_unit_sphere
        self.normalize_to_unit_image_plane = normalize_to_unit_image_plane
        self.vmin, self.vmax = vmin, vmax
        self.clamp_min_of_z_dir = clamp_min_of_z_dir
        self.z_dir_min = z_dir_min
        self.no_bounds = _no_bounds(vmin, vmax)

    def forward(self, adaptor_input: AdaptorInput) -> RegressionAdaptorOutput:
        if self.mode != "linear":
            raise ValueError(f"Invalid mode: {self.mode}")
        out = _clip(adaptor_input.adaptor_feature, self.vmin, self.vmax)
        if self.clamp_min_of_z_dir:
            out = torch.cat([out[:, :2], out[:, 2:3].clamp(min=self.z_dir_min)], dim=1)
        if self.normalize_to_unit_sphere:
            out = _unit_norm(out)
        elif self.normalize_to_unit_image_plane:
            out = out / out[:, 2:3]
        return RegressionAdaptorOutput(value=out)


class QuaternionsAdaptor(UniCeptionAdaptorBase):
    "Quaternion (x, y, z, w) activation (adaptors.py:660-708): \"linear\" only, clipped, optionally unit-normalised."

    def __init__(self, name: str, mode: str, normalize: bool, vmin: float = -_INF, vmax: float = _INF):
        super().__init__(name, required_channels=4)
        self.mode, self.normalize = mode, normalize
        self.vmin, self.vmax = vmin, vmax
        self.no_bounds = _no_bounds(vmin, vmax)

    def forward(self, adaptor_input: AdaptorInput) -> AdaptorOutput:
        if self.mode != "linear":
            raise ValueError(f"Invalid mode: {self.mode}")
        out = _clip(adaptor_input.adaptor_feature, self.vmin, self.vmax)
        return AdaptorOutput(value=_unit_norm(out) if self.normalize else out)


class ConfidenceAdaptor(UniCeptionAdaptorBase):
    """Confidence activation (adaptors.py:1035-1096): "exp" is vmin + min(exp(x), vmax - vmin); "sigmoid" is
    sigmoid(x) * (vmax - vmin) + vmin, with finite bounds and vmin >= 0; "softmax" is a softmax over all H * W
    pixels of each channel, times H * W."""

    def __init__(self, name: str, confidence_type: str, vmin: float, vmax: float):
        super().__init__(name, required_channels=1)
        if not vmin < vmax:
            raise ValueError("vmin must be less than vmax")
        if confidence_type == "sigmoid" and not (math.isfinite(vmin) and math.isfinite(vmax) and vmin >= 0):
            raise ValueError("vmin and vmax must be finite, and vmin >= 0, for sigmoid confidence")
        self.confidence_type = confidence_type
        self.vmin, self.vmax = vmin, vmax

    def forward(self, adaptor_input: AdaptorInput) -> RegressionAdaptorOutput:
        x = adaptor_input.adaptor_feature
        if self.confidence_type == "exp":
            return RegressionAdaptorOutput(value=self.vmin + torch.exp(x).clamp(max=self.vmax - self.vmin))
        if self.confidence_type == "sigmoid":
            return RegressionAdaptorOutput(value=torch.sigmoid(x) * (self.vmax - self.vmin) + self.vmin)
        if self.confidence_type == "softmax":
            B, C, H, W = x.shape
            conf = torch.softmax(x.reshape(B, C, H * W), dim=-1).reshape(B, C, H, W) * (H * W)
            return RegressionAdaptorOutput(value=conf)
        raise ValueError(f"Invalid confidence type: {self.confidence_type}")


class Covariance2DAdaptor(UniCeptionAdaptorBase):
    """2D covariance from its (c1, c2, s) log representation, "exp_tanh" (adaptors.py:1099-1166): variances exp(c1),
    exp(c2), covariance tanh(s) exp((c1 + c2) / 2), with the log determinant and the inverse. ``low_confidence_init``
    shifts c1 and c2 by 8 first."""

    def __init__(self, name: str, parametrization: str = "exp_tanh", low_confidence_init: bool = False):
        super().__init__(name, required_channels=3)
        self.parametrization = parametrization
        self.low_confidence_init = low_confidence_init

    def forward(self, adaptor_input: AdaptorInput) -> Covariance2DAdaptorOutput:
        return self._decode(adaptor_input.adaptor_feature, self.parametrization, self.low_confidence_init)

    @staticmethod
    def _decode(x: torch.Tensor, parametrization: str, shift_init: bool) -> Covariance2DAdaptorOutput:
        if parametrization != "exp_tanh":
            raise ValueError(f"Invalid parametrization: {parametrization}")
        c1, c2, s = x[:, 0:1], x[:, 1:2], x[:, 2:3]
        if shift_init:
            c1, c2 = c1 + 8, c2 + 8
        diag_exponent = (c1 + c2) / 2
        tanh_s = torch.tanh(s)
        one_minus = 1 - tanh_s.square() + 1e-8
        cov = torch.cat([torch.exp(c1), torch.exp(c2), tanh_s * torch.exp(diag_exponent)], dim=1)
        log_det = c1 + c2 + torch.log(one_minus)
        inv_cov = (1 / one_minus) * torch.cat([torch.exp(-c1), torch.exp(-c2), -tanh_s * torch.exp(-diag_exponent)],
                                               dim=1)
        return Covariance2DAdaptorOutput(covariance=cov, log_det=log_det, inv_covariance=inv_cov, log_representation=x)

    @classmethod
    def decode(cls, x: torch.Tensor, representation: str) -> Covariance2DAdaptorOutput:
        "Standalone decode with the low-confidence shift (adaptors.py:1141-1166)."
        return cls._decode(x, representation, shift_init=True)


class MaskAdaptor(UniCeptionAdaptorBase):
    "Mask logits and their sigmoid (adaptors.py:1169-1186)."

    def __init__(self, name: str):
        super().__init__(name, required_channels=1)

    def forward(self, adaptor_input: AdaptorInput) -> MaskAdaptorOutput:
        x = adaptor_input.adaptor_feature
        return MaskAdaptorOutput(logits=x, mask=torch.sigmoid(x))


# ---------------------------------------------------------------------------
# Channel-concatenation composites ("Plus" adaptors)
# ---------------------------------------------------------------------------


class _ConcatAdaptor(UniCeptionAdaptorBase):
    "Split the channels, run the sub-adaptors, concatenate their values (the 'Plus' pattern)."

    output_type = RegressionAdaptorOutput

    def __init__(self, name: str, sub_adaptors):
        super().__init__(name, required_channels=sum(a.required_channels for a in sub_adaptors))
        self.sub_adaptors = nn.ModuleList(sub_adaptors)

    def forward(self, adaptor_input: AdaptorInput):
        feats, hw = adaptor_input.adaptor_feature, adaptor_input.output_shape_hw
        outs, off = [], 0
        for sub in self.sub_adaptors:
            outs.append(sub(AdaptorInput(feats[:, off:off + sub.required_channels], hw)).value)
            off += sub.required_channels
        return self.output_type(value=torch.cat(outs, dim=1))


def _ray_directions(name, kw):
    return RayDirectionsAdaptor(
        name,
        kw["ray_directions_mode"],
        kw["ray_directions_normalize_to_unit_sphere"],
        kw["ray_directions_normalize_to_unit_image_plane"],
        kw["ray_directions_vmin"],
        kw["ray_directions_vmax"],
        kw["ray_directions_clamp_min_of_z_dir"],
        kw["ray_directions_z_dir_min"],
    )


def _depth(name, kw):
    return DepthAdaptor(name, kw["depth_mode"], kw["depth_vmin"], kw["depth_vmax"])


def _ray_origins(name, kw):
    return RayOriginsAdaptor(name, kw["ray_origins_mode"], kw["ray_origins_vmin"], kw["ray_origins_vmax"])


def _quaternions(name, kw):
    return QuaternionsAdaptor(name, kw["quaternions_mode"], kw["quaternions_normalize"], kw["quaternions_vmin"],
                              kw["quaternions_vmax"])


class RayDirectionsPlusDepthAdaptor(_ConcatAdaptor):
    "RayDirections (3) + Depth (1) (adaptors.py:485-539)."

    def __init__(self, name: str, **kw):
        super().__init__(name, [_ray_directions(name, kw), _depth(name, kw)])


class RayDirectionsPlusDepthPlusSceneFlowAdaptor(_ConcatAdaptor):
    "RayDirections (3) + Depth (1) + SceneFlow (3) (adaptors.py:542-606)."

    def __init__(self, name: str, **kw):
        scene_flow = SceneFlowAdaptor(name, kw["scene_flow_mode"], kw["scene_flow_vmin"], kw["scene_flow_vmax"])
        super().__init__(name, [_ray_directions(name, kw), _depth(name, kw), scene_flow])


class CamTranslationPlusQuatsAdaptor(_ConcatAdaptor):
    "CamTranslation (3) + Quaternions (4) (adaptors.py:711-755); an AdaptorOutput."

    output_type = AdaptorOutput

    def __init__(self, name: str, **kw):
        trans = CamTranslationAdaptor(name, kw["cam_trans_mode"], kw["cam_trans_vmin"], kw["cam_trans_vmax"])
        super().__init__(name, [trans, _quaternions(name, kw)])


class RayMapAdaptor(_ConcatAdaptor):
    "RayOrigins (3) + RayDirections (3) (adaptors.py:758-814)."

    def __init__(self, name: str, **kw):
        super().__init__(name, [_ray_origins(name, kw), _ray_directions(name, kw)])


class RayMapPlusDepthAdaptor(_ConcatAdaptor):
    "RayOrigins (3) + RayDirections (3) + Depth (1) (adaptors.py:817-880)."

    def __init__(self, name: str, **kw):
        super().__init__(name, [_ray_origins(name, kw), _ray_directions(name, kw), _depth(name, kw)])


class RayMapPlusDepthPlusQuatsAdaptor(_ConcatAdaptor):
    "RayOrigins (3) + RayDirections (3) + Depth (1) + Quaternions (4) (adaptors.py:883-968)."

    def __init__(self, name: str, **kw):
        super().__init__(name, [_ray_origins(name, kw), _ray_directions(name, kw), _depth(name, kw),
                                _quaternions(name, kw)])


class PointMapPlusRayDirectionsPlusDepthAdaptor(_ConcatAdaptor):
    "PointMap (3) + RayDirections (3) + Depth (1) (adaptors.py:971-1032)."

    def __init__(self, name: str, **kw):
        pointmap = PointMapAdaptor(name, kw["pointmap_mode"], kw["pointmap_vmin"], kw["pointmap_vmax"])
        super().__init__(name, [pointmap, _ray_directions(name, kw), _depth(name, kw)])


# ---------------------------------------------------------------------------
# ValueWith{Confidence, Mask, ConfidenceAndMask} families
# ---------------------------------------------------------------------------


class ValueWithConfidenceAdaptor(UniCeptionAdaptorBase):
    "Value + confidence channel split (adaptors.py:1189-1230)."

    def __init__(self, name: str, value_adaptor, confidence_adaptor):
        super().__init__(name, required_channels=value_adaptor.required_channels + confidence_adaptor.required_channels)
        self.value_adaptor = value_adaptor
        self.confidence_adaptor = confidence_adaptor

    def forward(self, adaptor_input: AdaptorInput) -> RegressionWithConfidenceAdaptorOutput:
        nv = self.value_adaptor.required_channels
        feats, hw = adaptor_input.adaptor_feature, adaptor_input.output_shape_hw
        value = self.value_adaptor(AdaptorInput(feats[:, :nv], hw)).value
        confidence = self.confidence_adaptor(AdaptorInput(feats[:, nv:], hw)).value
        return RegressionWithConfidenceAdaptorOutput(value=value, confidence=confidence)


class ValueWithMaskAdaptor(UniCeptionAdaptorBase):
    "Value + mask channel split (adaptors.py:1592-1633)."

    def __init__(self, name: str, value_adaptor, mask_adaptor):
        super().__init__(name, required_channels=value_adaptor.required_channels + mask_adaptor.required_channels)
        self.value_adaptor = value_adaptor
        self.mask_adaptor = mask_adaptor

    def forward(self, adaptor_input: AdaptorInput) -> RegressionWithMaskAdaptorOutput:
        nv = self.value_adaptor.required_channels
        feats, hw = adaptor_input.adaptor_feature, adaptor_input.output_shape_hw
        value = self.value_adaptor(AdaptorInput(feats[:, :nv], hw)).value
        mask = self.mask_adaptor(AdaptorInput(feats[:, nv:], hw))
        return RegressionWithMaskAdaptorOutput(value=value, logits=mask.logits, mask=mask.mask)


class ValueWithConfidenceAndMaskAdaptor(UniCeptionAdaptorBase):
    "Value + confidence + mask channel split (adaptors.py:1913-1969)."

    def __init__(self, name: str, value_adaptor, confidence_adaptor, mask_adaptor):
        super().__init__(name, required_channels=value_adaptor.required_channels
                         + confidence_adaptor.required_channels + mask_adaptor.required_channels)
        self.value_adaptor = value_adaptor
        self.confidence_adaptor = confidence_adaptor
        self.mask_adaptor = mask_adaptor

    def forward(self, adaptor_input: AdaptorInput) -> RegressionWithConfidenceAndMaskAdaptorOutput:
        nv = self.value_adaptor.required_channels
        nc = self.confidence_adaptor.required_channels
        feats, hw = adaptor_input.adaptor_feature, adaptor_input.output_shape_hw
        value = self.value_adaptor(AdaptorInput(feats[:, :nv], hw)).value
        confidence = self.confidence_adaptor(AdaptorInput(feats[:, nv:nv + nc], hw)).value
        mask = self.mask_adaptor(AdaptorInput(feats[:, nv + nc:], hw))
        return RegressionWithConfidenceAndMaskAdaptorOutput(value=value, confidence=confidence, logits=mask.logits,
                                                            mask=mask.mask)


def _confidence_from_kw(name, kw):
    "The confidence adaptor of a composite, its three keywords popped from ``kw``."
    return ConfidenceAdaptor(f"{name}_confidence", kw.pop("confidence_type"), kw.pop("confidence_vmin"),
                             kw.pop("confidence_vmax"))


def _mask(name):
    return MaskAdaptor(f"{name}_mask")


# --- WithConfidence family (adaptors.py:1233-1592) ---


class FlowWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, flow_mean, flow_std, base_shape, scale_strategy, output_normalized_coordinate,
                 confidence_type, vmin, vmax):
        value = FlowAdaptor(name, flow_mean, flow_std, base_shape, scale_strategy, output_normalized_coordinate)
        super().__init__(name, value, ConfidenceAdaptor(f"{name}_confidence", confidence_type, vmin, vmax))


class PointMapWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, pointmap_mode, pointmap_vmin, pointmap_vmax,
                 confidence_type, confidence_vmin, confidence_vmax):
        value = PointMapAdaptor(name, pointmap_mode, pointmap_vmin, pointmap_vmax)
        conf = ConfidenceAdaptor(f"{name}_confidence", confidence_type, confidence_vmin, confidence_vmax)
        super().__init__(name, value, conf)


class PointMapPlusRayDirectionsPlusDepthWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, PointMapPlusRayDirectionsPlusDepthAdaptor(name, **kw), conf)


class RayDirectionsPlusDepthWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, RayDirectionsPlusDepthAdaptor(name, **kw), conf)


class RayDirectionsPlusDepthPlusSceneFlowWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, RayDirectionsPlusDepthPlusSceneFlowAdaptor(name, **kw), conf)


class RayMapPlusDepthWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, RayMapPlusDepthAdaptor(name, **kw), conf)


class RayMapPlusDepthPlusQuatsWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, RayMapPlusDepthPlusQuatsAdaptor(name, **kw), conf)


# --- WithMask family (adaptors.py:1636-1910) ---


class PointMapWithMaskAdaptor(ValueWithMaskAdaptor):
    def __init__(self, name: str, pointmap_mode, pointmap_vmin, pointmap_vmax):
        super().__init__(name, PointMapAdaptor(name, pointmap_mode, pointmap_vmin, pointmap_vmax), _mask(name))


class PointMapPlusRayDirectionsPlusDepthWithMaskAdaptor(ValueWithMaskAdaptor):
    def __init__(self, name: str, **kw):
        super().__init__(name, PointMapPlusRayDirectionsPlusDepthAdaptor(name, **kw), _mask(name))


class RayDirectionsPlusDepthWithMaskAdaptor(ValueWithMaskAdaptor):
    def __init__(self, name: str, **kw):
        super().__init__(name, RayDirectionsPlusDepthAdaptor(name, **kw), _mask(name))


class RayDirectionsPlusDepthPlusSceneFlowWithMaskAdaptor(ValueWithMaskAdaptor):
    def __init__(self, name: str, **kw):
        super().__init__(name, RayDirectionsPlusDepthPlusSceneFlowAdaptor(name, **kw), _mask(name))


class RayMapPlusDepthWithMaskAdaptor(ValueWithMaskAdaptor):
    def __init__(self, name: str, **kw):
        super().__init__(name, RayMapPlusDepthAdaptor(name, **kw), _mask(name))


class RayMapPlusDepthPlusQuatsWithMaskAdaptor(ValueWithMaskAdaptor):
    def __init__(self, name: str, **kw):
        super().__init__(name, RayMapPlusDepthPlusQuatsAdaptor(name, **kw), _mask(name))


# --- WithConfidenceAndMask family (adaptors.py:1972-2320) ---


class PointMapWithConfidenceAndMaskAdaptor(ValueWithConfidenceAndMaskAdaptor):
    def __init__(self, name: str, pointmap_mode, pointmap_vmin, pointmap_vmax,
                 confidence_type, confidence_vmin, confidence_vmax):
        value = PointMapAdaptor(name, pointmap_mode, pointmap_vmin, pointmap_vmax)
        conf = ConfidenceAdaptor(f"{name}_confidence", confidence_type, confidence_vmin, confidence_vmax)
        super().__init__(name, value, conf, _mask(name))


class PointMapPlusRayDirectionsPlusDepthWithConfidenceAndMaskAdaptor(ValueWithConfidenceAndMaskAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, PointMapPlusRayDirectionsPlusDepthAdaptor(name, **kw), conf, _mask(name))


class RayDirectionsPlusDepthWithConfidenceAndMaskAdaptor(ValueWithConfidenceAndMaskAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, RayDirectionsPlusDepthAdaptor(name, **kw), conf, _mask(name))


class RayDirectionsPlusDepthPlusSceneFlowWithConfidenceAndMaskAdaptor(ValueWithConfidenceAndMaskAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, RayDirectionsPlusDepthPlusSceneFlowAdaptor(name, **kw), conf, _mask(name))


class RayMapPlusDepthWithConfidenceAndMaskAdaptor(ValueWithConfidenceAndMaskAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, RayMapPlusDepthAdaptor(name, **kw), conf, _mask(name))


class RayMapPlusDepthPlusQuatsWithConfidenceAndMaskAdaptor(ValueWithConfidenceAndMaskAdaptor):
    def __init__(self, name: str, **kw):
        conf = _confidence_from_kw(name, kw)
        super().__init__(name, RayMapPlusDepthPlusQuatsAdaptor(name, **kw), conf, _mask(name))
