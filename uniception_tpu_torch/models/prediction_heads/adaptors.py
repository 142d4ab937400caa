"""
Task adaptors on the DUSt3R path (counterpart of
uniception_tpu/models/prediction_heads/adaptors.py): FlowAdaptor,
PointMapAdaptor, ConfidenceAdaptor, ValueWithConfidenceAdaptor,
FlowWithConfidenceAdaptor and PointMapWithConfidenceAdaptor. Stateless
elementwise math over (B, C, H, W) tensors.
"""

from typing import List, Tuple, Union

import torch

from uniception_tpu_torch.models.prediction_heads.base import (
    AdaptorInput,
    RegressionAdaptorOutput,
    RegressionWithConfidenceAdaptorOutput,
    UniCeptionAdaptorBase,
)

__all__ = [
    "FlowAdaptor",
    "PointMapAdaptor",
    "ConfidenceAdaptor",
    "ValueWithConfidenceAdaptor",
    "FlowWithConfidenceAdaptor",
    "PointMapWithConfidenceAdaptor",
]

_INF = float("inf")


class FlowAdaptor(UniCeptionAdaptorBase):
    """Optical-flow unnormalization (adaptors.py:25-167).

    Default mode: ``x * std * s + mean * s``, the per-axis scale s from
    ``scale_strategy`` ("none", "scale_width", "scale_height", "scale_both")
    and the output shape against ``base_shape``. ``output_normalized_coordinate``:
    the network predicts target-pixel positions in [-1, 1]; they become pixels,
    ``0.5 * (x + 1) * (W, H) + 0.5``, and the source pixel centres (0.5, 0.5
    at the top-left) are subtracted.
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


class PointMapAdaptor(UniCeptionAdaptorBase):
    """Pointmap activation (adaptors.py:299-355), "exp" mode: the distance to
    the origin d = |x| becomes expm1(d), x / max(d, 1e-8) * expm1(d)."""

    def __init__(self, name: str, mode: str, vmin: float = -_INF, vmax: float = _INF):
        super().__init__(name, required_channels=3)
        if mode != "exp":
            raise NotImplementedError(f"PointMapAdaptor mode {mode!r} is not ported (only 'exp')")
        self.mode, self.vmin, self.vmax = mode, vmin, vmax

    def forward(self, adaptor_input: AdaptorInput) -> RegressionAdaptorOutput:
        xyz = adaptor_input.adaptor_feature
        d = torch.linalg.vector_norm(xyz, dim=1, keepdim=True)
        out = xyz / d.clamp(min=1e-8) * torch.expm1(d)
        if self.vmin != -_INF or self.vmax != _INF:
            out = out.clamp(self.vmin, self.vmax)
        return RegressionAdaptorOutput(value=out)


class ConfidenceAdaptor(UniCeptionAdaptorBase):
    "Confidence activation (adaptors.py:1035-1096), \"exp\" type: vmin + min(exp(x), vmax - vmin)."

    def __init__(self, name: str, confidence_type: str, vmin: float, vmax: float):
        super().__init__(name, required_channels=1)
        if confidence_type != "exp":
            raise NotImplementedError(f"confidence type {confidence_type!r} is not ported (only 'exp')")
        if not vmin < vmax:
            raise ValueError("vmin must be less than vmax")
        self.confidence_type = confidence_type
        self.vmin, self.vmax = vmin, vmax

    def forward(self, adaptor_input: AdaptorInput) -> RegressionAdaptorOutput:
        x = adaptor_input.adaptor_feature
        return RegressionAdaptorOutput(value=self.vmin + torch.exp(x).clamp(max=self.vmax - self.vmin))


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


class FlowWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, flow_mean, flow_std, base_shape, scale_strategy, output_normalized_coordinate,
                 confidence_type, vmin, vmax):
        value = FlowAdaptor(name, flow_mean, flow_std, base_shape, scale_strategy, output_normalized_coordinate)
        conf = ConfidenceAdaptor(f"{name}_confidence", confidence_type, vmin, vmax)
        super().__init__(name, value_adaptor=value, confidence_adaptor=conf)


class PointMapWithConfidenceAdaptor(ValueWithConfidenceAdaptor):
    def __init__(self, name: str, pointmap_mode, pointmap_vmin, pointmap_vmax,
                 confidence_type, confidence_vmin, confidence_vmax):
        value = PointMapAdaptor(name, pointmap_mode, pointmap_vmin, pointmap_vmax)
        conf = ConfidenceAdaptor(f"{name}_confidence", confidence_type, confidence_vmin, confidence_vmax)
        super().__init__(name, value_adaptor=value, confidence_adaptor=conf)
