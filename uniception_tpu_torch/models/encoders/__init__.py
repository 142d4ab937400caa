"""
Encoder registry and factories (counterpart of uniception_tpu/models/encoders/__init__.py; reference
uniception/models/encoders/__init__.py:37-140).

``ENCODER_CONFIGS`` lists every key of the JAX package's registry, and the port builds each (:func:`is_ported`: a
stand-in class would carry a ``roadmap_item``; none is left); an unknown key raises ValueError. ``python -m
uniception_tpu_torch.models.encoders.list`` prints the table.

The factories are entry points: they build on the card unless the caller passes ``device="cpu"`` (or another
device), and draw the weights from ``seed`` unless a ``generator`` is given.
"""

import os

import torch

from uniception_tpu_torch.models.encoders.base import (
    EncoderGlobalRepInput,
    EncoderGlobalRepOutput,
    EncoderInput,
    EncoderOutput,
    UniCeptionEncoderBase,
    UniCeptionViTEncoderBase,
    ViTEncoderInput,
    ViTEncoderNonImageInput,
    ViTEncoderOutput,
)
from uniception_tpu_torch.models.encoders.cosmos import CosmosEncoder
from uniception_tpu_torch.models.encoders.croco import CroCoEncoder, CroCoIntermediateFeatureReturner
from uniception_tpu_torch.models.encoders.dense_rep_encoder import DenseRepresentationEncoder
from uniception_tpu_torch.models.encoders.dinov2 import DINOv2Encoder, DINOv2IntermediateFeatureReturner
from uniception_tpu_torch.models.encoders.dinov3 import (
    DINOv3ConvNextEncoder,
    DINOv3ConvNextIntermediateFeatureReturner,
    DINOv3Encoder,
    DINOv3IntermediateFeatureReturner,
)
from uniception_tpu_torch.models.encoders.dune import DUNEEncoder, DUNEIntermediateFeatureReturner
from uniception_tpu_torch.models.encoders.global_rep_encoder import GlobalRepresentationEncoder
from uniception_tpu_torch.models.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT, ImageNormalization
from uniception_tpu_torch.models.encoders.patch_embedder import PatchEmbedder
from uniception_tpu_torch.models.encoders.perception_encoder import (
    PerceptionEncoder,
    PerceptionEncoderIntermediateFeatureReturner,
)
from uniception_tpu_torch.models.encoders.pixio import PixioEncoder
from uniception_tpu_torch.models.encoders.radio import RADIOEncoder, RADIOIntermediateFeatureReturner

__all__ = [
    "ENCODER_CONFIGS",
    "encoder_factory",
    "feature_returner_encoder_factory",
    "get_available_encoders",
    "print_available_encoder_models",
    "is_ported",
    "EncoderGlobalRepInput",
    "EncoderGlobalRepOutput",
    "EncoderInput",
    "EncoderOutput",
    "UniCeptionEncoderBase",
    "UniCeptionViTEncoderBase",
    "ViTEncoderInput",
    "ViTEncoderNonImageInput",
    "ViTEncoderOutput",
    "CosmosEncoder",
    "CroCoEncoder",
    "CroCoIntermediateFeatureReturner",
    "DINOv2Encoder",
    "DINOv2IntermediateFeatureReturner",
    "DUNEEncoder",
    "DUNEIntermediateFeatureReturner",
    "DINOv3Encoder",
    "DINOv3IntermediateFeatureReturner",
    "DINOv3ConvNextEncoder",
    "DINOv3ConvNextIntermediateFeatureReturner",
    "RADIOEncoder",
    "RADIOIntermediateFeatureReturner",
    "PerceptionEncoder",
    "PerceptionEncoderIntermediateFeatureReturner",
    "PixioEncoder",
    "DenseRepresentationEncoder",
    "GlobalRepresentationEncoder",
    "PatchEmbedder",
    "IMAGE_NORMALIZATION_DICT",
    "ImageNormalization",
]

ENCODER_CONFIGS = {
    "croco": {
        "class": CroCoEncoder,
        "intermediate_feature_returner_class": CroCoIntermediateFeatureReturner,
        "supported_models": ["CroCov2", "DUSt3R", "MASt3R"],
    },
    "dense_rep_encoder": {
        "class": DenseRepresentationEncoder,
        "supported_models": ["Dense-Representation-Encoder"],
    },
    "dinov2": {
        "class": DINOv2Encoder,
        "intermediate_feature_returner_class": DINOv2IntermediateFeatureReturner,
        "supported_models": ["DINOv2", "DINOv2-Registers", "DINOv2-Depth-Anythingv2"],
    },
    "dinov3": {
        "class": DINOv3Encoder,
        "intermediate_feature_returner_class": DINOv3IntermediateFeatureReturner,
        "supported_models": ["DINOv3-ViT"],
    },
    "dinov3_convnext": {
        "class": DINOv3ConvNextEncoder,
        "intermediate_feature_returner_class": DINOv3ConvNextIntermediateFeatureReturner,
        "supported_models": ["DINOv3-ConvNext"],
    },
    "cosmos": {
        "class": CosmosEncoder,
        "supported_models": ["Cosmos-Tokenizer CI8x8", "Cosmos-Tokenizer CI16x16"],
    },
    "dune": {
        "class": DUNEEncoder,
        "intermediate_feature_returner_class": DUNEIntermediateFeatureReturner,
        "supported_models": ["DUNE"],
    },
    "global_rep_encoder": {
        "class": GlobalRepresentationEncoder,
        "supported_models": ["Global-Representation-Encoder"],
    },
    "perception_encoder": {
        "class": PerceptionEncoder,
        "intermediate_feature_returner_class": PerceptionEncoderIntermediateFeatureReturner,
        "supported_models": ["Perception Encoder Core", "Perception Encoder Spatial"],
    },
    "pixio": {
        "class": PixioEncoder,
        "supported_models": ["Pixio-Encoder"],
    },
    "radio": {
        "class": RADIOEncoder,
        "intermediate_feature_returner_class": RADIOIntermediateFeatureReturner,
        "supported_models": ["RADIO", "E-RADIO (capability-equivalent hybrid trunk; hub checkpoints not loadable offline)"],
    },
    "patch_embedder": {
        "class": PatchEmbedder,
        "supported_models": ["Patch-Embedder"],
    },
}


def is_ported(encoder_str: str) -> bool:
    "Whether the port builds the registry entry ``encoder_str``."
    return not hasattr(ENCODER_CONFIGS[encoder_str]["class"], "roadmap_item")


def _entry(encoder_str: str) -> dict:
    if encoder_str not in ENCODER_CONFIGS:
        raise ValueError(
            f"Unknown encoder: {encoder_str}. For valid encoder_str options, "
            "please use python -m uniception_tpu_torch.models.encoders.list"
        )
    return ENCODER_CONFIGS[encoder_str]


def _placed(kwargs: dict, seed: int) -> dict:
    """``kwargs`` with ``device`` (default: the card; raises without one) and a ``generator`` on it seeded with
    ``seed`` unless the caller gave one (none on the meta device, where nothing is drawn)."""
    device = torch.device(kwargs.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the encoders build on the card unless the caller passes device='cpu'")
    generator = kwargs.get("generator")
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(seed)
    return {**kwargs, "device": device, "generator": generator}


def encoder_factory(encoder_str: str, seed: int = 0, **kwargs) -> UniCeptionEncoderBase:
    """Build an encoder by registry name (``python -m uniception_tpu_torch.models.encoders.list`` lists them);
    ``kwargs`` go to its class."""
    return _entry(encoder_str)["class"](**_placed(kwargs, seed))


def feature_returner_encoder_factory(encoder_str: str, seed: int = 0, **kwargs) -> UniCeptionEncoderBase:
    "Build an intermediate-feature-returner encoder by registry name; ``kwargs`` go to its class."
    cfg = _entry(encoder_str)
    if "intermediate_feature_returner_class" not in cfg:
        raise ValueError(f"Encoder {encoder_str} has no intermediate-feature-returner variant")
    return cfg["intermediate_feature_returner_class"](**_placed(kwargs, seed))


def get_available_encoders():
    "Registry keys, ported or not (reference encoders/__init__.py get_available_encoders)."
    return sorted(ENCODER_CONFIGS)


def print_available_encoder_models():
    "Print every registry key, one per line (JAX ``print_available_encoder_models``)."
    for name in get_available_encoders():
        print(name)


def _make_encoder_test(encoder_str: str, seed: int = 0, **kwargs) -> UniCeptionEncoderBase:
    """Build the canonical test configuration of an encoder string (JAX encoders/__init__.py:162-210), with the
    canonical checkpoint under ``checkpoints/encoders`` of the repository passed only when that file exists:
    nothing is downloaded, and without the file the weights are drawn from ``seed``."""
    here = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = os.path.normpath(os.path.join(here, "../../../checkpoints/encoders"))

    def ckpt(rel):
        path = os.path.join(ckpt_dir, rel)
        return path if os.path.exists(path) else None

    if encoder_str == "dummy":
        return UniCeptionEncoderBase(name="dummy", data_norm_type="dummy")
    kwargs = _placed(kwargs, seed)
    if encoder_str == "croco":
        return CroCoEncoder(name="croco", data_norm_type="croco", patch_embed_cls="PatchEmbedCroCo",
                            pretrained_checkpoint_path=ckpt("CroCo_Encoder_224.pth"), **kwargs)
    if encoder_str == "dust3r_224":
        return CroCoEncoder(name="dust3r_224", data_norm_type="dust3r", patch_embed_cls="PatchEmbedDust3R",
                            pretrained_checkpoint_path=ckpt("CroCo_Encoder_224_DUSt3R_linear.pth"), **kwargs)
    if encoder_str in ("dust3r_512", "dust3r_512_dpt", "mast3r_512"):
        names = {
            "dust3r_512": "CroCo_Encoder_512_DUSt3R_linear.pth",
            "dust3r_512_dpt": "CroCo_Encoder_512_DUSt3R_dpt.pth",
            "mast3r_512": "CroCo_Encoder_512_MASt3R.pth",
        }
        return CroCoEncoder(name=encoder_str, data_norm_type="dust3r", patch_embed_cls="ManyAR_PatchEmbed",
                            img_size=(512, 512), pretrained_checkpoint_path=ckpt(names[encoder_str]), **kwargs)
    if "dinov2" in encoder_str:
        size = encoder_str.split("_")[1]
        path = ckpt(f"DINOv2_ViT{size[0].upper()}_DepthAnythingV2.pth") if "dav2" in encoder_str else None
        return DINOv2Encoder(name=encoder_str.replace("_reg", ""), size=size, with_registers="reg" in encoder_str,
                             pretrained_checkpoint_path=path, **kwargs)
    if "radio" in encoder_str:
        eradio_input_shape = (224, 224) if "e-radio" in encoder_str else None
        return RADIOEncoder(name=encoder_str, model_version=encoder_str, eradio_input_shape=eradio_input_shape,
                            **kwargs)
    if "dinov3_convnext" in encoder_str:
        return DINOv3ConvNextEncoder(name=encoder_str, size=encoder_str.split("_")[-1],
                                     weights=ckpt("dinov3_convnext_base_pretrain_lvd1689m-801f2ba9.pth"), **kwargs)
    if "dinov3" in encoder_str:
        return DINOv3Encoder(name=encoder_str, size=encoder_str.split("_")[-1],
                             weights=ckpt("dinov3_vitb16_pretrain_lvd1689m-73cec8be.pth"), **kwargs)
    if "dune" in encoder_str:
        return DUNEEncoder(name="dune_base", vit_size="base", pe_image_size=448,
                           pretrained_checkpoint_path=ckpt("dune_vitbase14_448.pth"), **kwargs)
    if "cosmos" in encoder_str:
        patch_size = int(encoder_str.split("x")[-1])
        return CosmosEncoder(name=encoder_str, patch_size=patch_size,
                             pretrained_checkpoint_path=ckpt(f"Cosmos-Tokenizer-CI{patch_size}x{patch_size}/encoder.pth"),
                             **kwargs)
    if "perception_encoder" in encoder_str:
        pe_type, pe_size = encoder_str.split("_")[2], encoder_str.split("_")[3]
        return PerceptionEncoder(name=encoder_str, patch_size=16 if pe_size == "base" else 14,
                                 data_norm_type="perception_encoder", size=pe_size, checkpoint_type=pe_type, **kwargs)
    if "patch_embedder" in encoder_str:
        return PatchEmbedder(name=encoder_str, **kwargs)
    if "pixio" in encoder_str:
        return PixioEncoder(name=encoder_str, patch_size=16, data_norm_type="pixio", **kwargs)
    raise ValueError(f"Unknown encoder: {encoder_str}")
