"""
DUSt3R: two-view pointmap model (counterpart of uniception_tpu/models/factory/dust3r.py;
reference factory/dust3r.py:40-332).

Shared CroCo ViT-L encoder -> two-view cross-attention transformer (+2D RoPE)
-> per-view linear or DPT heads -> PointMapWithConfidence adaptor. The trunk
(encoder + info sharing) keeps its parameters in ``param_dtype`` and computes
in ``dtype`` (None: in ``param_dtype``): fp32 parameters with a bf16 trunk for
training, bf16 parameters for serving. The heads keep fp32 parameters and
compute in ``head_dtype``: None is fp32, the reference's autocast-off region
(dust3r.py:309); bfloat16 is the serving option of the JAX package. The
adaptor always runs in fp32.

The DPT heads take the encoder's output and the decoder's features after
depths 5 and 8 and after its last depth (for a decoder shallower than 9:
depths 0 and depth // 2), without the final norm on the intermediates.

``landscape_only`` makes ManyAR mixed-orientation batches correct end to end
(the JAX package's static form of CroCo's transpose_to_landscape): with
``true_shape`` given, each row's true token positions ride into the
info-sharing RoPE, and the heads run a second pass on the transposed token
grid whose result is selected for the portrait rows. Outputs stay in canvas
layout (portrait rows hold the transposed native prediction;
``data.bucketing.extract_view`` unpacks them). The second pass is skipped when
no row is portrait (its result would be discarded); pass ``true_shape`` on
the CPU so that test needs no device sync (its masks then cross to the card
with non-blocking copies, which wait for no queued work).
"""

from typing import Optional, Tuple

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
from uniception_tpu_torch.models.encoders.croco import CroCoEncoder
from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
from uniception_tpu_torch.models.info_sharing.cross_attention_transformer import (
    MultiViewCrossAttentionTransformer,
    MultiViewCrossAttentionTransformerIFR,
)
from uniception_tpu_torch.models.prediction_heads.adaptors import PointMapWithConfidenceAdaptor
from uniception_tpu_torch.models.prediction_heads.base import (
    AdaptorInput,
    PredictionHeadInput,
    PredictionHeadLayeredInput,
)
from uniception_tpu_torch.models.prediction_heads.dpt import (
    DPT_CHECKPOINT_ALIASES,
    DPTFeature,
    DPTRegressionProcessor,
)
from uniception_tpu_torch.models.prediction_heads.linear import LinearFeature
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.ops.rope import Rope2D
from uniception_tpu_torch.ops.serving_operands import exporting
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

__all__ = ["DUSt3R", "is_symmetrized", "interleave"]


def is_symmetrized(gt1, gt2) -> bool:
    "True when the pairs are symmetrized: (a, b) and (b, a) both present, adjacent (dust3r.py:21-30)."
    x, y = gt1["instance"], gt2["instance"]
    if len(x) == len(y) and len(x) == 1:
        return False
    ok = True
    for i in range(0, len(x), 2):
        ok = ok and (x[i] == y[i + 1]) and (x[i + 1] == y[i])
    return ok


def interleave(tensor1, tensor2):
    "Re-expand deduped symmetric features: rows (a, b) -> (a, b), (b, a) (dust3r.py:33-37)."
    res1 = torch.stack([tensor1, tensor2], dim=1).reshape((-1,) + tuple(tensor1.shape[1:]))
    res2 = torch.stack([tensor2, tensor1], dim=1).reshape((-1,) + tuple(tensor2.shape[1:]))
    return res1, res2


class DUSt3R(nn.Module):
    "DUSt3R defined with UniCeption modules."

    def __init__(
        self,
        name: str,
        data_norm_type: str = "dust3r",
        img_size: tuple = (224, 224),
        patch_embed_cls: str = "PatchEmbedDust3R",
        pred_head_type: str = "linear",
        pred_head_output_dim: int = 4,
        pred_head_feature_dim: int = 256,
        depth_mode: Tuple[str, float, float] = ("exp", -float("inf"), float("inf")),
        conf_mode: Tuple[str, float, float] = ("exp", 1, float("inf")),
        pos_embed: str = "RoPE100",
        pretrained_checkpoint_path: Optional[str] = None,
        enc_embed_dim: int = 1024,
        enc_depth: int = 24,
        enc_num_heads: int = 16,
        info_sharing_dim: int = 768,
        info_sharing_depth: int = 12,
        info_sharing_num_heads: int = 12,
        scan_blocks: bool = False,
        landscape_only: bool = False,
        gradient_checkpointing: bool = False,
        head_gradient_checkpointing: Optional[bool] = None,
        head_dtype: Optional[torch.dtype] = None,
        *,
        dtype: Optional[torch.dtype] = None,
        param_dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if pred_head_type not in ("linear", "dpt"):
            raise ValueError(f"Invalid prediction head type: {pred_head_type}. Must be 'linear' or 'dpt'.")
        if pred_head_type == "dpt" and info_sharing_depth < 2:
            raise ValueError("dpt heads need info_sharing_depth >= 2 for distinct hook indices")

        self.name = name
        self.data_norm_type = data_norm_type
        self.img_size = img_size
        self.patch_embed_cls = patch_embed_cls
        self.pred_head_type = pred_head_type
        self.pred_head_output_dim = pred_head_output_dim
        self.head_dtype = head_dtype
        self.landscape_only = landscape_only
        self.depth_mode = depth_mode
        self.conf_mode = conf_mode
        self.pos_embed = pos_embed
        # head remat follows the trunk's unless set on its own (the DPT heads' fp32
        # full-resolution activations, not the trunk, bound its training memory)
        head_remat = gradient_checkpointing if head_gradient_checkpointing is None else head_gradient_checkpointing

        # one RoPE shared by encoder and info sharing (dust3r.py:110-112)
        self.rope = Rope2D(freq=float(pos_embed[len("RoPE"):]))
        self.encoder = CroCoEncoder(
            name=name,
            data_norm_type=data_norm_type,
            patch_embed_cls=patch_embed_cls,
            img_size=img_size,
            enc_embed_dim=enc_embed_dim,
            enc_depth=enc_depth,
            enc_num_heads=enc_num_heads,
            pos_embed=pos_embed,
            scan_blocks=scan_blocks,
            gradient_checkpointing=gradient_checkpointing,
            device=device,
            dtype=dtype,
            generator=generator,
        ).to(param_dtype)
        info_kwargs = dict(
            name="base_info_sharing",
            input_embed_dim=enc_embed_dim,
            num_views=2,
            dim=info_sharing_dim,
            depth=info_sharing_depth,
            num_heads=info_sharing_num_heads,
            custom_positional_encoding=self.rope,
            scan_blocks=scan_blocks,
            gradient_checkpointing=gradient_checkpointing,
            device=device,
            dtype=dtype,
            generator=generator,
        )
        if pred_head_type == "linear":
            self.info_sharing = MultiViewCrossAttentionTransformer(**info_kwargs).to(param_dtype)
            head_kwargs = dict(
                input_feature_dim=info_sharing_dim,
                output_dim=pred_head_output_dim,
                patch_size=self.encoder.patch_size,
                dtype=head_dtype,
                device=device,
                generator=generator,
            )
            self.head1 = LinearFeature(**head_kwargs)
            self.head2 = LinearFeature(**head_kwargs)
        else:
            # the reference's hooks [5, 8] of its 12-deep decoder; shallower decoders keep two distinct depths
            indices = [5, 8] if info_sharing_depth >= 9 else [0, info_sharing_depth // 2]
            self.info_sharing = MultiViewCrossAttentionTransformerIFR(
                indices=indices, norm_intermediate=False, **info_kwargs
            ).to(param_dtype)
            kw = dict(checkpoint_gradient=head_remat, dtype=head_dtype, device=device, generator=generator)
            feature_kwargs = dict(
                patch_size=self.encoder.patch_size,
                hooks=[0, 1, 2, 3],
                input_feature_dims=[enc_embed_dim] + [info_sharing_dim] * 3,
                feature_dim=pred_head_feature_dim,
                **kw,
            )
            regressor_kwargs = dict(input_feature_dim=pred_head_feature_dim, output_dim=pred_head_output_dim, **kw)
            self.dpt_feature_head1 = DPTFeature(**feature_kwargs)
            self.dpt_regressor_head1 = DPTRegressionProcessor(**regressor_kwargs)
            self.dpt_feature_head2 = DPTFeature(**feature_kwargs)
            self.dpt_regressor_head2 = DPTRegressionProcessor(**regressor_kwargs)
        self.adaptor = PointMapWithConfidenceAdaptor(
            name="pointmap",
            pointmap_mode=depth_mode[0],
            pointmap_vmin=depth_mode[1],
            pointmap_vmax=depth_mode[2],
            confidence_type=conf_mode[0],
            confidence_vmin=conf_mode[1],
            confidence_vmax=conf_mode[2],
        )
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained DUSt3R weights from {pretrained_checkpoint_path} ...")
            ckpt = load_checkpoint(pretrained_checkpoint_path)
            load_state_dict_numpy(self, ckpt["model"], ignore=self.checkpoint_alias_patterns())

    def heads(self):
        "The prediction-head modules (the head_dtype region)."
        if self.pred_head_type == "linear":
            return [self.head1, self.head2]
        return [self.dpt_feature_head1, self.dpt_regressor_head1, self.dpt_feature_head2, self.dpt_regressor_head2]

    def checkpoint_alias_patterns(self) -> tuple:
        """Regex patterns of duplicate keys in the reference's full-model state
        dicts: its dpt variant also registers the heads as head{1,2} =
        nn.Sequential(dpt_feature_head, dpt_regressor_head) (reference
        factory/dust3r.py:178,192), plus the scratch.layer*_rn spellings. For
        the linear variant head{1,2}.* is canonical, so nothing is ignored."""
        if self.pred_head_type == "dpt":
            return DPT_CHECKPOINT_ALIASES + (r"^head[12]\.",)
        return ()

    def _encode_image_pairs(self, img1, img2, data_norm_type, true_shape1=None, true_shape2=None):
        "Encode both views; same-shape pairs go through the encoder as one batch (dust3r.py:211-225)."
        if img1.shape[-2:] == img2.shape[-2:]:
            true_shape = None
            if true_shape1 is not None and true_shape2 is not None:
                true_shape = torch.cat([true_shape1, true_shape2], dim=0)
            out = self.encoder(
                ViTEncoderInput(image=torch.cat([img1, img2], dim=0), data_norm_type=data_norm_type, true_shape=true_shape)
            )
            feat1, feat2 = out.features.chunk(2, dim=0)
        else:
            feat1 = self.encoder(ViTEncoderInput(image=img1, data_norm_type=data_norm_type, true_shape=true_shape1)).features
            feat2 = self.encoder(ViTEncoderInput(image=img2, data_norm_type=data_norm_type, true_shape=true_shape2)).features
        return feat1, feat2

    def _encode_symmetrized(self, view1, view2):
        "Encode half of a symmetrized batch and re-interleave (dust3r.py:227-238)."
        img1, img2 = view1["img"], view2["img"]
        ts1, ts2 = view1.get("true_shape"), view2.get("true_shape")
        if is_symmetrized(view1, view2):
            feat1, feat2 = self._encode_image_pairs(
                img1[::2], img2[::2], view1["data_norm_type"],
                None if ts1 is None else ts1[::2], None if ts2 is None else ts2[::2],
            )
            return interleave(feat1, feat2)
        return self._encode_image_pairs(img1, img2, view1["data_norm_type"], ts1, ts2)

    def forward_pair(self, img1, img2, true_shape1=None, true_shape2=None):
        """Two-view forward.

        Args:
            img1/img2: (B, 3, H, W) normalized images.
            true_shape1/2: optional (B, 2) actual (h, w) for ManyAR batches.

        Returns:
            (res1, res2) dicts with pts3d / pts3d_in_other_view and conf, BHWC fp32.
        """
        shape1 = (int(img1.shape[-2]), int(img1.shape[-1]))
        shape2 = (int(img2.shape[-2]), int(img2.shape[-1]))
        feat1, feat2 = self._encode_image_pairs(img1, img2, self.data_norm_type, true_shape1, true_shape2)
        return self._decode_and_predict(feat1, feat2, shape1, shape2, true_shape1, true_shape2)

    def forward(self, view1: dict, view2: dict):
        """Reference-compatible forward over view dicts (dust3r.py:250-332): "img"
        (B, 3, H, W), optional "instance" ids (symmetrized pairs are encoded
        once), "data_norm_type" and "true_shape"."""
        shape1 = (int(view1["img"].shape[-2]), int(view1["img"].shape[-1]))
        shape2 = (int(view2["img"].shape[-2]), int(view2["img"].shape[-1]))
        view1, view2 = dict(view1), dict(view2)
        view1.setdefault("data_norm_type", self.data_norm_type)
        view1.setdefault("instance", [str(i) for i in range(view1["img"].shape[0])])
        view2.setdefault("instance", [str(i) for i in range(view2["img"].shape[0])])
        feat1, feat2 = self._encode_symmetrized(view1, view2)
        return self._decode_and_predict(
            feat1, feat2, shape1, shape2, view1.get("true_shape"), view2.get("true_shape")
        )

    def _head(self, head_num: int, decout, img_shape):
        if self.pred_head_type == "linear":
            head = self.head1 if head_num == 1 else self.head2
            return head(PredictionHeadInput(last_feature=decout[head_num]))
        feature_head = self.dpt_feature_head1 if head_num == 1 else self.dpt_feature_head2
        regressor = self.dpt_regressor_head1 if head_num == 1 else self.dpt_regressor_head2
        return regressor(feature_head(PredictionHeadLayeredInput(list_features=decout[head_num],
                                                                 target_output_shape=img_shape)))

    def _head_and_adapt(self, head_num, decout, shape):
        head_out = self._head(head_num, decout, shape)
        # the adaptor's exp/clip always in fp32 (dust3r.py:378-383)
        return self.adaptor(AdaptorInput(adaptor_feature=head_out.decoded_channels.float(), output_shape_hw=shape))

    @staticmethod
    def _true_positions(feat, true_shape):
        """Per-row token positions of a ManyAR batch: landscape rows on the (hp, wp)
        grid, portrait rows on the (wp, hp) grid, as the patch embed made them."""
        B, _, hp, wp = feat.shape
        is_land = (true_shape[:, 1] >= true_shape[:, 0]).to(feat.device, non_blocking=True)[:, None, None]
        pos_land = make_patch_positions(B, hp, wp, device=feat.device)
        pos_port = make_patch_positions(B, wp, hp, device=feat.device)
        return torch.where(is_land, pos_land, pos_port)

    def _predict_view(self, head_num, decout, shape, true_shape):
        """Head + adaptor; with ``true_shape`` (landscape_only) also the pass on the
        transposed token grid, selected for the portrait rows (JAX :385-406)."""
        out = self._head_and_adapt(head_num, decout, shape)
        if true_shape is None:
            return out
        is_port = true_shape[:, 0] > true_shape[:, 1]
        # every row landscape: the second pass would be discarded. An exported program has no host branch on the
        # data: it runs both passes and selects, as the JAX package does
        if not exporting() and not bool(is_port.any()):
            return out

        def regrid(f):
            # canvas grid -> token order -> transposed grid (a reshape, not a transpose): a portrait
            # row's tokens were made in (wp, hp) row-major order
            B, C, hp, wp = f.shape
            return f.reshape(B, C, hp * wp).reshape(B, C, wp, hp)

        feats = decout[head_num]
        regridded = {head_num: [regrid(f) for f in feats] if isinstance(feats, list) else regrid(feats)}
        out_p = self._head_and_adapt(head_num, regridded, shape[::-1])
        sel = is_port.to(out.value.device, non_blocking=True).reshape(-1, 1, 1, 1)
        return type(out)(
            value=torch.where(sel, out_p.value.transpose(-1, -2), out.value),
            confidence=torch.where(sel, out_p.confidence.transpose(-1, -2), out.confidence),
        )

    def _decode_and_predict(self, feat1, feat2, shape1, shape2, true_shape1=None, true_shape2=None):
        mixed_ar = (
            self.landscape_only
            and self.patch_embed_cls == "ManyAR_PatchEmbed"
            and true_shape1 is not None
            and true_shape2 is not None
        )
        positions = None
        if mixed_ar:
            positions = [self._true_positions(feat1, true_shape1), self._true_positions(feat2, true_shape2)]
        info_in = MultiViewTransformerInput(features=[feat1, feat2], positions=positions)
        hd = self.head_dtype or torch.float32
        if self.pred_head_type == "linear":
            final = self.info_sharing(info_in)
            decout = {1: final.features[0].to(hd), 2: final.features[1].to(hd)}
        else:
            final, inter = self.info_sharing(info_in)
            decout = {
                v + 1: [f.to(hd) for f in (feat, inter[0].features[v], inter[1].features[v], final.features[v])]
                for v, feat in enumerate((feat1, feat2))
            }
        out1 = self._predict_view(1, decout, shape1, true_shape1 if mixed_ar else None)
        out2 = self._predict_view(2, decout, shape2, true_shape2 if mixed_ar else None)
        res1 = {"pts3d": out1.value.permute(0, 2, 3, 1), "conf": out1.confidence.permute(0, 2, 3, 1)}
        res2 = {"pts3d_in_other_view": out2.value.permute(0, 2, 3, 1), "conf": out2.confidence.permute(0, 2, 3, 1)}
        return res1, res2
