"""
Heterogeneous-stage chain pipelining (counterpart of uniception_tpu/parallel/chain.py):
encoder -> info-sharing -> heads on different devices of one process, with
microbatches streaming through.

``parallel/pipeline.py`` pipelines a homogeneous stack of blocks over ranks.
The model chain itself has stages with different programs, parameters and
activation shapes (the reference's uniception/models/factory/dust3r.py:250-332:
encoder, multi-view cross-attention, heads). Each stage's module lives on its
own device and runs on its own CUDA stream; the boundary tensors move with
non-blocking copies, and CUDA events order each copy after the stage that made
it. The host only enqueues, so microbatch m runs on stage s while microbatch
m + 1 runs on stage s - 1: the counterpart of JAX's asynchronous dispatch.
With fewer devices than stages the stages wrap round-robin (still correct; on
one card the stages' streams overlap on it).

Usage (DUSt3R):

    pipe = ChainPipeline(dust3r_chain_stages(model), devices=["cuda:0", "cuda:1", "cuda:2"])
    res1, res2 = dust3r_chain_results(pipe((img1, img2)))   # == model.forward_pair(img1, img2)
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["ChainPipeline", "dust3r_chain_stages", "dust3r_chain_results"]


class ChainPipeline:
    """Run ``stages`` as a device-per-stage pipeline.

    stages: list of ``(fn, module)``: ``fn(module, *tensors) -> tensor | tuple`` is the stage's program and
        ``module`` its parameters, moved to the stage's device. Stage i's output tuple feeds stage i+1.
    devices: one device per stage (default: every visible card, wrapping round-robin; the CPU only when asked for).
    """

    def __init__(self, stages: Sequence[Tuple[Callable, nn.Module]], devices: Optional[Sequence] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ChainPipeline: no CUDA device (pass devices=['cpu'] to run on the CPU)")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(devices[i % len(devices)]) for i in range(len(stages))]
        self._fns, self._modules, self._streams = [], [], []
        for (fn, module), dev in zip(stages, self.devices):
            self._fns.append(fn)
            self._modules.append(module.to(dev))
            self._streams.append(torch.cuda.Stream(dev) if dev.type == "cuda" else None)

    def __call__(self, xs):
        "One microbatch through all stages. xs: tensor or tuple of tensors. Returns the last stage's outputs."
        if not isinstance(xs, tuple):
            xs = (xs,)
        ready = None  # the event after which xs may be read: the caller's stream's work so far, then each stage's
        if any(x.is_cuda for x in xs):
            ready = torch.cuda.current_stream(next(x.device for x in xs if x.is_cuda)).record_event()
        for fn, module, dev, stream in zip(self._fns, self._modules, self.devices, self._streams):
            if stream is None:
                if ready is not None:
                    ready.synchronize()
                    ready = None
                xs = tuple(x.to(dev) for x in xs)
                ys = fn(module, *xs)
            else:
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    if ready is not None:
                        stream.wait_event(ready)
                    moved = tuple(x.to(dev, non_blocking=True) for x in xs)
                    for x, m in zip(xs, moved):
                        if x.is_cuda:  # the producer's memory is read on this stream
                            x.record_stream(stream)
                        if m is not x:
                            m.record_stream(stream)
                    ys = fn(module, *moved)
                    ready = torch.cuda.Event()
                    ready.record(stream)
            xs = ys if isinstance(ys, tuple) else (ys,)
        if ready is not None:  # the caller's stream reads the results after the last stage
            torch.cuda.current_stream(self.devices[-1]).wait_event(ready)
            for x in xs:
                x.record_stream(torch.cuda.current_stream(self.devices[-1]))
        return xs if len(xs) > 1 else xs[0]

    def run(self, stream) -> List:
        """Stream microbatches through the chain. Every call is enqueued without waiting for the card, so stage s
        works on microbatch m while stage s-1 works on m+1; the returned list is in input order (synchronize before
        reading the results on the host)."""
        return [self(xs) for xs in stream]


class _Heads(nn.Module):
    "View of a DUSt3R's head and adaptor submodules (shared references)."

    def __init__(self, m):
        super().__init__()
        if m.pred_head_type == "linear":
            self.head1, self.head2 = m.head1, m.head2
        else:
            self.dpt_feature_head1 = m.dpt_feature_head1
            self.dpt_regressor_head1 = m.dpt_regressor_head1
            self.dpt_feature_head2 = m.dpt_feature_head2
            self.dpt_regressor_head2 = m.dpt_regressor_head2
        self.adaptor = m.adaptor


def dust3r_chain_stages(model) -> List[Tuple[Callable, nn.Module]]:
    """Split a ``DUSt3R`` into three chain stages: encoder -> info-sharing -> heads+adaptor (the reference's forward
    chain, factory/dust3r.py:250-332). The math is ``model.forward_pair``'s on two views of one (static) size; only
    the placement differs. Pipeline input ``(img1, img2)``, output (pts3d, conf, pts3d_in_other_view, conf2) BHWC
    (:func:`dust3r_chain_results` makes the usual dicts)."""
    from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
    from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
    from uniception_tpu_torch.models.prediction_heads.base import (
        AdaptorInput,
        PredictionHeadInput,
        PredictionHeadLayeredInput,
    )

    if getattr(model, "landscape_only", False):
        raise NotImplementedError(
            "dust3r_chain_stages does not implement the landscape_only "
            "dual-pass head path; portrait rows of a mixed ManyAR batch "
            "would come out canvas-scrambled. Use model.forward_pair, or "
            "construct with landscape_only=False for homogeneous batches."
        )
    data_norm_type = model.data_norm_type
    pred_head_type = model.pred_head_type
    hd = model.head_dtype or torch.float32
    shape = (int(model.img_size[0]), int(model.img_size[1]))

    @torch.inference_mode()
    def encode(enc, img1, img2):
        out = enc(ViTEncoderInput(image=torch.cat([img1, img2], dim=0), data_norm_type=data_norm_type))
        feat1, feat2 = out.features.chunk(2, dim=0)
        return feat1, feat2

    @torch.inference_mode()
    def share(info, feat1, feat2):
        info_in = MultiViewTransformerInput(features=[feat1, feat2])
        if pred_head_type == "linear":
            final = info(info_in)
            return final.features[0].to(hd), final.features[1].to(hd)
        final, intermediate = info(info_in)
        return (
            feat1.to(hd), feat2.to(hd),
            intermediate[0].features[0].to(hd), intermediate[0].features[1].to(hd),
            intermediate[1].features[0].to(hd), intermediate[1].features[1].to(hd),
            final.features[0].to(hd), final.features[1].to(hd),
        )

    @torch.inference_mode()
    def predict(h, *feats):
        if pred_head_type == "linear":
            f1, f2 = feats
            out1 = h.head1(PredictionHeadInput(last_feature=f1))
            out2 = h.head2(PredictionHeadInput(last_feature=f2))
        else:
            feat1, feat2, i0f1, i0f2, i1f1, i1f2, fin1, fin2 = feats
            d1, d2 = [feat1, i0f1, i1f1, fin1], [feat2, i0f2, i1f2, fin2]
            out1 = h.dpt_regressor_head1(h.dpt_feature_head1(
                PredictionHeadLayeredInput(list_features=d1, target_output_shape=shape)))
            out2 = h.dpt_regressor_head2(h.dpt_feature_head2(
                PredictionHeadLayeredInput(list_features=d2, target_output_shape=shape)))
        a1 = h.adaptor(AdaptorInput(adaptor_feature=out1.decoded_channels.float(), output_shape_hw=shape))
        a2 = h.adaptor(AdaptorInput(adaptor_feature=out2.decoded_channels.float(), output_shape_hw=shape))
        return (a1.value.permute(0, 2, 3, 1), a1.confidence.permute(0, 2, 3, 1),
                a2.value.permute(0, 2, 3, 1), a2.confidence.permute(0, 2, 3, 1))

    return [(encode, model.encoder), (share, model.info_sharing), (predict, _Heads(model))]


def dust3r_chain_results(outs):
    "Convert a DUSt3R chain output tuple into the (res1, res2) dicts."
    pts1, conf1, pts2, conf2 = outs
    return (
        {"pts3d": pts1, "conf": conf1},
        {"pts3d_in_other_view": pts2, "conf": conf2},
    )
