"""DUSt3R for the benchmark: weights drawn from the seed, the program built from them as it loads a checkpoint,
the plain reference built from the same tensors, and the operation and byte counts of the configuration's shapes.

Nothing here takes a number from the program: the counts follow from the configuration (``arch``) alone.

    linear / conv       2 * M * N * K, 2 * k^2 * Cin * Cout * Hout * Wout (transposed: * Hin * Win)
    attention           4 * B * H * Nq * Nk * D (q k^T and p v)
"""

import math
import statistics
import time
from typing import Dict, List, Tuple

import torch

from portbench.core.compare import row_dev_rel, row_rel_err
from portbench.reference.dust3r import ReferenceDUSt3R, fp32_exact as reference_scope

__all__ = ["weight_specs", "draw_weights", "build_program", "make_server", "build_reference", "prepare_kernels",
           "launch_counters", "output_errors", "reference_scope", "build_trainable", "make_trainer",
           "frame_normalizer", "prefetch", "first_gradient_norms", "reference_trainer", "training_errors",
           "forward_flops_per_pair", "attention_calls", "attention_bytes", "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TRUNK = ("encoder.", "info_sharing.")  # the keys of the encoder and the two-view decoder
# The DPT regressor's last 1x1 conv, drawn at a quarter of the fan-in scale: at the published widths its raw
# channels then have an rms of about 1-2, as the linear head's draw gives and a trained head's log-distances and
# log-confidences have; at the full scale they reach 6-13, and exp(c) overflows in the confidence loss.
QUARTER_SCALE = ("dpt_regressor_head1.conv2.2.weight", "dpt_regressor_head2.conv2.2.weight")


def weight_specs(arch: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    "(key, shape) of every tensor of the checkpoint, in the reference's key layout."
    with torch.device("meta"):
        ref = ReferenceDUSt3R(arch)
    return [(k, tuple(v.shape)) for k, v in ref.state_dict().items()]


def _init_scale(key: str, shape) -> Tuple[float, float]:
    """(std, mean) of a key's draw: a weight of rank 2 or more N(0, 1 / fan_in); a norm's scale N(1, 0.1^2); a bias
    N(0, 0.02^2), so that every bias and scale takes part in the result."""
    if len(shape) >= 2:
        return (0.25 if key in QUARTER_SCALE else 1.0) / math.sqrt(math.prod(shape[1:])), 0.0
    return (0.1, 1.0) if key.endswith(".weight") else (0.02, 0.0)


def draw_weights(arch: dict, seed: int, device, trunk_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Every tensor of the checkpoint on ``device``, drawn from ``seed`` in one call of a generator on the device,
    scaled per key by two multi-tensor calls, and the trunk's (encoder and decoder, the leading keys) rounded to
    ``trunk_dtype`` in one more: the type the program holds them in. The same seed gives the same tensors."""
    specs = weight_specs(arch)
    sizes = [math.prod(s) for _, s in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    views = [v.view(s) for v, (_, s) in zip(flat.split(sizes), specs)]
    stds, means = zip(*(_init_scale(k, s) for k, s in specs))
    torch._foreach_mul_(views, list(stds))
    torch._foreach_add_(views, list(means))
    n_trunk = sum(1 for k, _ in specs if k.startswith(TRUNK))
    if not all(k.startswith(TRUNK) for k, _ in specs[:n_trunk]):
        raise ValueError("the trunk's keys must lead the checkpoint")
    trunk = flat[: sum(sizes[:n_trunk])].to(trunk_dtype)
    views = [v.view(s) for v, (_, s) in zip(trunk.split(sizes[:n_trunk]), specs)] + views[n_trunk:]
    return {k: v for (k, _), v in zip(specs, views)}


def build_program(arch: dict, precision: dict, weights: Dict[str, torch.Tensor], device, control: bool = False):
    """The program's serving model, built as it loads a torch checkpoint: constructed on the meta device, then
    filled from ``weights`` (a state dict in memory) and placed on ``device``; the trunk in
    ``precision["trunk"]``, the heads in ``precision["head"]``. ``control`` switches on the program's own
    lower-precision path, its int8 trunk (every trunk linear through the int8 GEMM)."""
    from uniception_tpu_torch import serve
    from uniception_tpu_torch.nn.quant import quantize_trunk
    from uniception_tpu_torch.utils.coldstart import abstract_construct, materialize

    dims = (arch["enc_depth"], arch["enc_embed_dim"], arch["enc_num_heads"],
            arch["dec_depth"], arch["dec_embed_dim"], arch["dec_num_heads"])
    head_dtype = DTYPES[precision["head"]]
    kw = dict(dtype=DTYPES[precision["trunk"]], head=arch["head"],
              head_dtype=None if head_dtype == torch.float32 else head_dtype, landscape_only=False)
    model = abstract_construct(lambda: serve.make_model("dust3r", tuple(arch["img_size"]), dims, **kw))
    materialize(model, state_dict=weights, ignore=model.checkpoint_alias_patterns(), device=device)
    if control:
        quantize_trunk(model, "all", asym="none", min_params=1)
    model.quant_spec = ("all", "none") if control else None
    return model.eval()


def make_server(model, device):
    "The program's serving call: ``serve(frames1_u8, frames2_u8) -> (pts3d, conf, pts3d_in_other_view, conf2)``."
    from uniception_tpu_torch import serve

    return serve.make_serving_fn(model, device)


def prepare_kernels(device) -> float:
    """Seconds to have the program's kernel library loaded on a card (its first use in a checkout builds it with
    nvcc; later runs load the built library); 0 on the CPU, where the program runs its plain versions."""
    if torch.device(device).type != "cuda":
        return 0.0
    from uniception_tpu_torch.ops import kernel_lib

    t0 = time.perf_counter()
    kernel_lib.library()
    return time.perf_counter() - t0


def launch_counters() -> Dict[str, int]:
    "The program's own launch counters of its hand-written kernels, by the kernel's number."
    from uniception_tpu_torch.ops.conv3x3 import conv3x3_nhwc
    from uniception_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from uniception_tpu_torch.ops.int8_matmul import int8_matmul_dynamic
    from uniception_tpu_torch.ops.rope import rope_2d_kernel

    return {"K1": flash_attention.launches, "K2": rope_2d_kernel.launches, "K3": flash_attention_bwd.launches,
            "K4": int8_matmul_dynamic.launches, "K7": conv3x3_nhwc.launches}


def build_reference(arch: dict, weights: Dict[str, torch.Tensor]) -> ReferenceDUSt3R:
    "The plain fp32 reference holding ``weights`` (in fp32: the trunk's widened exactly), in eval mode."
    with torch.device("meta"):
        ref = ReferenceDUSt3R(arch)
    ref.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True, assign=True)
    return ref.eval()


def build_trainable(arch: dict, precision: dict, weights: Dict[str, torch.Tensor], device):
    """The program's DUSt3R for training, as its trainer builds it (the plain patch embed, fp32 parameters, the
    trunk computing in ``precision["trunk"]``, the heads in fp32, no remat), filled from ``weights`` through the
    checkpoint path: constructed on the meta device, then materialized on ``device``."""
    from uniception_tpu_torch.models.factory.dust3r import DUSt3R
    from uniception_tpu_torch.utils.coldstart import abstract_construct, materialize

    head_dtype = DTYPES[precision["head"]]
    model = abstract_construct(lambda: DUSt3R(
        name="portbench_train", patch_embed_cls="PatchEmbedDust3R", img_size=tuple(arch["img_size"]),
        pred_head_type=arch["head"], enc_embed_dim=arch["enc_embed_dim"], enc_depth=arch["enc_depth"],
        enc_num_heads=arch["enc_num_heads"], info_sharing_dim=arch["dec_embed_dim"],
        info_sharing_depth=arch["dec_depth"], info_sharing_num_heads=arch["dec_num_heads"],
        dtype=DTYPES[precision["trunk"]], head_dtype=None if head_dtype == torch.float32 else head_dtype))
    materialize(model, state_dict=weights, ignore=model.checkpoint_alias_patterns(), device=device)
    return model.train()


def make_trainer(model, traffic: dict):
    """The program's train step (``parallel/training.make_train_step``): AdamW at the mix's learning rate and
    weight decay over every parameter, DUSt3R's confidence loss with the 'avg_dis' normalisation."""
    from uniception_tpu_torch.parallel.training import dust3r_confidence_loss, make_train_step

    alpha = traffic["alpha"]

    def loss_fn(m, img1, img2, target1, target2):
        res1, res2 = m.forward_pair(img1, img2)
        return dust3r_confidence_loss(res1, res2, target1, target2, alpha=alpha, norm_mode="avg_dis")

    return make_train_step(model, loss_fn=loss_fn, learning_rate=traffic["learning_rate"],
                           weight_decay=traffic["weight_decay"])


def frame_normalizer(model, device):
    "The program's on-device normalizer of uint8 frames, as its trainer makes it."
    from uniception_tpu_torch.data.pipeline import make_frame_normalizer

    return make_frame_normalizer(model.data_norm_type, device)


def prefetch(batches, device):
    "The program's host-to-device feed (``data/pipeline.prefetch_to_device``)."
    from uniception_tpu_torch.data.pipeline import prefetch_to_device

    return prefetch_to_device(batches, device)


def first_gradient_norms(trainer) -> Dict[str, float]:
    "After the first step: each parameter's gradient norm as the optimizer holds it, ||first moment|| / (1 - b1)."
    opt = trainer.optimizer
    return {n: float(t) / (1 - opt.b1) for n, t in zip(trainer.names, torch._foreach_norm(opt.mu))}


def reference_trainer(arch: dict, weights: Dict[str, torch.Tensor], device, traffic: dict, lowp=None):
    "The plain reference's trainer (portbench/reference/train.py) on fp32 copies of ``weights``."
    from portbench.reference.train import ReferenceTrainer

    ref = build_reference(arch, weights).set_lowp(lowp)
    return ReferenceTrainer(ref, device, traffic["learning_rate"], traffic["weight_decay"], traffic["alpha"],
                            traffic["reference_block"])


def training_errors(program, reference, floor: float = 1e-3) -> Dict[str, float]:
    """Three readings of (losses, first-gradient norms, change norms) against the reference's:
    ``loss_gap`` the worst step's |loss - reference| / |reference|; ``grad_gap`` the worst parameter's gap between
    its first-gradient norm and the reference's, over the larger of the reference's and the median parameter's;
    ``update_gap`` the same for the change over the three steps, over the parameters whose reference gradient is
    at least ``floor`` times the median parameter's (the others move by AdamW's rounding alone)."""
    (lp, gp, cp), (lr, gr, cr) = program, reference
    med_g = statistics.median(gr.values())
    moved = [n for n, g in gr.items() if g >= floor * med_g]
    med_c = statistics.median(cr[n] for n in moved)
    return {"loss_gap": _worst(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
            "grad_gap": _worst(abs(gp[n] - g) / max(g, med_g) for n, g in gr.items()),
            "update_gap": _worst(abs(cp[n] - cr[n]) / max(cr[n], med_c) for n in moved)}


def _worst(values) -> float:
    "The largest of the values; inf when any is not finite."
    values = list(values)
    return math.inf if not all(map(math.isfinite, values)) else max(values)


def head_space(pts3d: torch.Tensor, conf: torch.Tensor):
    """The adaptor undone: the head's raw pointmap channels xyz = pts3d / |pts3d| * log1p(|pts3d|) and its
    confidence channel c = log(conf - 1), in fp64. The comparison reads the head's output here, before exp
    stretches a relative error by the point's log-distance."""
    p, c = pts3d.double(), conf.double()
    n = p.norm(dim=-1, keepdim=True)
    xyz = torch.where(n > 0, p / n.clamp(min=1e-300) * torch.log1p(n), torch.zeros_like(p))
    return xyz, torch.log((c - 1).clamp(min=1e-300))


def output_errors(got, want) -> Dict[str, List[float]]:
    """Per pair and view: ||program - reference|| / ||reference|| of the pointmaps (``pts3d_rel``), of the
    confidences (``conf_rel``) and of the head's raw channels (``xyz_rel``, ``c_rel``: :func:`head_space`); the
    raw channels' error over the reference's spread about its channel means (``xyz_dev_rel``, ``c_dev_rel``, and
    all four together ``raw_dev_rel``: core/compare.py ``row_dev_rel``); and the rms of the reference's log-distances |xyz| (``xyz_rms``, the scale
    the adaptor's exp stretches errors by). Both views' outputs come as (pts3d, conf, pts3d_in_other_view, conf2)."""
    out: Dict[str, List[float]] = {}
    for a, b in ((0, 1), (2, 3)):
        (xg, cg), (xw, cw) = head_space(got[a], got[b]), head_space(want[a], want[b])
        rows = {"pts3d_rel": row_rel_err(got[a], want[a]), "conf_rel": row_rel_err(got[b], want[b]),
                "xyz_rel": row_rel_err(xg, xw), "c_rel": row_rel_err(cg, cw),
                "xyz_dev_rel": row_dev_rel(xg, xw), "c_dev_rel": row_dev_rel(cg, cw),
                "raw_dev_rel": row_dev_rel(torch.cat([xg, cg], -1), torch.cat([xw, cw], -1)),
                "xyz_rms": xw.norm(dim=-1).flatten(1).square().mean(1).sqrt().tolist()}
        for k, v in rows.items():
            out[k] = out.get(k, []) + v
    return out


def _conv(cin, cout, k, hout, wout):
    return 2 * k * k * cin * cout * hout * wout


def _dpt_flops(arch: dict, hp: int, wp: int, H: int, W: int) -> int:
    "One view's DPT head (feature pyramid, fusion and regressor) at a (hp, wp) token grid and an (H, W) output."
    C, Cd = arch["enc_embed_dim"], arch["dec_embed_dim"]
    fd, ld, out = arch["dpt_feature_dim"], arch["dpt_layer_dims"], arch["output_dim"]
    d = [C, Cd, Cd, Cd]
    f = 0
    f += _conv(d[0], ld[0], 1, hp, wp) + _conv(ld[0], ld[0], 4, hp, wp) + _conv(ld[0], fd, 3, 4 * hp, 4 * wp)
    f += _conv(d[1], ld[1], 1, hp, wp) + _conv(ld[1], ld[1], 2, hp, wp) + _conv(ld[1], fd, 3, 2 * hp, 2 * wp)
    f += _conv(d[2], ld[2], 1, hp, wp) + _conv(ld[2], fd, 3, hp, wp)
    h4, w4 = (hp + 1) // 2, (wp + 1) // 2  # the stride-2 conv's grid
    f += _conv(d[3], ld[3], 1, hp, wp) + _conv(ld[3], ld[3], 3, h4, w4) + _conv(ld[3], fd, 3, h4, w4)
    rcu = lambda h, w: 2 * _conv(fd, fd, 3, h, w)  # noqa: E731  a residual conv unit: two 3x3 convs
    f += rcu(h4, w4) + _conv(fd, fd, 1, 2 * h4, 2 * w4)  # refinenet4: one unit, 2x, out_conv
    for s in (1, 2, 4):  # refinenets 3, 2, 1 at the grid, 2x and 4x: two units each, 2x, out_conv
        f += 2 * rcu(s * hp, s * wp) + _conv(fd, fd, 1, 2 * s * hp, 2 * s * wp)
    f += _conv(fd, fd // 2, 3, 8 * hp, 8 * wp)  # regressor conv1, then the resize to (H, W)
    f += _conv(fd // 2, fd // 2, 3, H, W) + _conv(fd // 2, out, 1, H, W)
    return f


def forward_flops_per_pair(arch: dict) -> int:
    "Operations of one pair's forward (both views) at ``img_size``: every linear, conv and attention product."
    H, W = arch["img_size"]
    P, C, Cd = arch["patch_size"], arch["enc_embed_dim"], arch["dec_embed_dim"]
    hp, wp = H // P, W // P
    N = hp * wp
    enc_block = 2 * N * C * 3 * C + 2 * N * C * C + 2 * 2 * N * C * 4 * C + 4 * N * N * C
    encoder = 2 * N * 3 * P * P * C + arch["enc_depth"] * enc_block
    dec_block = (2 * N * Cd * 3 * Cd + 2 * N * Cd * Cd + 4 * N * N * Cd  # self-attention
                 + 4 * 2 * N * Cd * Cd + 4 * N * N * Cd  # cross-attention: q, k, v, proj; scores and values
                 + 2 * 2 * N * Cd * 4 * Cd)  # MLP
    decoder = 2 * N * C * Cd + arch["dec_depth"] * dec_block
    if arch["head"] == "linear":
        head = 2 * N * Cd * arch["output_dim"] * P * P
    else:
        head = _dpt_flops(arch, hp, wp, H, W)
    return 2 * (encoder + decoder + head)


def attention_calls(arch: dict, pairs: int) -> List[Tuple[int, int, int, int, int]]:
    """(B, heads, Nq, Nk, D) of every attention of one forward over ``pairs`` pairs: the encoder's over both views
    as one batch, then per decoder depth and view a self- and a cross-attention."""
    H, W = arch["img_size"]
    N = (H // arch["patch_size"]) * (W // arch["patch_size"])
    eh, dh = arch["enc_num_heads"], arch["dec_num_heads"]
    enc = [(2 * pairs, eh, N, N, arch["enc_embed_dim"] // eh)] * arch["enc_depth"]
    dec = [(pairs, dh, N, N, arch["dec_embed_dim"] // dh)] * (4 * arch["dec_depth"])
    return enc + dec


def attention_bytes(call, elem_bytes: int = 2) -> int:
    "Bytes of one attention call read and written once: q, k, v in and o out."
    B, Hh, Nq, Nk, D = call
    return elem_bytes * B * Hh * D * (2 * Nq + 2 * Nk)
