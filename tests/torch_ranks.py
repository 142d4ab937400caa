"""
Rank-side programs of the multi-process tests (tests/test_torch_parallel_serving.py and
tests/test_torch_parallel_pipeline.py): each runs inside a rank process that
``uniception_tpu_torch.parallel.comm.spawn`` starts, on the CPU under gloo.

This module imports torch and the port only: the rank processes import neither
jax nor the JAX package. The parent test process makes every input and weight
with numpy (the JAX modules' weights exported to torch layout), passes them in,
and compares what the ranks return with the JAX package's functions.
"""

import os
import signal
import sys

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_free():
    return not any(m == "jax" or m.startswith(("jax.", "uniception_tpu.")) for m in sys.modules)


def _dust3r(spec):
    "The port's DUSt3R of ``spec`` (constructor kwargs, numpy state dict, int8 flag) on the CPU."
    from uniception_tpu_torch.models.factory.dust3r import DUSt3R
    from uniception_tpu_torch.nn.quant import quantize_linears
    from uniception_tpu_torch.utils.weights import load_state_dict_numpy

    model = DUSt3R(**spec["kwargs"], device="cpu")
    load_state_dict_numpy(model, spec["state"])
    if spec.get("int8"):
        quantize_linears(model.encoder, min_params=1)
        quantize_linears(model.info_sharing, min_params=1)
    return model.eval()


def _tp_shapes(model):
    "Local shapes of the first encoder and decoder block's column- and row-parallel weights."
    enc, dec = model.encoder.enc_blocks[0], model.info_sharing.multi_view_branches[0][0]

    def w(lin):
        lin = getattr(lin, "inner", lin)  # a row-parallel layer's own
        return tuple((lin.w_q if hasattr(lin, "w_q") else lin.weight).shape)

    return {"enc.attn.qkv": w(enc.attn.qkv), "enc.attn.proj": w(enc.attn.proj), "enc.mlp.fc1": w(enc.mlp.fc1),
            "enc.mlp.fc2": w(enc.mlp.fc2), "dec.cross_attn.projq": w(dec.cross_attn.projq),
            "dec.cross_attn.proj": w(dec.cross_attn.proj), "enc.heads": enc.attn.num_heads}


def infer_cases(cases):
    """``make_infer_fn`` on each case: dict(name, spec, data, model_axis, use_tp, img1, img2). Returns
    {name: (pts3d, conf, pts3d_in_other_view, conf2, tp shapes)} and the world's facts."""
    from uniception_tpu_torch.parallel import comm
    from uniception_tpu_torch.parallel.inference import make_infer_fn

    out = {}
    for case in cases:
        model = _dust3r(case["spec"])
        ctx, params = make_infer_fn(model, data=case["data"], model_axis=case["model_axis"], use_tp=case["use_tp"])
        comm.calls.clear()
        s1, s2 = ctx.shard((_t(case["img1"]), _t(case["img2"])))
        r1, r2 = ctx.infer(params, s1, s2)
        out[case["name"]] = {"pts3d": r1["pts3d"], "conf": r1["conf"], "pts3d_in_other_view": r2["pts3d_in_other_view"],
                             "conf2": r2["conf"], "shapes": _tp_shapes(params), "all_reduces": comm.calls["all_reduce"]}
    return {"cases": out, "jax_free": _jax_free(), "transport": comm.transport()}


def ring_cases(cases):
    "``ring_attention_sharded`` on each case: dict(name, q, k, v, dtype, data, model). Returns {name: output}."
    from uniception_tpu_torch.parallel.mesh import make_mesh
    from uniception_tpu_torch.parallel.ring_attention import ring_attention_sharded

    out = {}
    for case in cases:
        mesh = make_mesh(data=case["data"], model=case["model"])
        q, k, v = (_t(case[n]).to(getattr(torch, case["dtype"])) for n in "qkv")
        out[case["name"]] = ring_attention_sharded(q, k, v, mesh, "data")
    return {"cases": out, "jax_free": _jax_free()}


def multiview_sp(spec, views):
    "MultiViewPointmapModel(sequence_parallel=(mesh, 'data')) on ``views``: every view's pts3d and conf."
    from uniception_tpu_torch.models.factory.multiview import MultiViewPointmapModel
    from uniception_tpu_torch.ops import attention
    from uniception_tpu_torch.parallel import comm
    from uniception_tpu_torch.parallel.mesh import make_mesh
    from uniception_tpu_torch.utils.weights import load_state_dict_numpy

    mesh = make_mesh(data=-1, model=1)
    model = MultiViewPointmapModel(**spec["kwargs"], sequence_parallel=(mesh, "data"), device="cpu")
    load_state_dict_numpy(model, spec["state"])
    comm.calls.clear()
    with torch.no_grad():
        res = model.eval()([_t(v) for v in views])
    assert attention.get_sequence_parallel() is None  # the context was left
    return {"views": [(r["pts3d"], r["conf"]) for r in res], "exchanges": comm.calls["exchange"]}


def preemption(sync_every):
    """PreemptionGuard over the world: only the last rank is signalled, before the first call. Returns what
    ``should_stop`` said at each of 2 * sync_every calls."""
    from uniception_tpu_torch.parallel import comm
    from uniception_tpu_torch.parallel.training import PreemptionGuard

    guard = PreemptionGuard(signals=(signal.SIGUSR1,), sync_every=sync_every)
    try:
        if comm.rank() == comm.world_size() - 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return [guard.should_stop() for _ in range(2 * sync_every)]
    finally:
        guard.close()


def row_parallel_mlp(x, modes, seed=0):
    """An ``Mlp`` (64 -> 256 -> 64, fp32) in each of ``modes`` ("float", or an int8 activation mode: "dynamic",
    "zero_point", "static"), unsharded and then under tensor parallelism over the world ("model" axis): {mode:
    (unsharded output, sharded output, fc2's local (in, out) shape, fc2 wrapped in RowParallel)}."""
    from uniception_tpu_torch.nn.blocks import Mlp
    from uniception_tpu_torch.nn.quant import quantize_linears
    from uniception_tpu_torch.parallel import comm
    from uniception_tpu_torch.parallel.mesh import RowParallel, make_mesh, tp_shard_state

    x = _t(x)
    out = {}
    for mode in modes:
        mlp = Mlp(64, 256, device="cpu", generator=torch.Generator().manual_seed(seed)).eval()
        if mode != "float":
            quantize_linears(mlp, min_params=1, asym=(lambda p, l: True) if mode == "zero_point" else None)
            if mode == "static":
                mlp.fc1.a_scale = x.abs().max() / 127
                mlp.fc2.a_scale = mlp.fc1(x).abs().max() / 100  # some codes clip, as a calibrated scale may
        ref = mlp(x)
        tp_shard_state(mlp, make_mesh(data=1, model=comm.world_size()))
        lin = getattr(mlp.fc2, "inner", mlp.fc2)
        w = lin.w_q.t() if hasattr(lin, "w_q") else lin.weight.t()
        out[mode] = (ref, mlp(x), tuple(w.shape), isinstance(mlp.fc2, RowParallel))
    return out


def serving_world(infer, ring, mv=None, sync_every=None, rp=None):
    """One world's serving cases: sharded inference, the ring, the multi-view model under SP, the preemption OR, a
    row-parallel MLP in each mode."""
    torch.set_grad_enabled(False)
    out = {"infer": infer_cases(infer), "ring": ring_cases(ring)}
    if mv is not None:
        out["mv"] = multiview_sp(*mv)
    if rp is not None:
        out["rp"] = row_parallel_mlp(*rp)
    if sync_every is not None:
        torch.set_grad_enabled(True)
        out["preempt"] = preemption(sync_every)
    return out


def _blocks(spec):
    "The port's SelfAttentionBlock list of ``spec`` (constructor kwargs, depth, numpy state dict of the list)."
    from uniception_tpu_torch.nn.blocks import SelfAttentionBlock
    from uniception_tpu_torch.ops.rope import Rope2D
    from uniception_tpu_torch.utils.weights import load_state_dict_numpy

    kw = dict(spec["kwargs"])
    if kw.pop("rope", False):
        kw["custom_positional_encoding"] = Rope2D(100.0)
    blocks = torch.nn.ModuleList([SelfAttentionBlock(**kw, device="cpu") for _ in range(spec["depth"])])
    load_state_dict_numpy(blocks, spec["state"])
    return blocks.eval()


def pipeline_cases(cases):
    """``pipeline_blocks`` on each case: dict(name, spec, axes, shape, data_axis, model_axis, microbatches, x[, pos]).
    Returns {name: (output, blocks this rank holds, tp shapes)}."""
    from uniception_tpu_torch.parallel.mesh import Mesh
    from uniception_tpu_torch.parallel.pipeline import pipeline_blocks, shard_stacked_state

    torch.set_grad_enabled(False)
    out = {}
    for case in cases:
        blocks = _blocks(case["spec"])
        mesh = Mesh(np.arange(int(np.prod(case["shape"]))).reshape(case["shape"]), case["axes"])
        shard_stacked_state(blocks, mesh, model_axis=case.get("model_axis"))
        args = (_t(case["pos"]),) if "pos" in case else ()
        y = pipeline_blocks(blocks, _t(case["x"]), *args, mesh=mesh, data_axis=case.get("data_axis"),
                            model_axis=case.get("model_axis"), num_microbatches=case["microbatches"])
        held = [i for i, b in enumerate(blocks) if not isinstance(b, torch.nn.Identity)]
        qkv = blocks[held[0]].attn.qkv.weight.shape
        out[case["name"]] = {"out": y, "held": held, "qkv": tuple(qkv)}
    return {"cases": out, "jax_free": _jax_free()}
