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


# --- training across ranks (tests/test_torch_parallel_training.py) ---------------------------------------------


def _whole_params(ctx):
    "{unsharded name: whole parameter} of a train context (gathered over the world), on every rank."
    from uniception_tpu_torch.parallel import training

    tensors, _, layouts, _ = training._state_tensors(ctx)
    return {k[len("params."):]: (training._whole(ctx.mesh, t, layouts[k]) if layouts else t).detach().clone()
            for k, t in tensors.items() if k.startswith("params.")}


def _local_bytes(ctx):
    "(bytes of the parameters, bytes of the optimizer moments) this rank holds."
    params = sum(p.numel() * p.element_size() for p in ctx.model.parameters())
    moments = sum(t.numel() * t.element_size() for t in ctx.optimizer.mu + ctx.optimizer.nu)
    return params, moments


def train_case(spec, case, batches):
    """``make_train_step`` on the port's DUSt3R of ``spec`` with ``case`` (its options), one step per batch on this
    rank's rows. Returns the losses, grad norms, counters, bytes held and (rank 0) the whole parameters."""
    from uniception_tpu_torch.parallel import comm, training
    from uniception_tpu_torch.parallel.mesh import shard_batch

    model = _dust3r(spec).train()
    ctx = training.make_train_step(model, **case["options"])
    losses, norms = [], []
    for b in batches:
        out = ctx.step(*shard_batch(tuple(_t(a) for a in b), ctx.mesh))
        loss, aux = out if ctx.metrics else (out, None)
        losses.append(float(loss))
        if aux is not None:
            norms.append(float(aux["grad_norm"]))
    whole = _whole_params(ctx)
    return {"losses": losses, "norms": norms, "count": ctx.optimizer.count, "notfinite": ctx.notfinite_count,
            "bytes": _local_bytes(ctx), "params": whole if comm.rank() == 0 else None,
            "moments": ({n: (m, v) for n, m, v in zip(ctx.names, ctx.optimizer.mu, ctx.optimizer.nu)}
                        if case.get("moments") and comm.rank() == 0 else None)}


def resume_case(spec, options, batches, path):
    """Two steps, a sharded save, one more step; then a fresh model and context restore the file and take that step
    again. Returns both runs' whole parameters (rank 0), the saved file's keys and shapes, and what each rank wrote."""
    from uniception_tpu_torch.parallel import comm, training
    from uniception_tpu_torch.parallel.mesh import shard_batch

    def run(restore):
        ctx = training.make_train_step(_dust3r(spec).train(), **options)
        todo = batches
        if restore:
            assert training.restore_train_state(path, ctx) == 2
            todo = batches[2:]
        for i, b in enumerate(todo):
            ctx.step(*shard_batch(tuple(_t(a) for a in b), ctx.mesh))
            if not restore and i == 1:
                out = training.save_train_state(path, ctx, step=2)
                comm.all_reduce(torch.zeros(1))  # the file is whole before any rank reads it
                assert out is None
        return _whole_params(ctx), ctx

    uninterrupted, _ = run(False)
    resumed, ctx = run(True)
    saved = torch.load(os.path.join(path, training.STATE_FILE), weights_only=True)
    return {"uninterrupted": uninterrupted if comm.rank() == 0 else None,
            "resumed": resumed if comm.rank() == 0 else None,
            "shapes": {k: tuple(v.shape) for k, v in saved["tensors"].items()} if comm.rank() == 0 else None,
            "count": ctx.optimizer.count, "ema": ema_case(ctx, path + "_ema")}


def ema_case(ctx, path):
    """An EMA of a sharded context's parameters (the rank's parts, by unsharded name), saved whole with ``ctx`` and
    restored into zeros: whether every rank got its parts back, and (rank 0) the file's tensors."""
    from uniception_tpu_torch.parallel import comm, training
    from uniception_tpu_torch.parallel.mesh import canonical_name

    ema = training.ema_init({canonical_name(k): v for k, v in ctx.model.named_parameters()})
    assert training.save_train_state(path, ema, step=3, ctx=ctx) is None
    comm.all_reduce(torch.zeros(1))  # the file is whole before any rank reads it
    back = {k: torch.zeros_like(v) for k, v in ema.items()}
    assert training.restore_train_state(path, back, ctx=ctx) == 3
    saved = torch.load(os.path.join(path, training.STATE_FILE), weights_only=True)["tensors"]
    return {"parts_back": all(torch.equal(back[k], v) for k, v in ema.items()),
            "file": {k: v.numpy() for k, v in saved.items()} if comm.rank() == 0 else None}


def custom_loss_case(spec, batch):
    """A caller's loss that takes no share of the global batch (a mean over this rank's rows) under a data axis:
    the step's ValueError, and whether the parameters were left as they were."""
    from uniception_tpu_torch.parallel import training
    from uniception_tpu_torch.parallel.mesh import shard_batch

    def loss_fn(m, img1, img2, target1, target2):
        res1, _ = m.forward_pair(img1, img2)
        return (res1["pts3d"] - target1).abs().mean()

    ctx = training.make_train_step(_dust3r(spec).train(), loss_fn=loss_fn)
    before = [p.detach().clone() for p in ctx.params]
    try:
        ctx.step(*shard_batch(tuple(_t(a) for a in batch), ctx.mesh))
        error = None
    except ValueError as e:
        error = str(e)
    return {"error": error, "unchanged": all(torch.equal(a, p) for a, p in zip(before, ctx.params))}


def flow_loss_share(flow, conf, target, valid):
    """This rank's rows of a flow batch (each rank its own valid count): its share of the global batch's loss under
    ``global_batch`` and its gradient, and the shares summed over the world."""
    from uniception_tpu_torch.parallel import comm, training
    from uniception_tpu_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(data=-1, model=1)
    f, c, t, v = shard_batch((_t(flow), _t(conf), _t(target), _t(valid)), mesh)
    f.requires_grad_(True)
    c.requires_grad_(True)
    with training.global_batch(mesh.group("data"), mesh.shape["data"]):
        share = training.flow_confidence_loss({"flow": f, "flow_conf": c}, t, valid=v)
    gf, gc = torch.autograd.grad(share, [f, c])
    return {"loss": comm.all_reduce(share.detach(), "sum"), "valid": int(v.sum()), "grads": (gf, gc)}


def training_world(spec, cases, batches, resume, flow, ckpt):
    "Every training case of the file on one world, then the sharded save and resume, then the flow loss's share."
    torch.manual_seed(0)
    out = {name: train_case(spec, case, [batches[i] for i in case["batches"]]) for name, case in cases.items()}
    out["resume"] = resume_case(spec, resume, batches[:3], ckpt)
    out["flow"] = flow_loss_share(*flow)
    out["custom_loss"] = custom_loss_case(spec, batches[0])
    out["jax_free"] = _jax_free()
    return out


# --- gradients through the ring, the pipeline and TP (tests/test_torch_parallel_grads.py) ----------------------


def ring_grads(q, k, v, cot):
    "dq, dk, dv of <ring_attention_sharded(q, k, v), cot> over the world's ranks, each rank the whole gradients."
    from uniception_tpu_torch.parallel import comm
    from uniception_tpu_torch.parallel.mesh import make_mesh
    from uniception_tpu_torch.parallel.ring_attention import ring_attention_sharded

    mesh = make_mesh(data=-1, model=1)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    comm.calls.clear()
    loss = (ring_attention_sharded(*leaves, mesh, "data") * _t(cot)).sum()
    grads = torch.autograd.grad(loss, leaves)
    return {"grads": grads, "exchanges": comm.calls["exchange"]}


def sp_grads(spec, views, cots):
    """Parameter gradients of sum_v <out_v, cot_v> of the global-attention transformer under sequence parallelism
    over the world (the ring takes every attention call)."""
    from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
    from uniception_tpu_torch.models.info_sharing.global_attention_transformer import (
        MultiViewGlobalAttentionTransformer,
    )
    from uniception_tpu_torch.ops.attention import sequence_parallel
    from uniception_tpu_torch.parallel import comm
    from uniception_tpu_torch.parallel.mesh import make_mesh
    from uniception_tpu_torch.utils.weights import load_state_dict_numpy

    model = MultiViewGlobalAttentionTransformer(**spec["kwargs"], device="cpu")
    load_state_dict_numpy(model, spec["state"])
    mesh = make_mesh(data=-1, model=1)
    comm.calls.clear()
    with sequence_parallel(mesh, "data"):
        out = model(MultiViewTransformerInput(features=[_t(v) for v in views]))
    loss = sum((f * _t(c)).sum() for f, c in zip(out.features, cots))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {"grads": {n: g for (n, _), g in zip(named, grads)}, "exchanges": comm.calls["exchange"]}


def pipeline_grads(cases):
    """``pipeline_blocks`` under autograd on each case: dict(name, spec, axes, shape, data_axis, model_axis,
    microbatches, x, cot). Returns {name: (dx, {block parameter name: whole gradient} of the rank's stage)}."""
    from uniception_tpu_torch.parallel import training
    from uniception_tpu_torch.parallel.mesh import Mesh
    from uniception_tpu_torch.parallel.pipeline import pipeline_blocks, shard_stacked_state

    out = {}
    for case in cases:
        blocks = _blocks(case["spec"]).train()
        mesh = Mesh(np.arange(int(np.prod(case["shape"]))).reshape(case["shape"]), case["axes"])
        shard_stacked_state(blocks, mesh, model_axis=case.get("model_axis"))
        x = _t(case["x"]).requires_grad_(True)
        y = pipeline_blocks(blocks, x, mesh=mesh, data_axis=case.get("data_axis"), model_axis=case.get("model_axis"),
                            num_microbatches=case["microbatches"])
        held = []
        for mname, m in blocks.named_modules():
            for pname, p in m.named_parameters(recurse=False):
                held.append((f"{mname}.{pname}".replace(".inner.", "."), p, getattr(m, "tp_layout", {}).get(pname)))
        grads = torch.autograd.grad((y * _t(case["cot"])).sum(), [x] + [p for _, p, _ in held])
        whole = {n: (training._whole(mesh, g, (tp, None)) if tp is not None else g)
                 for (n, _, tp), g in zip(held, grads[1:])}
        out[case["name"]] = {"dx": grads[0], "grads": whole}
    return out


def tp_grads(x, seed=0):
    """An fp32 ``Mlp`` (64 -> 256 -> 64) and self-``Attention`` (64 wide, 4 heads, qkv bias) unsharded and under
    tensor parallelism (data 2 x model 2): outputs, input gradients and whole weight gradients of <out, out>."""
    from uniception_tpu_torch.nn.blocks import Attention, Mlp
    from uniception_tpu_torch.parallel import comm, training
    from uniception_tpu_torch.parallel.mesh import make_mesh, tp_shard_state

    mesh = make_mesh(data=2, model=2)
    out = {}
    for name, make in (("mlp", lambda g: Mlp(64, 256, device="cpu", generator=g)),
                       ("attn", lambda g: Attention(64, 4, qkv_bias=True, device="cpu", generator=g))):
        runs = []
        for shard in (False, True):
            mod = torch.nn.Module()  # the layer under its name in a block, which the TP rules anchor on
            setattr(mod, name, make(torch.Generator().manual_seed(seed)))
            if shard:
                tp_shard_state(mod, mesh)
            xi = _t(x).requires_grad_(True)
            comm.calls.clear()
            y = getattr(mod, name)(xi)
            named = []
            for mname, m in mod.named_modules():
                for pname, p in m.named_parameters(recurse=False):
                    named.append((f"{mname}.{pname}".replace(".inner.", "."), p,
                                  getattr(m, "tp_layout", {}).get(pname)))
            grads = torch.autograd.grad((y * y).sum(), [xi] + [p for _, p, _ in named])
            whole = {n: (training._whole(mesh, g, (tp, None)) if tp is not None else g)
                     for (n, _, tp), g in zip(named, grads[1:])}
            runs.append({"y": y, "dx": grads[0], "grads": whole, "all_reduces": comm.calls["all_reduce"]})
        out[name] = runs
    return out


def grads_world(ring, sp, pipes, x_tp):
    "Every case of tests/test_torch_parallel_grads.py on one world of 4 ranks."
    return {"ring": ring_grads(*ring), "sp": sp_grads(*sp), "pipe": pipeline_grads(pipes), "tp": tp_grads(x_tp),
            "jax_free": _jax_free()}
