"""
The port's pipeline parallelism (uniception_tpu_torch/parallel/pipeline.py:
GPipe over ranks, with a data axis and with a model axis) and its chain
pipeline (parallel/chain.py: DUSt3R's encoder -> info sharing -> heads, one
device and stream per stage) against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices at its own tests' mesh shapes;
the port's pipeline runs in rank processes under gloo, one world of 2 ranks
and one of 4, each started once for the module (tests/torch_ranks.py, which
imports no JAX). The weights are the port's seeded modules, carried into JAX
modules built from zeros (the scan layout's stacked blocks take the list's
blocks in depth order). Tolerance: 5e-5 max abs in fp32.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.sharding import Mesh as JaxMesh

from tests import torch_ranks
from tests.test_torch_quant import jax_module
from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.nn.blocks import SelfAttentionBlock as JaxBlock
from uniception_tpu.nn.scan import make_stacked_blocks, scan_blocks, stacked_state_from_list
from uniception_tpu.ops.rope import Rope2D as JaxRope2D
from uniception_tpu.parallel import chain as jchain
from uniception_tpu.parallel.pipeline import pipeline_blocks as jax_pipeline_blocks
from uniception_tpu.utils.torch_compat import load_torch_state_dict
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.nn.blocks import SelfAttentionBlock
from uniception_tpu_torch.ops.rope import Rope2D
from uniception_tpu_torch.parallel import chain, comm

TOL = 5e-5  # fp32 max abs, the repo's parity bar
INF = float("inf")
DEPTH = 4
BLOCK = dict(dim=32, num_heads=4, qkv_bias=True)
# (name, port world, port axes, port mesh shape, data axis, model axis, JAX mesh shape, batch, RoPE)
PIPELINES = [
    ("pp", 2, ("stage",), (2,), None, None, (2,), 8, True),
    ("pp_dp", 4, ("stage", "data"), (2, 2), "data", None, (2, 4), 16, False),
    ("pp_dp_tp", 4, ("stage", "data", "model"), (2, 1, 2), "data", "model", (2, 2, 2), 8, False),
]
SMALL = dict(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=64,
             info_sharing_depth=2, info_sharing_num_heads=4, depth_mode=("linear", -INF, INF),
             conf_mode=("sigmoid", 0.0, 1.0))


def _port_blocks(rope: bool):
    "The port's seeded blocks, every bias drawn non-zero; with their numpy state dict."
    gen = torch.Generator().manual_seed(0)
    pe = Rope2D(100.0) if rope else None
    blocks = torch.nn.ModuleList([SelfAttentionBlock(**BLOCK, custom_positional_encoding=pe, generator=gen)
                                  for _ in range(DEPTH)])
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in blocks.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    return blocks.eval(), {k: v.numpy() for k, v in blocks.state_dict().items()}


def _jax_stacked(state, rope: bool):
    "The JAX scan layout of the same blocks: each block loaded from the port's, the states stacked in depth order."
    def ctor(r):
        return JaxBlock(**BLOCK, custom_positional_encoding=JaxRope2D(100.0) if rope else None, rngs=r)

    blocks = []
    for i in range(DEPTH):
        blk = jax_module(lambda: ctor(nnx.Rngs(0)))
        load_torch_state_dict(blk, {k[len(f"{i}."):]: v for k, v in state.items() if k.startswith(f"{i}.")},
                              verbose=False)
        blocks.append(blk)
    stacked = jax_module(lambda: make_stacked_blocks(DEPTH, ctor, nnx.Rngs(0)))
    nnx.update(stacked, stacked_state_from_list(blocks))
    stacked.stacked_depth = DEPTH
    return stacked


def _inputs(batch, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(batch, 16, 32).astype(np.float32), rng.randint(0, 7, (batch, 16, 2)).astype(np.int64)


@pytest.fixture(scope="module")
def worlds():
    "The port's pipelines on 2 and 4 gloo ranks, started together in the background; every rank's results."
    cases = {2: [], 4: []}
    for name, world, axes, shape, data_axis, model_axis, _, batch, rope in PIPELINES:
        x, pos = _inputs(batch, len(name))
        case = dict(name=name, spec={"kwargs": dict(BLOCK, rope=rope), "depth": DEPTH, "state": _port_blocks(rope)[1]},
                    axes=axes, shape=shape, data_axis=data_axis, model_axis=model_axis, microbatches=4, x=x)
        if rope:
            case["pos"] = pos
        cases[world].append(case)
    pool = ThreadPoolExecutor(2)
    futures = {w: pool.submit(comm.spawn, torch_ranks.pipeline_cases, w, cases[w], device="cpu", threads=1,
                              timeout=900)
               for w in (2, 4)}
    yield types.SimpleNamespace(get=lambda world: futures[world].result())
    pool.shutdown()


@pytest.mark.parametrize("name,world,axes,shape,data_axis,model_axis,jax_shape,batch,rope", PIPELINES,
                         ids=[p[0] for p in PIPELINES])
def test_pipeline_blocks_match_jax(worlds, name, world, axes, shape, data_axis, model_axis, jax_shape, batch, rope):
    """GPipe over 2 stages x 4 microbatches (RoPE positions microbatched alongside) against JAX's pipeline over 2
    devices; with a data axis (pp x dp) and with data and model axes (pp x dp x tp) against JAX's scan of the same
    stacked blocks. Each rank holds only its stage's blocks (under TP half of each), and every rank returns the
    whole batch."""
    blocks, state = _port_blocks(rope)
    x, pos = _inputs(batch, len(name))
    stacked = _jax_stacked(state, rope)
    jmesh = JaxMesh(np.asarray(jax.devices()[: int(np.prod(jax_shape))]).reshape(jax_shape), axes)
    args = (jnp.asarray(pos.astype(np.int32)),) if rope else ()
    if data_axis is None:
        ref = np.asarray(jax_pipeline_blocks(stacked, jnp.asarray(x), *args, mesh=jmesh, num_microbatches=4))
    else:  # JAX's pipeline over its meshes equals its scan (tests/parallel/test_pipeline_parallel.py); a compile
        # of each costs 10 s here
        ref = np.asarray(scan_blocks(stacked, jnp.asarray(x), *args))
    with torch.no_grad():  # the loop, as a second witness
        h = torch.from_numpy(x)
        for blk in blocks:
            h = blk(h, *(torch.from_numpy(pos),) if rope else ())
    np.testing.assert_allclose(h.numpy(), ref, rtol=0, atol=TOL)
    ranks = worlds.get(world)
    per_stage = DEPTH // shape[0]
    qkv_rows = 3 * BLOCK["dim"] // (shape[axes.index("model")] if model_axis else 1)
    for rank, r in enumerate(ranks):
        assert r["jax_free"]
        got = r["cases"][name]
        assert np.abs(got["out"] - ref).max() <= TOL, (rank, np.abs(got["out"] - ref).max())
        stage = np.unravel_index(rank, shape)[0]
        assert got["held"] == list(range(stage * per_stage, (stage + 1) * per_stage))
        assert got["qkv"] == (qkv_rows, BLOCK["dim"])


# --- the chain pipeline --------------------------------------------------------------------------------------


class _Lin(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))


class _JaxLin(nnx.Module):
    def __init__(self, w):
        self.w = nnx.Param(jnp.asarray(w))


def test_generic_chain_matches_jax():
    "Three unlike stages (a fan-out to two boundary tensors, then a stage taking both) against JAX's chain."
    rng = np.random.RandomState(0)
    ws = [rng.randn(8, 16).astype(np.float32) * 0.1, rng.randn(16, 4).astype(np.float32) * 0.1,
          rng.randn(4, 4).astype(np.float32) * 0.1]
    xs = [rng.randn(4, 8).astype(np.float32) for _ in range(3)]

    def t_b(m, x):
        y = x @ m.w
        return y, y.sum(-1, keepdim=True)

    pipe = chain.ChainPipeline([(lambda m, x: x @ m.w, _Lin(ws[0])), (t_b, _Lin(ws[1])),
                                (lambda m, y, s: y @ m.w + s, _Lin(ws[2]))], devices=["cpu"] * 3)
    jmods = [_JaxLin(w) for w in ws]
    gs = [nnx.split(m)[0] for m in jmods]

    def j_b(st, x):
        y = x @ nnx.merge(gs[1], st).w[...]
        return y, jnp.sum(y, axis=-1, keepdims=True)

    jpipe = jchain.ChainPipeline([(lambda st, x: x @ nnx.merge(gs[0], st).w[...], jmods[0]), (j_b, jmods[1]),
                                  (lambda st, y, s: y @ nnx.merge(gs[2], st).w[...] + s, jmods[2])],
                                 devices=jax.devices()[:3])
    with torch.no_grad():
        outs = pipe.run([torch.from_numpy(x) for x in xs])
    for got, want in zip(outs, jpipe.run([jnp.asarray(x) for x in xs])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def _dust3r(head: str):
    "The port's seeded DUSt3R, every bias non-zero."
    cfg = dict(SMALL, info_sharing_depth=9) if head == "dpt" else SMALL  # the factory's IFR hooks are [5, 8]
    model = DUSt3R(name="chain_test", pred_head_type=head, device="cpu", generator=torch.Generator().manual_seed(0),
                   **cfg)
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    return model.eval(), cfg


@pytest.mark.parametrize("head", ["linear", "dpt"])
def test_dust3r_chain_matches_jax_and_forward_pair(head):
    """The 3-stage DUSt3R chain on three CPU devices, streaming 3 microbatches, against the port's own forward_pair
    and, for the linear head, JAX's chain over 3 CPU devices carrying the same weights. (The DPT DUSt3R's JAX module
    takes 14 s to build even from abstract shapes; its forward_pair is held against JAX in tests/test_torch_dpt.py.)"""
    model, cfg = _dust3r(head)
    rng = np.random.RandomState(3)
    batches = [tuple(rng.randn(2, 3, 32, 32).astype(np.float32) for _ in range(2)) for _ in range(3)]
    pipe = chain.ChainPipeline(chain.dust3r_chain_stages(model), devices=["cpu", "cpu", "cpu"])
    got = pipe.run([tuple(torch.from_numpy(a) for a in b) for b in batches])
    want = [None] * len(batches)
    if head == "linear":
        jmodel = jax_module(lambda: JaxDUSt3R(name="chain_test", pred_head_type=head, rngs=nnx.Rngs(0), **cfg))
        load_torch_state_dict(jmodel, {k: v.numpy() for k, v in model.state_dict().items()}, verbose=False)
        jpipe = jchain.ChainPipeline(jchain.dust3r_chain_stages(jmodel), devices=jax.devices()[:3])
        want = jpipe.run([tuple(jnp.asarray(a) for a in b) for b in batches])
    for (i1, i2), g, w in zip(batches, got, want):
        with torch.no_grad():
            ref1, ref2 = model.forward_pair(torch.from_numpy(i1), torch.from_numpy(i2))
        res1, res2 = chain.dust3r_chain_results(g)
        for key, a, b in (("pts3d", res1, ref1), ("conf", res1, ref1), ("pts3d_in_other_view", res2, ref2),
                          ("conf", res2, ref2)):
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=TOL)
        for a, b in zip(g, w or ()):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL
    assert [next(m.parameters()).device.type for m in pipe._modules] == ["cpu"] * 3


def test_dust3r_chain_refuses_landscape_only_and_a_missing_card():
    model = DUSt3R(name="chain_test", landscape_only=True, device="cpu", **SMALL)
    with pytest.raises(NotImplementedError, match="landscape_only"):
        chain.dust3r_chain_stages(model)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chain.ChainPipeline([(lambda m, x: x, torch.nn.Identity())])
