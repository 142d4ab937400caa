"""
Gradients through the port's multi-GPU layer (uniception_tpu_torch/parallel/): the ring (ring_attention.py: K1 with
its logsumexp forward, K3 on each chunk from the global logsumexp backward; on the CPU their plain versions), the
sequence-parallel global-attention transformer, the GPipe pipeline's reverse schedule (pipeline.py) at pp, pp x dp
and pp x tp, and tensor parallelism's column and row operators (comm.py ``copy_to`` / ``reduce_from``, mesh.py
``ColumnParallel`` / ``RowParallel``), on the CPU against the JAX package.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py (the ring and the sequence-parallel transformer
at their own tests' setups, tests/parallel/test_ring_attention.py:37 and test_sequence_parallel_model.py:84) or as
its scan of the stacked blocks (its pipeline's gradients equal the scan's, tests/parallel/test_pipeline_parallel.py;
a pipeline compile costs 10 s a mesh here). The port's side runs in one world of 4 gloo rank processes, started once
for the module (tests/torch_ranks.py ``grads_world``, which imports no JAX). Every rank returns the whole gradients
of its (replicated) loss; a gradient counted once per rank, or dropped, would show as a factor of 4 or a zero.
Bars: fp32 5e-5 of max(1, max |reference|) (the repo's parity bar); the transformer's parameter gradients at JAX's
own bar for them (1e-4 of each gradient's max).
"""

import functools
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests import torch_ranks
from tests.test_torch_multiview import _jax_tables
from tests.test_torch_parallel_pipeline import BLOCK, DEPTH, _jax_stacked, _port_blocks
from tests.test_torch_quant import jax_module
from uniception_tpu.models.info_sharing.base import MultiViewTransformerInput as JaxMVInput
from uniception_tpu.models.info_sharing.global_attention_transformer import (
    MultiViewGlobalAttentionTransformer as JaxGlobal,
)
from uniception_tpu.nn.scan import scan_blocks
from uniception_tpu.ops.attention import sequence_parallel as jax_sequence_parallel
from uniception_tpu.parallel.mesh import make_mesh as jax_make_mesh
from uniception_tpu.parallel.ring_attention import ring_attention_sharded as jax_ring_attention_sharded
from uniception_tpu.utils.pytree import keypath_str
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch.models.info_sharing.global_attention_transformer import MultiViewGlobalAttentionTransformer
from uniception_tpu_torch.parallel import comm

TOL = 5e-5  # fp32, relative to max(1, max |reference|)
SP_TOL = 1e-4  # tests/parallel/test_sequence_parallel_model.py: each parameter gradient within 1e-4 of its max
WORLD = 4
SP = dict(name="sp_grad", input_embed_dim=48, dim=64, depth=2, num_heads=4)
# (name, port axes, port mesh shape, data axis, model axis, batch)
PIPES = [("pp", ("stage",), (4,), None, None, 4), ("pp_dp", ("stage", "data"), (2, 2), "data", None, 8),
         ("pp_tp", ("stage", "model"), (2, 2), None, "model", 4)]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _ring_inputs():
    "The JAX ring test's setup: B 2, 256 tokens, H 4, D 32, and a random cotangent."
    rng = np.random.RandomState(1)
    return [rng.randn(2, 256, 4, 32).astype(np.float32) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _sp_inputs():
    "The port's seeded transformer's state (every bias non-zero), the 4 views (2, 48, 4, 4) and their cotangents."
    model = MultiViewGlobalAttentionTransformer(**SP, device="cpu", generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    views = [rng.randn(2, 48, 4, 4).astype(np.float32) for _ in range(4)]
    cots = [rng.randn(2, 64, 4, 4).astype(np.float32) for _ in range(4)]
    return {k: v.numpy() for k, v in model.state_dict().items()}, views, cots


def _pipe_inputs(batch, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(batch, 16, 32).astype(np.float32), rng.randn(batch, 16, 32).astype(np.float32)


def _tp_input():
    return np.random.RandomState(5).randn(2, 24, 64).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    "The port's world of 4 gloo ranks on the CPU, started in the background when the first test needs it."
    state, views, cots = _sp_inputs()
    pipes = []
    for name, axes, shape, data_axis, model_axis, batch in PIPES:
        x, cot = _pipe_inputs(batch, len(name))
        pipes.append(dict(name=name, spec={"kwargs": dict(BLOCK), "depth": DEPTH, "state": _port_blocks(False)[1]},
                          axes=axes, shape=shape, data_axis=data_axis, model_axis=model_axis, microbatches=4, x=x,
                          cot=cot))
    pool = ThreadPoolExecutor(1)
    future = pool.submit(comm.spawn, torch_ranks.grads_world, WORLD, _ring_inputs(),
                         ({"kwargs": SP, "state": state}, views, cots), pipes, _tp_input(), device="cpu", threads=1,
                         timeout=900)
    yield types.SimpleNamespace(get=future.result)
    pool.shutdown()


# --- the ring ---------------------------------------------------------------------------------------------------


def test_ring_gradients_match_jax(world):
    """d<ring(q, k, v), cot>/d(q, k, v) over 4 ranks against JAX's ring over 8 devices (each rank the whole
    gradients: its slice of dO through the second ring, then the chunks' gradients gathered)."""
    q, k, v, cot = (jnp.asarray(a) for a in _ring_inputs())
    jmesh = jax_make_mesh(data=8, model=1)

    def loss(q, k, v):
        with jmesh:
            return jnp.vdot(jax_ring_attention_sharded(q, k, v, jmesh, axis_name="data"), cot)

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for r in world.get():
        got = r["ring"]
        assert got["exchanges"] == (WORLD - 1) + WORLD  # forward: n - 1 rotations; backward: n (the last home)
        for g, want in zip(got["grads"], ref):
            _close(g, want)


def test_sequence_parallel_transformer_grads_match_jax(world):
    """The global-attention transformer's parameter gradients under sequence parallelism over 4 ranks against JAX's
    under its sequence parallelism over 8 devices, each gradient within 1e-4 of its max (JAX's own bar against its
    unsharded gradients)."""
    state, views, cots = _sp_inputs()
    jmod = _jax_tables(jax_module(lambda: JaxGlobal(**SP, rngs=nnx.Rngs(0))))
    load_torch_state_dict(jmod, state, verbose=False)
    graphdef, params, rest = nnx.split(jmod, nnx.Param, ...)
    jmesh = jax_make_mesh(data=8, model=1)

    def loss(params):
        m = nnx.merge(graphdef, params, rest)
        with jax_sequence_parallel(jmesh, "data"):
            out = m(JaxMVInput(features=[jnp.asarray(v) for v in views]))
        return sum(jnp.vdot(f, jnp.asarray(c)) for f, c in zip(out.features, cots))

    grads = jax.grad(loss)(params)
    want = state_dict_from_module(nnx.merge(graphdef, grads, rest))
    for r in world.get():
        got = r["sp"]
        assert got["exchanges"] > 0 and set(got["grads"]) <= set(want)
        for name, g in got["grads"].items():
            scale = max(float(np.abs(want[name]).max()), 1e-8)
            assert np.abs(g - want[name]).max() <= SP_TOL * scale, name


# --- the pipeline ---------------------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_scan_grads(batch, seed):
    "JAX's gradients of <scan_blocks(stacked, x), cot> (input, and each block's parameters in the port's names)."
    state = _port_blocks(False)[1]
    stacked = _jax_stacked(state, False)
    graphdef, params, rest = nnx.split(stacked, nnx.Param, ...)
    x, cot = (jnp.asarray(a) for a in _pipe_inputs(batch, seed))

    def loss(params, x):
        return jnp.vdot(scan_blocks(nnx.merge(graphdef, params, rest), x), cot)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    flat = {keypath_str(kp).removesuffix(".value"): np.asarray(g) for kp, g in jax.tree_util.tree_flatten_with_path(gp)[0]}
    out = {}
    for key, a in state.items():  # the port's "i.<path>": block i of JAX's stacked leaf, in the port's layout
        i, path = key.split(".", 1)
        stem = path.rsplit(".", 1)[0]
        jpath = next((p for p in (path, f"{stem}.kernel", f"{stem}.scale") if p in flat), None)
        if jpath is None:
            continue
        g = flat[jpath][int(i)]
        out[key] = g.T if jpath.endswith(".kernel") else g
    return np.asarray(gx), out


@pytest.mark.parametrize("name,axes,shape,data_axis,model_axis,batch", PIPES, ids=[p[0] for p in PIPES])
def test_pipeline_gradients_match_jax_scan(world, name, axes, shape, data_axis, model_axis, batch):
    """GPipe's backward (4 microbatches; pp over 4 stages, pp x dp and pp x tp at 2 x 2): every rank's input
    gradient, and its stage's parameter gradients (summed over the microbatches and the data axis; under TP gathered
    whole), against JAX's gradients of its scan of the same blocks."""
    gx, gp = _jax_scan_grads(batch, len(name))
    ranks = world.get()
    held = set()
    for r in ranks:
        got = r["pipe"][name]
        _close(got["dx"], gx)
        for key, g in got["grads"].items():
            _close(g, gp[key])
            held.add(key)
    assert held == set(gp)  # every block's parameters on some stage, none missed


# --- tensor parallelism's operators ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", ["mlp", "attn"])
def test_column_and_row_parallel_gradients_match_unsharded(world, module):
    """An MLP and a self-attention layer under 2-way TP (data 2 x model 2) against themselves unsharded: output,
    input gradient (the column-parallel input's gradient summed over the model axis) and every weight gradient
    (gathered whole); one all-reduce forward (the row-parallel sum) and one backward (the column-parallel input)."""
    for r in world.get():
        ref, got = r["tp"][module]
        _close(got["y"], ref["y"])
        _close(got["dx"], ref["dx"])
        assert set(got["grads"]) == set(ref["grads"])
        for key, g in got["grads"].items():
            _close(g, ref["grads"][key])
        assert got["all_reduces"] == 2 and ref["all_reduces"] == 0


def test_rank_processes_import_no_jax(world):
    assert world.get()[0]["jax_free"]
