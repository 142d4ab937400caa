"""
The port's multi-GPU serving layer (uniception_tpu_torch/parallel/: mesh, TP
rules, sharded inference, ring sequence parallelism, the cross-process
PreemptionGuard) against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py at its own
tests' mesh shapes; the port's side runs in rank processes under gloo, one
world of 2 ranks and one of 4, each started once for the module (the rank
programs are tests/torch_ranks.py, which imports no JAX). Every weight and
input is made here with numpy and passed to the ranks; the ranks return their
outputs. Tolerances: 5e-5 max abs in fp32 (linear and sigmoid adaptors, so no
exp amplifies the difference), and the JAX tests' quant-flip bar for int8 (2e-2
of the output scale at most, 1e-3 median).
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
from tests.test_torch_quant import jax_module
from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.factory.multiview import MultiViewPointmapModel as JaxMultiView
from uniception_tpu.nn import quant as jax_quant
from uniception_tpu.ops.attention import scaled_dot_product_attention as jax_sdpa
from uniception_tpu.parallel.inference import make_infer_fn as jax_make_infer_fn
from uniception_tpu.parallel.mesh import leaf_tp_spec as jax_leaf_tp_spec
from uniception_tpu.parallel.mesh import make_mesh as jax_make_mesh
from uniception_tpu.parallel.ring_attention import ring_attention_sharded as jax_ring_attention_sharded
from uniception_tpu.utils.pytree import keypath_str
from uniception_tpu.utils.torch_compat import load_torch_state_dict
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.factory.multiview import MultiViewPointmapModel
from uniception_tpu_torch.nn.quant import quantize_linears
from uniception_tpu_torch.parallel import comm
from uniception_tpu_torch.parallel import mesh as tmesh
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

TOL = 5e-5  # fp32 max abs, the repo's parity bar
INF = float("inf")
LINEAR_MODES = dict(depth_mode=("linear", -INF, INF), conf_mode=("sigmoid", 0.0, 1.0))
SMALL = dict(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=64,
             info_sharing_depth=2, info_sharing_num_heads=4, **LINEAR_MODES)
MV = dict(num_views=4, img_size=(32, 32), attention_type="global", enc_embed_dim=48, enc_depth=1, enc_num_heads=4,
          info_sharing_dim=64, info_sharing_depth=2, info_sharing_num_heads=4, **LINEAR_MODES)
# (name, port world, port (data, model), JAX (data, model), int8)
INFER = [("dp", 2, (2, 1), (8, 1), False), ("tp", 2, (1, 2), (4, 2), False), ("dp_tp", 4, (2, 2), (4, 2), False),
         ("dp_int8", 2, (2, 1), (8, 1), True), ("tp_int8", 2, (1, 2), (4, 2), True),
         ("dp_tp_int8", 4, (2, 2), (4, 2), True)]
# the JAX test's 256 tokens over 2 and 4 ranks; in bf16 the chunks cross gloo as bytes and the bar is K1's bf16 one
RING = [("ring_2", 2, "float32"), ("ring_4", 4, "float32"), ("ring_2_bf16", 2, "bfloat16")]
BF16_TOL = 2e-2
RP_MODES = ["float", "dynamic", "zero_point", "static"]  # a row-parallel layer's modes: fp32, and each int8 one


def _seeded(module, seed):
    "The port module in eval mode with every bias drawn non-zero, and its numpy state dict."
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    return module.eval(), {k: v.numpy() for k, v in module.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _port_state():
    "The numpy state dict of the port's seeded DUSt3R (fp32, before any quantization)."
    return _seeded(DUSt3R(name="infer_test", device="cpu", generator=torch.Generator().manual_seed(0), **SMALL), 0)[1]


@functools.lru_cache(maxsize=None)
def _jax_dust3r(int8: bool):
    "The JAX DUSt3R (built from zeros) carrying the port's weights, int8-quantized from them when asked."
    model = jax_module(lambda: JaxDUSt3R(name="infer_test", rngs=nnx.Rngs(0), **SMALL))
    load_torch_state_dict(model, _port_state(), verbose=False)
    if int8:
        assert jax_quant.quantize_linears(model.encoder, min_params=1) > 0
        assert jax_quant.quantize_linears(model.info_sharing, min_params=1) > 0
    return model


def _images(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(8, 3, 32, 32).astype(np.float32), rng.randn(8, 3, 32, 32).astype(np.float32)


def _mlp_input():
    return np.random.RandomState(5).randn(2, 24, 64).astype(np.float32)


def _ring_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 256, 4, 32).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _mv_inputs():
    "The port's seeded multi-view model's state, the views, and the JAX model carrying the same weights."
    _, state = _seeded(MultiViewPointmapModel(name="sp_model", device="cpu",
                                              generator=torch.Generator().manual_seed(1), **MV), 1)
    rng = np.random.RandomState(1)
    views = [rng.randn(1, 3, 32, 32).astype(np.float32) for _ in range(4)]
    return state, views


@pytest.fixture(scope="module")
def worlds():
    """The port's two worlds (2 and 4 gloo ranks on the CPU), started together in the background when the module's
    first test needs them; each returns every rank's results."""
    specs = {int8: {"kwargs": dict(name="infer_test", **SMALL), "state": _port_state(), "int8": int8}
             for int8 in (False, True)}
    cases = {2: ([], []), 4: ([], [])}
    for name, world, (data, model_axis), _, int8 in INFER:
        img1, img2 = _images(len(name))
        cases[world][0].append(dict(name=name, spec=specs[int8], data=data, model_axis=model_axis,
                                    use_tp=model_axis > 1, img1=img1, img2=img2))
    q, k, v = _ring_inputs()
    for name, world, dtype in RING:
        cases[world][1].append(dict(name=name, q=q, k=k, v=v, dtype=dtype, data=world, model=1))
    mv_state, views = _mv_inputs()
    mv = ({"kwargs": dict(name="sp_model", **MV), "state": mv_state}, views)
    pool = ThreadPoolExecutor(2)
    futures = {
        2: pool.submit(comm.spawn, torch_ranks.serving_world, 2, *cases[2], mv, 2, (_mlp_input(), RP_MODES),
                       device="cpu", threads=1, timeout=900),
        4: pool.submit(comm.spawn, torch_ranks.serving_world, 4, *cases[4], None, None, device="cpu", threads=1,
                       timeout=900),
    }
    yield types.SimpleNamespace(get=lambda world: futures[world].result())
    pool.shutdown()


@pytest.fixture(autouse=True)
def _keep_force_xla():
    """JAX's make_infer_fn sets uniception_tpu.nn.quant._FORCE_XLA and never resets it (the order flip of
    test_int8_linear_routes_wide_k_through_pallas, ROADMAP queue 3): restore it after each test."""
    saved = jax_quant._FORCE_XLA
    yield
    jax_quant._FORCE_XLA = saved


# --- leaf_tp_spec ---------------------------------------------------------------------------------------------


def _port_dust3r(int8: bool):
    model = DUSt3R(name="infer_test", device="cpu", **SMALL)
    load_state_dict_numpy(model, _port_state())
    if int8:
        quantize_linears(model.encoder, min_params=1)
        quantize_linears(model.info_sharing, min_params=1)
    return model


@pytest.mark.parametrize("model_axis", [2, 3])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_layers", "int8"])
def test_leaf_tp_spec_matches_jax_leaf_by_leaf(int8, model_axis):
    """Every state tensor of DUSt3R (float and int8-quantized) gets JAX's PartitionSpec for the same leaf, in the
    tensor's own layout: transposed for a torch weight of JAX's 2-D kernel, as is for everything else (w_q is
    exported (in, out) as JAX keeps it). At 3 ranks the divisibility fallback replicates what 3 does not divide."""
    jmodel = _jax_dust3r(int8)
    jmesh = jax_make_mesh(data=2, model=model_axis, devices=jax.devices()[: 2 * model_axis])
    jflat = {keypath_str(kp).removesuffix(".value"): leaf
             for kp, leaf in jax.tree_util.tree_flatten_with_path(nnx.state(jmodel))[0]}
    fake = types.SimpleNamespace(shape={"model": model_axis})
    sharded, compared = 0, 0
    for key, t in _port_dust3r(int8).state_dict().items():
        stem = key.rsplit(".", 1)[0]
        jpath = next((p for p in (key, f"{stem}.kernel", f"{stem}.scale") if p in jflat), None)
        if jpath is None:  # the port's non-persistent tables have no JAX leaf
            continue
        jspec = tuple(jax_leaf_tp_spec(jpath, jflat[jpath], jmesh))
        want = tuple(reversed(jspec)) if jpath.endswith(".kernel") and t.ndim == 2 else jspec
        got = tmesh.leaf_tp_spec(key, t, fake)
        assert tuple(got) == want, (key, jpath, got, jspec)
        compared += 1
        sharded += any(a is not None for a in got)
    assert compared > 40 and sharded > (12 if model_axis == 2 else 0)


# --- sharded inference ------------------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_infer(jax_mesh, int8):
    "JAX's sharded inference at ``jax_mesh`` on the inputs of every case (one compile per mesh and precision)."
    model = _jax_dust3r(int8)
    data, model_axis = jax_mesh
    ctx, state = jax_make_infer_fn(model, data=data, model_axis=model_axis, use_tp=model_axis > 1)
    out = {}
    for name, *_ in INFER:
        img1, img2 = _images(len(name))
        with ctx.mesh:
            s1, s2 = ctx.shard((jnp.asarray(img1), jnp.asarray(img2)))
            r1, r2 = ctx.infer(state, s1, s2)
        out[name] = {"pts3d": np.asarray(r1["pts3d"]), "conf": np.asarray(r1["conf"]),
                     "pts3d_in_other_view": np.asarray(r2["pts3d_in_other_view"]), "conf2": np.asarray(r2["conf"])}
    return out


@pytest.mark.parametrize("name,world,port_mesh,jax_mesh,int8", INFER, ids=[c[0] for c in INFER])
def test_make_infer_fn_matches_jax(worlds, name, world, port_mesh, jax_mesh, int8):
    "The port's (data, model) inference on gloo ranks against JAX's on the 8 CPU devices, every rank the whole batch."
    ref = _jax_infer(jax_mesh, int8)[name]
    ranks = worlds.get(world)
    for r in ranks:
        got = r["infer"]["cases"][name]
        for key, want in ref.items():
            a, b = got[key], np.asarray(want)
            assert a.shape == b.shape and np.isfinite(a).all(), key
            if int8:  # tests/parallel/test_inference.py's bar
                rel = np.abs(a - b) / np.abs(b).max()
                assert rel.max() < 2e-2 and np.median(rel) < 1e-3, (key, rel.max(), np.median(rel))
            else:
                assert np.abs(a - b).max() <= TOL, (key, np.abs(a - b).max())
        np.testing.assert_array_equal(got["pts3d"], ranks[0]["infer"]["cases"][name]["pts3d"])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_tensor_parallel_ranks_hold_half_of_each_sharded_weight(worlds, int8):
    """Under 2-way TP every rank holds half of each column-parallel layer's outputs (q, k and v by heads) and half of
    each row-parallel layer's inputs; each forward all-reduces once per row-parallel layer (twice in int8: the row
    abs-max, then the partial sums)."""
    name = "tp_int8" if int8 else "tp"
    C, hidden, blocks = SMALL["enc_embed_dim"], 4 * SMALL["enc_embed_dim"], SMALL["enc_depth"]
    want = {"enc.attn.qkv": (3 * C // 2, C), "enc.attn.proj": (C, C // 2), "enc.mlp.fc1": (hidden // 2, C),
            "enc.mlp.fc2": (C, hidden // 2), "dec.cross_attn.projq": (C // 2, C),
            "dec.cross_attn.proj": (C, C // 2), "enc.heads": SMALL["enc_num_heads"] // 2}
    row_parallel = 2 * blocks + 2 * SMALL["info_sharing_depth"] * 3  # encoder: proj, fc2; each view's decoder: 3
    for r in worlds.get(2):
        got = r["infer"]["cases"][name]
        assert got["shapes"] == want
        assert got["all_reduces"] == row_parallel * (2 if int8 else 1)
    for r in worlds.get(4):
        assert r["infer"]["cases"][f"dp_{name}"]["shapes"] == want


@pytest.mark.parametrize("mode", RP_MODES)
def test_row_parallel_layer_reduces_exact_int32_sums(worlds, mode):
    """An MLP under 2-way TP against itself unsharded: fc2 becomes a RowParallel holding half of its inputs. In every
    int8 mode the ranks quantize with the whole row's statistics and sum exact int32 partial products before one
    dequantization, so the output is the unsharded one bit for bit; in fp32 the reordered sum stays within the parity
    bar."""
    for r in worlds.get(2):
        ref, got, fc2, wrapped = r["rp"][mode]
        assert wrapped and fc2 == (128, 64)
        if mode == "float":
            assert np.abs(got - ref).max() <= TOL
        else:
            np.testing.assert_array_equal(got, ref)


def test_comm_device_follows_a_directly_initialised_backend(tmp_path):
    "A process group made with init_process_group alone (as under torchrun) gives the backend's device: gloo's CPU."
    assert comm._DEVICE is None
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        assert comm.device() == torch.device("cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_spawn_runs_on_the_card_unless_asked_for_the_cpu():
    "Without a device a world's ranks go to the card, and without one spawn raises before starting any rank."
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.spawn(torch_ranks.serving_world, 2, [], [])


# --- ring attention and sequence parallelism --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_ring():
    q, k, v = (jnp.asarray(a) for a in _ring_inputs())
    with jax_make_mesh(data=8, model=1) as jmesh:
        ref = np.asarray(jax_ring_attention_sharded(q, k, v, jmesh, axis_name="data"))
    return ref, np.asarray(jax_sdpa(q, k, v, impl="naive"))


@pytest.mark.parametrize("name,world,dtype", RING, ids=[c[0] for c in RING])
def test_ring_attention_sharded_matches_jax(worlds, name, world, dtype):
    """256 tokens over 2 and 4 gloo ranks against JAX's ring over 8 CPU devices and the plain softmax (fp32 at the
    parity bar; the bf16 ring, from the same inputs rounded to bf16, at K1's bf16 bar)."""
    ref, naive = _jax_ring()
    tol = TOL if dtype == "float32" else BF16_TOL
    for r in worlds.get(world):
        got = r["ring"]["cases"][name]
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= tol and np.abs(got - naive).max() <= tol


def test_multiview_sequence_parallel_matches_jax(worlds):
    "MultiViewPointmapModel(sequence_parallel=...) over 2 ranks against JAX's over the 8 CPU devices."
    state, views = _mv_inputs()
    with jax_make_mesh(data=8, model=1) as jmesh:
        jsp = jax_module(lambda: JaxMultiView(name="sp_model", rngs=nnx.Rngs(0), sequence_parallel=(jmesh, "data"),
                                              **MV))
        load_torch_state_dict(_jax_tables(jsp), state, verbose=False)
        ref = nnx.jit(lambda m, v: m(v))(jsp, [jnp.asarray(v) for v in views])
    for r in worlds.get(2):
        got = r["mv"]
        assert got["exchanges"] > 0  # the info sharing's attention went round the ring
        for (pts, conf), want in zip(got["views"], ref):
            assert np.abs(pts - np.asarray(want["pts3d"])).max() <= TOL
            assert np.abs(conf - np.asarray(want["conf"])).max() <= TOL


# --- the world ------------------------------------------------------------------------------------------------


def test_preemption_guard_ors_the_stop_flags_over_ranks(worlds):
    "Only the last rank is signalled; with sync_every=2 every rank says False, then True from the sync on."
    for r in worlds.get(2):
        assert r["preempt"] == [False, True, True, True]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_processes_import_no_jax_and_name_their_transport(worlds, world):
    for r in worlds.get(world):
        assert r["infer"]["jax_free"] and r["ring"]["jax_free"]
        assert r["infer"]["transport"] == "gloo, tensors moved as they lie on cpu"
