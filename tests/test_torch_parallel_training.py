"""
The port's training across ranks (uniception_tpu_torch/parallel/training.py ``make_train_step`` with ``data``,
``model_axis``, ``use_tp``, ``zero1`` and ``fsdp``; parallel/mesh.py ``leaf_data_spec``, ``zero1_shard_state`` and
``fsdp_shard_state``; the sharded save and restore) against the JAX package's, on the CPU.

The JAX side runs ``make_train_step(data=8)`` on the 8 virtual CPU devices of tests/conftest.py at its own tests'
``SMALL`` widths (tests/parallel/test_training.py:19-22); the port's side runs in one world of 4 gloo rank
processes, started once for the module in the background (tests/torch_ranks.py ``training_world``, which imports
no JAX), on the same batches from the same weights (the port's seeded model, carried into a JAX module built from
its abstract shapes). Every port mode is held against JAX's data-parallel step, the reference JAX's own sharded
steps are held to. Bars: the losses at JAX's own sharded-step bar (rtol 1e-4, atol 1e-5,
tests/parallel/test_training.py:111) and the parameters after AdamW at rtol 1e-4, atol 1e-5 (at lr 1e-4, where
Adam's amplification of the rounding noise of the near-zero gradients stays under it); ZeRO-1 and FSDP bit for bit
the port's plain data parallelism (their gradients are reduced by the same bucketed collective, and AdamW is
elementwise).
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
from tests.test_torch_quant import jax_module
from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.nn import lora as jax_lora
from uniception_tpu.parallel import training as jax_training
from uniception_tpu.parallel.mesh import fsdp_shard_state as jax_fsdp_shard_state
from uniception_tpu.parallel.mesh import make_mesh as jax_make_mesh
from uniception_tpu.parallel.mesh import shard_batch as jax_shard_batch
from uniception_tpu.parallel.mesh import tp_shard_state as jax_tp_shard_state
from uniception_tpu.utils.pytree import keypath_str
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.nn.lora import apply_lora
from uniception_tpu_torch.parallel import comm
from uniception_tpu_torch.parallel import mesh as tmesh

SMALL = dict(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=64,
             info_sharing_depth=2, info_sharing_num_heads=4)
WORLD = 4
LR = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5  # tests/parallel/test_training.py:111
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
DP = dict(learning_rate=LR)
TP = dict(learning_rate=LR, data=2, model_axis=2, use_tp=True)
ACCUM_CLIP = dict(grad_accum=2, clip_grad_norm=1.0, metrics=True)
# name: (port options, batches, the JAX reference: options of its make_train_step(data=8))
CASES = {
    "dp": (dict(DP, data=WORLD), [0, 1, 2], "plain"),
    "zero1": (dict(DP, zero1=True), [0, 1, 2], "plain"),
    "fsdp": (dict(DP, fsdp=True), [0, 1, 2], "plain"),
    "dp_tp": (TP, [0, 1, 2], "plain"),
    "fsdp_tp": (dict(TP, fsdp=True), [0, 1, 2], "plain"),
    "fsdp_accum_clip": (dict(DP, fsdp=True, **ACCUM_CLIP), [0, 1, 2, 3], "accum_clip"),
    "tp_accum_clip": (dict(TP, **ACCUM_CLIP), [0, 1, 2, 3], "accum_clip"),
    "skip_nonfinite": (dict(DP, fsdp=True, skip_nonfinite=True), [4], None),
}
# one compile each: JAX's make_train_step on the 8 CPU devices takes about 20 s to compile
JAX_RUNS = {"plain": ({}, [0, 1, 2]), "accum_clip": (ACCUM_CLIP, [0, 1, 2, 3])}


def _batches():
    "Batches 0-3 of 8 pairs; batch 4 is batch 0 with the last rank's two pairs NaN."
    out = []
    for seed in range(4):
        rng = np.random.RandomState(seed)
        out.append((rng.randn(8, 3, 32, 32).astype(np.float32), rng.randn(8, 3, 32, 32).astype(np.float32),
                    rng.randn(8, 32, 32, 3).astype(np.float32), rng.randn(8, 32, 32, 3).astype(np.float32)))
    bad = out[0][0].copy()
    bad[6:] = np.nan
    out.append((bad,) + out[0][1:])
    return out


@functools.lru_cache(maxsize=None)
def _port_state():
    model = DUSt3R(name="train_test", device="cpu", generator=torch.Generator().manual_seed(0), **SMALL)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_model():
    model = jax_module(lambda: JaxDUSt3R(name="train_test", rngs=nnx.Rngs(0), **SMALL))
    load_torch_state_dict(model, _port_state(), verbose=False)
    return model


@functools.lru_cache(maxsize=None)
def _jax_run(which):
    "JAX's make_train_step(data=8) from the port's weights: (losses, grad norms, parameters in the port's layout)."
    options, idx = JAX_RUNS[which]
    batches = _batches()
    ctx, params, opt_state = jax_training.make_train_step(_jax_model(), learning_rate=LR, data=8, **options)
    losses, norms = [], []
    with ctx.mesh:
        for i in idx:
            out = ctx.step(params, opt_state, *jax_shard_batch(tuple(map(jnp.asarray, batches[i])), ctx.mesh))
            loss, params, opt_state = (out[0], out[2], out[3]) if options.get("metrics") else out
            losses.append(float(loss))
            if options.get("metrics"):
                norms.append(float(out[1]["grad_norm"]))
    return losses, norms, state_dict_from_module(nnx.merge(ctx.graphdef, params, ctx.rest_state))


def _flow_inputs():
    "A flow batch of 8 rows whose valid counts differ from rank to rank (rank r's rows keep about (r + 1) / 5)."
    rng = np.random.RandomState(7)
    flow, target = (rng.randn(8, 8, 8, 2).astype(np.float32) for _ in range(2))
    conf = 1.0 + rng.rand(8, 8, 8, 1).astype(np.float32)
    valid = rng.rand(8, 8, 8) < np.repeat(np.arange(1, WORLD + 1) / (WORLD + 1), 8 // WORLD)[:, None, None]
    target[~valid] = np.nan
    return flow, conf, target, valid


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    "The port's world of 4 gloo ranks on the CPU, started in the background when the first test needs it."
    spec = {"kwargs": dict(name="train_test", **SMALL), "state": _port_state()}
    cases = {name: {"options": opts, "batches": idx, "moments": name in ("dp", "zero1", "fsdp")}
             for name, (opts, idx, _) in CASES.items()}
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    pool = ThreadPoolExecutor(1)
    future = pool.submit(comm.spawn, torch_ranks.training_world, WORLD, spec, cases, _batches(),
                         dict(TP, fsdp=True), _flow_inputs(), ckpt, device="cpu", threads=1, timeout=900)
    yield types.SimpleNamespace(get=future.result)
    pool.shutdown()


# --- the data-axis rule ---------------------------------------------------------------------------------------


def _jax_to_port_spec(jspec, key, ndim):
    "JAX's spec of a leaf in the port tensor's dims: a 2-D kernel transposed, a conv kernel (kh, kw, in, out) moved."
    jspec = tuple(jspec) + (None,) * (ndim - len(tuple(jspec)))
    if key.endswith("weight") and ndim == 2:
        return jspec[::-1]
    if key.endswith("weight") and ndim == 4:
        return (jspec[3], jspec[2], jspec[0], jspec[1])
    return jspec


@pytest.mark.parametrize("data,model_axis,lora", [(2, 1, False), (8, 1, False), (4, 2, False), (4, 2, True)],
                         ids=["data2", "data8", "data4_tp2", "data4_tp2_lora"])
def test_leaf_data_spec_matches_jax_leaf_by_leaf(data, model_axis, lora):
    """Every parameter of DUSt3R gets, from the port's leaf_data_spec (after its TP spec), JAX's
    fsdp_shard_state / zero1_shard_state sharding of the same leaf (``_data_shard_largest_axis`` over the TP
    layout), in the tensor's own dims: "data" on the largest free axis the data size divides, "model" kept. With
    LoRA on every trunk linear (``train.py --lora``), the wrapped layers (``...qkv.base.weight``) and their adapters
    get JAX's TP spec, replicated over "model": its rules match ``qkv.kernel``, not ``qkv.base.kernel``."""
    jmesh = jax_make_mesh(data=data, model=model_axis, devices=jax.devices()[: data * model_axis])
    jmodel, port_state = _jax_model(), _port_state()
    if lora:
        tmodel = DUSt3R(name="train_test", device="cpu", **SMALL)
        for part in ("encoder", "info_sharing"):
            jax_lora.apply_lora(getattr(jmodel, part), rank=4, rngs=nnx.Rngs(1), min_params=1)
            apply_lora(getattr(tmodel, part), 4, min_params=1)
        port_state = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    _, params, _ = nnx.split(jmodel, nnx.Param, ...)
    with jmesh:
        state = jax_tp_shard_state(params, jmesh) if model_axis > 1 else params
        state = jax_fsdp_shard_state(state, jmesh)
    jspecs = {keypath_str(kp).removesuffix(".value"): leaf.sharding.spec
              for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
    fake = types.SimpleNamespace(shape={"data": data, "model": model_axis})
    compared = on_data = wrapped = 0
    for key, a in port_state.items():
        stem = key.rsplit(".", 1)[0]
        jpath = next((p for p in (key, f"{stem}.kernel", f"{stem}.scale") if p in jspecs), None)
        if jpath is None:
            continue
        t = torch.from_numpy(a)
        tp = tmesh.leaf_tp_spec(key, t, fake) if model_axis > 1 else None
        got = tuple(tmesh.leaf_data_spec(key, t, fake, tp))
        got = got + (None,) * (t.ndim - len(got))
        assert got == _jax_to_port_spec(jspecs[jpath], key, t.ndim), (key, got, jspecs[jpath])
        if lora and (".base." in key or key.endswith(("lora_a", "lora_b"))):
            assert "model" not in got, key
            wrapped += 1
        compared += 1
        on_data += "data" in got
    assert compared == len(jspecs) and on_data > compared // 2
    assert wrapped == (4 * 40 if lora else 0)  # base weight, base bias and both adapters of the 40 trunk linears


# --- the train steps ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2] is not None])
def test_sharded_steps_match_jax_data_parallel(world, name):
    """Each mode's losses on every rank (and grad norms with ``metrics``), and the whole parameters after the steps,
    against JAX's make_train_step(data=8) with the same options on the same batches: DP over 4 ranks, ZeRO-1, FSDP,
    DP x TP (2 x 2) and FSDP x TP; then FSDP and DP x TP with grad_accum=2 (two updates through the accumulator),
    clipping and the grad-norm metric, the norm over FSDP's blocks and over TP's shards (each part summed once)."""
    losses, norms, want = _jax_run(CASES[name][2])
    ranks = world.get()
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(got["norms"], norms, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert got["count"] == (2 if "accum" in name else 3)
    params = ranks[0][name]["params"]
    assert set(params) == {k for k in want if k in params} and len(params) > 100
    for k, a in params.items():
        np.testing.assert_allclose(a, want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["zero1", "fsdp"])
def test_zero1_and_fsdp_are_data_parallel_bit_for_bit(world, name):
    "Losses, parameters and AdamW's moments of ZeRO-1 and FSDP equal the port's plain DP run bit for bit."
    ranks = world.get()
    ref, got = ranks[0]["dp"], ranks[0][name]
    assert got["losses"] == ref["losses"]
    for k in ref["params"]:
        np.testing.assert_array_equal(got["params"][k], ref["params"][k], err_msg=k)
    # rank 0's moments: whole under DP, rank 0's block under ZeRO-1 and FSDP (the first block of the split dim)
    for k, (mu, nu) in got["moments"].items():
        rmu, rnu = ref["moments"][k]
        sl = tuple(slice(0, n) for n in mu.shape)
        np.testing.assert_array_equal(mu, rmu[sl], err_msg=k)
        np.testing.assert_array_equal(nu, rnu[sl], err_msg=k)


@pytest.mark.parametrize("name,param_share,moment_share", [("dp", 1.0, 1.0), ("zero1", 1.0, 0.27),
                                                          ("fsdp", 0.27, 0.27), ("fsdp_tp", 0.4, 0.4)])
def test_ranks_hold_only_their_blocks(world, name, param_share, moment_share):
    """Bytes a rank holds against plain DP's: ZeRO-1 a quarter of the moments (data 4), FSDP a quarter of the
    parameters and moments (FSDP x TP at 2 x 2: a quarter of what TP splits, half of what it replicates)."""
    ranks = world.get()
    full_p, full_m = ranks[0]["dp"]["bytes"]
    for r in ranks:
        p, m = r[name]["bytes"]
        assert p <= param_share * full_p and m <= moment_share * full_m, (name, p / full_p, m / full_m)


def test_skip_nonfinite_with_one_ranks_rows_nan_updates_no_rank(world):
    "The last rank's rows are NaN: the finiteness is reduced over the world, so every rank skips the update."
    ref = _port_state()
    for r in world.get():
        got = r["skip_nonfinite"]
        assert got["count"] == 0 and got["notfinite"] == 1 and not np.isfinite(got["losses"][0])
    for k, a in world.get()[0]["skip_nonfinite"]["params"].items():
        np.testing.assert_array_equal(a, ref[k], err_msg=k)


def test_flow_loss_is_the_global_batch_loss_with_uneven_valid_counts(world):
    """Each rank's share of the flow loss (global_batch: divided by the valid count summed over the ranks) adds up
    to JAX's loss over the whole batch, and each rank's gradient is its rows of JAX's gradient, though the ranks'
    valid counts differ (a mean of per-rank means would not be)."""
    flow, conf, target, valid = _flow_inputs()

    def jax_loss(f, c):
        return jax_training.flow_confidence_loss({"flow": f, "flow_conf": c}, jnp.asarray(target),
                                                 valid=jnp.asarray(valid))

    ref, (gf, gc) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(flow), jnp.asarray(conf))
    ranks = world.get()
    assert len({r["flow"]["valid"] for r in ranks}) == WORLD
    rows = 8 // WORLD
    for i, r in enumerate(ranks):
        got = r["flow"]
        np.testing.assert_allclose(float(got["loss"]), float(ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["grads"][0], np.asarray(gf)[i * rows:(i + 1) * rows], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["grads"][1], np.asarray(gc)[i * rows:(i + 1) * rows], rtol=1e-5, atol=1e-7)


def test_sharded_save_restore_continue_is_bit_for_bit(world):
    """FSDP x TP (2 x 2): two steps, a save, a third step; a fresh context restoring the file takes the third step
    again and ends bit for bit where the uninterrupted run did. Rank 0 wrote the unsharded state: the keys and shapes
    a single-device train state of the model has."""
    ranks = world.get()
    got = ranks[0]["resume"]
    assert all(r["resume"]["count"] == 3 for r in ranks)
    for k, a in got["uninterrupted"].items():
        np.testing.assert_array_equal(got["resumed"][k], a, err_msg=k)
    shapes = {k: v.shape for k, v in _port_state().items()}
    for key, shape in got["shapes"].items():
        assert shape == shapes[key.split(".", 1)[1]], key
    assert {k.split(".", 1)[1] for k in got["shapes"] if k.startswith("params.")} == set(shapes)


def test_sharded_ema_is_saved_whole_and_restored_in_parts(world):
    """FSDP x TP (2 x 2): an EMA of the rank's parameter parts, saved with its train context, is one file of the
    unsharded parameters (the uninterrupted run's, bit for bit, under the single-device model's names), and restoring
    it gives every rank its parts back."""
    ranks = world.get()
    assert all(r["resume"]["ema"]["parts_back"] for r in ranks)
    got, want = ranks[0]["resume"]["ema"]["file"], ranks[0]["resume"]["resumed"]
    assert sorted(got) == sorted(f"params.{k}" for k in _port_state())
    for k, a in want.items():
        np.testing.assert_array_equal(got[f"params.{k}"], a, err_msg=k)


def test_a_loss_without_the_global_batch_share_raises(world):
    """A caller's loss that is a mean over the rank's rows (summed over "data" it would count 4 times) makes the
    step raise, naming the requirement, before any parameter changes."""
    for r in world.get():
        got = r["custom_loss"]
        assert got["error"] is not None and "share of the global batch" in got["error"] and got["unchanged"]


def test_rank_processes_import_no_jax(world):
    assert all(r["jax_free"] for r in world.get())
