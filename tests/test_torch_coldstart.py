"""
The port's native serving checkpoints and cold start
(uniception_tpu_torch/utils/coldstart.py, convert_checkpoints --serving)
against the JAX package's utils/coldstart.py on the CPU: files the JAX
package writes (.nsv and .npz, loop and scan layouts, fp32 and bf16, an
int8-quantized trunk with its quant metadata) load into the port bit for bit;
files the port writes read back in the JAX package to the JAX model's own
state; a model built on the meta device and materialized has no meta tensor
left and the eager model's forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.factory.flow import UFMFlow as JaxUFMFlow
from uniception_tpu.nn.quant import quantize_trunk as jax_quantize_trunk
from uniception_tpu.utils import coldstart as jcs
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch import convert_checkpoints, serve
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.factory.flow import UFMFlow
from uniception_tpu_torch.nn.quant import Int8Linear, quantize_trunk
from uniception_tpu_torch.utils import coldstart
from tests.test_torch_quant import jax_module

SMALL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=48, info_sharing_depth=2,
             info_sharing_num_heads=4)
WIDE = dict(enc_embed_dim=256, enc_depth=2, enc_num_heads=4, info_sharing_dim=256, info_sharing_depth=2,
            info_sharing_num_heads=4)  # every trunk linear past quantize_trunk's 2^16-element threshold
DIMS = ["--enc-dim", "64", "--enc-depth", "2", "--enc-heads", "4", "--dec-dim", "48", "--dec-depth", "2",
        "--dec-heads", "4", "--img-size", "32"]


@functools.lru_cache(maxsize=None)
def _port(head, model="dust3r", dims=tuple(SMALL.items())):
    "A seeded port model (fp32, biases non-zero) and its constructor's keywords."
    cls = DUSt3R if model == "dust3r" else UFMFlow
    kw = dict(name="m", img_size=(32, 32), patch_embed_cls="ManyAR_PatchEmbed", pred_head_type=head, **dict(dims))
    if model == "flow":
        del kw["patch_embed_cls"]
    m = cls(generator=torch.Generator().manual_seed(7), **kw)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    return m.eval(), kw


def _jax(model, kw, scan):
    "The JAX counterpart of a port model, in the loop or the scan layout, with its weights."
    jcls = JaxDUSt3R if isinstance(model, DUSt3R) else JaxUFMFlow
    jmod = jax_module(lambda: jcls(scan_blocks=scan, rngs=nnx.Rngs(0), **kw))
    load_torch_state_dict(jmod, {k: v.numpy() for k, v in model.state_dict().items()}, verbose=False)
    return jmod


@functools.lru_cache(maxsize=None)
def _jax_small(head, scan):
    "The JAX twin of ``_port(head)``, built once per layout (the tests that quantize build their own)."
    model, kw = _port(head)
    return _jax(model, kw, scan)


def _equal_to(model, state, dtype=None):
    "Every tensor of ``model`` equals ``state``'s, cast to ``dtype`` (the file's) and then to the module's."
    own = model.state_dict()
    assert sorted(own) == sorted(state)
    for k, v in own.items():
        want = torch.as_tensor(np.asarray(state[k])) if not isinstance(state[k], torch.Tensor) else state[k]
        want = want.to(dtype) if dtype is not None and want.is_floating_point() else want
        assert v.device.type == "cpu" and torch.equal(v, want.to(v.dtype)), k


# each container, layout and dtype twice, each pair of them once
@pytest.mark.parametrize("container,layout,dtype", [("nsv", "loop", "float32"), ("nsv", "scan", "bfloat16"),
                                                    ("npz", "loop", "bfloat16"), ("npz", "scan", "float32")])
def test_jax_native_state_loads_bit_for_bit(tmp_path, container, layout, dtype):
    model, kw = _port("dpt")
    path = str(tmp_path / f"m.{container}")
    jcs.save_native_state(path, _jax_small("dpt", layout == "scan"), note="x",
                          dtype=None if dtype == "float32" else jnp.bfloat16)
    assert coldstart.is_native_state(path)
    arrays, meta = coldstart.load_native_state(path)
    assert meta == {"note": "x"}
    if layout == "scan":
        assert "encoder.enc_blocks.attn.qkv.kernel.value" in arrays
    built = coldstart.abstract_construct(lambda: DUSt3R(**kw))
    assert all(t.is_meta for t in built.state_dict().values())
    coldstart.materialize(built, arrays=arrays, device="cpu")
    _equal_to(built, model.state_dict(), getattr(torch, dtype))


@pytest.mark.parametrize("width", [128, 256])
def test_jax_int8_native_state_serves_int8(tmp_path, width):
    """An offline-quantized JAX serving file (scan layout, quant metadata) builds the file's Int8Linear tree in the
    port. At width 128 the JAX scan layout quantizes qkv (its size counts the depth) and the loop layout would not:
    the file decides. At 256 every trunk linear passes the threshold, so the port's own quantize_trunk agrees."""
    dims = dict(enc_embed_dim=width, enc_depth=2, enc_num_heads=4, info_sharing_dim=width, info_sharing_depth=2,
                info_sharing_num_heads=4)
    model, kw = _port("linear", dims=tuple(dims.items()))
    jmod = _jax(model, kw, scan=True)
    n = jax_quantize_trunk(jmod, "all", asym="*.fc2")
    path = str(tmp_path / "q.nsv")
    jcs.save_native_state(path, jmod, quant="int8-w8a8-dynamic", quant_layers=n, quant_policy="all",
                          quant_asym="*.fc2")
    args = (32, 2, width, 4, 2, width, 4)
    loaded = serve.build_model(*args, device="cpu", dtype=torch.float32, checkpoint=path)
    assert loaded.quant_spec == ("all", "*.fc2")
    fc2 = loaded.encoder.enc_blocks[0].mlp.fc2
    assert fc2.w_colsum is not None and fc2.w_q.is_contiguous()  # the kernel's (out, in) layout
    assert isinstance(loaded.encoder.enc_blocks[0].attn.qkv, Int8Linear)  # 2 x 128 x 384 in the scan layout
    arrays, _ = coldstart.load_native_state(path)
    for k, v in loaded.state_dict().items():  # every tensor is the file's, in the port's layout
        path_, kind, scan, i = coldstart.native_key_table(loaded)[k]
        want = arrays[scan][i] if scan in arrays else arrays[path_]
        assert torch.equal(v, coldstart._from_native(want, kind).to(v.dtype)), k
    if width == 256:
        mine = serve.build_model(*args, device="cpu", dtype=torch.float32)
        mine.load_state_dict(model.state_dict())
        quantize_trunk(mine, "all", asym="*.fc2")
        _equal_to(loaded, mine.state_dict())


def _jax_reads(path, jax_ctor):
    "JAX's cold start of a native file: abstract construction, load_native_state, materialize."
    arrays, meta = jcs.load_native_state(path)
    return jcs.materialize(jcs.abstract_construct(jax_ctor), arrays=arrays), meta


@pytest.mark.parametrize("head,layout,container", [("linear", "loop", "nsv"), ("linear", "scan", "npz"),
                                                   ("dpt", "scan", "nsv")])
def test_port_native_state_reads_back_in_jax(tmp_path, head, layout, container):
    model, kw = _port(head)
    path = str(tmp_path / f"m.{container}")
    coldstart.save_native_state(path, model, dtype=torch.bfloat16, layout=layout, step=4)
    jmod, meta = _jax_reads(path, lambda: JaxDUSt3R(scan_blocks=layout == "scan", rngs=nnx.Rngs(0), **kw))
    assert meta == {"step": 4}
    state = state_dict_from_module(jmod)
    own = model.state_dict()
    assert sorted(state) == sorted(own)
    for k, v in own.items():
        np.testing.assert_array_equal(np.asarray(state[k], np.float32), v.bfloat16().float().numpy(), err_msg=k)


@pytest.mark.parametrize("int8", [False, True])
def test_converter_output_reads_back_in_jax(tmp_path, int8):
    "convert_checkpoints --serving (scan layout, bf16, or int8 with its metadata) as the JAX serving example reads it."
    model, kw = _port("linear", dims=tuple(WIDE.items()))
    src, out = str(tmp_path / "m.pth"), str(tmp_path / "m.nsv")
    torch.save({"model": model.state_dict()}, src)
    dims = ["--enc-dim", "256", "--enc-depth", "2", "--enc-heads", "4", "--dec-dim", "256", "--dec-depth", "2",
            "--dec-heads", "4", "--img-size", "32"]
    convert_checkpoints.main([src, out, "--serving", *dims] + (["--int8", "--int8-asym", "*.fc2"] if int8 else []))

    def ctor():
        m = JaxDUSt3R(scan_blocks=True, rngs=nnx.Rngs(0), dtype=jnp.bfloat16, **kw)
        if int8:
            jax_quantize_trunk(m, "all", asym="*.fc2")
        return m

    jmod, meta = _jax_reads(out, ctor)
    state = state_dict_from_module(jmod)
    # the port's serving model quantized as serving does (bf16 parameters, then the trunk)
    mine = serve.build_model(32, 2, 256, 4, 2, 256, 4, device="cpu", dtype=torch.bfloat16)
    mine.load_state_dict(model.state_dict())
    if int8:
        mine.to(torch.bfloat16)
        n = quantize_trunk(mine, "all", asym="*.fc2")
        assert meta["quant"] == "int8-w8a8-dynamic" and meta["quant_layers"] == n
        assert (meta["quant_policy"], meta["quant_asym"]) == ("all", "*.fc2")
    own = mine.state_dict()
    assert sorted(state) == sorted(own)
    for k, v in own.items():
        want = v.bfloat16().float() if v.is_floating_point() and not int8 else v.float()
        np.testing.assert_array_equal(np.asarray(state[k]).astype(np.float32), want.numpy(), err_msg=k)


def test_meta_construction_materializes_everything(tmp_path):
    model, kw = _port("dpt")
    path = str(tmp_path / "m.nsv")
    coldstart.save_native_state(path, model)
    built = coldstart.abstract_construct(lambda: DUSt3R(**kw))
    coldstart.materialize(built, arrays=coldstart.load_native_state(path)[0], device="cpu")
    assert not any(t.is_meta for t in list(built.parameters()) + list(built.buffers()))
    img = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        got, want = built.eval().forward_pair(img, img), model.forward_pair(img, img)
    for res, ref in zip(got, want):
        for key in ref:
            assert torch.equal(res[key], ref[key]), key


def test_materialize_is_strict(tmp_path):
    model, kw = _port("linear")
    arrays = {p: t for p, t in coldstart._native_entries(model, None, "loop")}
    extra = dict(arrays, **{"encoder.bogus.kernel.value": torch.zeros(2)})
    with pytest.raises(KeyError, match="unexpected"):
        coldstart.materialize(coldstart.abstract_construct(lambda: DUSt3R(**kw)), arrays=extra, device="cpu")
    missing = {p: t for p, t in arrays.items() if "head1" not in p}
    with pytest.raises(KeyError, match="missing"):
        coldstart.materialize(coldstart.abstract_construct(lambda: DUSt3R(**kw)), arrays=missing, device="cpu")
    bad = dict(arrays, **{"encoder.enc_norm.scale.value": torch.zeros(3)})
    with pytest.raises(ValueError, match="Shape"):
        coldstart.materialize(coldstart.abstract_construct(lambda: DUSt3R(**kw)), arrays=bad, device="cpu")
    with pytest.raises(ValueError):
        coldstart.materialize(DUSt3R(**kw), device="cpu")
    assert not coldstart.is_native_state(str(tmp_path / "absent.nsv"))
    # the dropout RNG counters a JAX file carries are read past
    with_rngs = dict(arrays, **{"encoder.enc_blocks.0.attn.proj_drop.rngs.count.value": torch.zeros((), dtype=torch.int32)})
    coldstart.materialize(coldstart.abstract_construct(lambda: DUSt3R(**kw)), arrays=with_rngs, device="cpu")
    assert jax.devices()[0].platform == "cpu"
