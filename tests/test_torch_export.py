"""
The port's serving artifacts (uniception_tpu_torch/utils/export.py) on the CPU:
an artifact bound to a native checkpoint reproduces the live port module bit
for bit (DUSt3R linear, DUSt3R DPT landscape_only with a portrait row and its
K7 layouts, an int8 trunk, UFMFlow), also in a fresh process that imports no
model code; it holds no weight tensor; its graph holds one ``uniception::``
node per kernel call the eager path makes; it agrees with the JAX
package's artifact bound to the same ``.nsv`` written by the JAX package; and
its header records the process's precision flags, under other flags a CUDA
bind raises. The artifacts are built once per case for the module.
"""

import collections
import io
import os
import subprocess
import sys
import textwrap
import zipfile
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from uniception_tpu.utils import coldstart as jcs
from uniception_tpu.utils import export as jexport
from uniception_tpu_torch import serve
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn import dpt_parts
from uniception_tpu_torch.utils import coldstart
from uniception_tpu_torch.utils.export import _MAGIC, load_serving_artifact, save_serving_artifact
from uniception_tpu_torch.utils.framing import read_framed_header
from tests.test_torch_coldstart import _jax, _port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2 + 2 blocks at 256 wide (4 heads of 64): every trunk linear is past quantize_trunk's 2^16-element floor, and the
# weights are large enough beside the traced graph that the 1% bar on the file's size means something
DIMS = (32, 2, 256, 4, 2, 256, 4)
CASES = ("linear", "dpt_landscape", "int8", "flow")


class OpCalls(TorchDispatchMode):
    "Counts the ``uniception::`` custom-op calls made under it, by op."

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "uniception":
            self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _graph_ops(program):
    return collections.Counter(str(n.target) for n in program.graph.nodes if str(n.target).startswith("uniception."))


def _model(case):
    kw = dict(device="cpu", dtype=torch.float32, seed=3)
    if case == "linear":
        return serve.build_model(*DIMS, **kw)
    if case == "dpt_landscape":  # bf16 heads whose 3x3 convs take K7's route (the op's plain version on the CPU)
        return serve.build_model(*DIMS, head="dpt", head_dtype=torch.bfloat16, landscape_only=True, **kw)
    if case == "int8":
        return serve.build_model(*DIMS, int8=True, **kw)
    return serve.build_model(*DIMS, head="dpt", model="flow", **kw)


def _inputs(case):
    rng = np.random.RandomState(11)
    frames = [torch.from_numpy(rng.randint(0, 256, (2, 32, 32, 3), np.uint8)) for _ in range(2)]
    if case == "flow":
        return frames
    ts = torch.tensor([[32, 32], [32, 16]] if case == "dpt_landscape" else [[32, 32]] * 2, dtype=torch.int32)
    return [*frames, ts, ts.flip(0)]  # dpt_landscape: a portrait row in each view


class _Cuda:  # x as Conv2dTorch.takes_conv3x3 reads it, on a CUDA device
    def __init__(self, x):
        self.is_cuda, self.dtype, self.shape, self.dim = True, x.dtype, x.shape, x.dim


def _build(case, root):
    """The case's model, inputs, eager outputs and ``uniception::`` op calls, and its artifact and scan-layout .nsv
    under ``root``. K7's route is taken on the CPU: Conv2dTorch takes the conv op (its plain version here) as it does
    on a CUDA tensor, so the HWIO copies become the artifact's prepare program."""
    model, inputs = _model(case), _inputs(case)
    art_path, nsv_path = str(root / "m.ptexp"), str(root / "m.nsv")
    base = dpt_parts.Conv2dTorch.takes_conv3x3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dpt_parts.Conv2dTorch, "takes_conv3x3", lambda self, x: base(self, _Cuda(x)))
        config.set_conv3x3_impl("kernel")
        try:
            eager = OpCalls()
            with eager:
                ref = serve.make_serving_fn(model, "cpu")(*inputs)
            save_serving_artifact(art_path, model, serve.artifact_inputs(model, 2, (32, 32), "cpu"),
                                  method=serve.serving_method(model, "cpu"), case=case)
        finally:
            config.set_conv3x3_impl("torch")
    coldstart.save_native_state(nsv_path, model, layout="scan")
    return {"model": model, "inputs": inputs, "ref": ref, "calls": eager.calls, "art": art_path, "nsv": nsv_path}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    "``built(case)``: :func:`_build`'s results, made once per case for the module's tests."
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _build(case, tmp_path_factory.mktemp(case))
        return cache[case]

    return get


def _archive_tensors(path):
    "(name, bytes) of every stored tensor in the artifact's programs."
    with open(path, "rb") as f:
        header = read_framed_header(f, _MAGIC)
        blobs = [f.read(header["programs"][name]) for name in ("prepare", "forward")]
    out = []
    for blob in blobs:
        if blob:
            archive = zipfile.ZipFile(io.BytesIO(zlib.decompress(blob)))
            out += [(i.filename, i.file_size) for i in archive.infolist() if "/data/" in i.filename
                    and not i.filename.endswith(".json")]
    return out


@pytest.mark.parametrize("case", CASES)
def test_artifact_matches_live_module(built, case):
    b = built(case)
    art = load_serving_artifact(b["art"])
    assert art.meta == {"case": case} and art.header["platforms"] == ["cpu"]
    out = art.bind(coldstart.load_native_state(b["nsv"])[0])(*b["inputs"])
    assert len(out) == len(b["ref"])
    for r, o in zip(b["ref"], out):
        assert torch.equal(r, o)
    # one uniception:: node per kernel call of the eager path (both head passes on the portrait-containing batch)
    calls = b["calls"]
    assert calls and _graph_ops(art.exported) == calls
    if case == "dpt_landscape":
        assert calls["uniception.conv3x3.default"] == 4 * 18 and art.prepared is not None
        assert {key for key, _ in art.header["layouts"]} == {"k7_hwio"}
    if case == "int8":
        assert calls["uniception.int8_matmul.default"] > 0
    # no weight tensor in the file: its stored tensors are the traced constants (a few bytes each)
    size, nsv = os.path.getsize(b["art"]), os.path.getsize(b["nsv"])
    stored = _archive_tensors(b["art"])
    print(f"{case}: artifact {size} bytes, .nsv {nsv} bytes ({100 * size / nsv:.2f}%), stored tensors {stored}")
    assert all(n < 1024 for _, n in stored) and size < 0.01 * nsv


def test_artifact_matches_jax_artifact(tmp_path):
    """The port's artifact and the JAX package's, each bound to one .nsv that the JAX package wrote (its loop
    layout, as its own artifact test writes it), agree within 5e-5 on every output; the port's loader refuses the
    JAX artifact, naming it."""
    model, kw = _port("linear")
    jmod = _jax(model, kw, scan=False)
    rng = np.random.RandomState(0)
    imgs = [rng.randn(2, 3, 32, 32).astype(np.float32) for _ in range(2)]
    jpath, ppath, nsv = str(tmp_path / "m.jexp"), str(tmp_path / "m.ptexp"), str(tmp_path / "m.nsv")
    jexport.save_serving_artifact(jpath, jmod, tuple(jnp.asarray(x) for x in imgs))
    jcs.save_native_state(nsv, jmod)
    save_serving_artifact(ppath, model, tuple(torch.from_numpy(x) for x in imgs))
    jout = jexport.load_serving_artifact(jpath).bind(jcs.load_native_state(nsv)[0])(*imgs)
    art = load_serving_artifact(ppath)
    arrays, _ = coldstart.load_native_state(nsv)
    pout = art.bind(arrays)(*(torch.from_numpy(x) for x in imgs))
    for j, p in zip(jout, pout):
        assert sorted(j) == sorted(p)
        for k in j:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]), rtol=5e-5, atol=5e-5, err_msg=k)
    with pytest.raises(ValueError, match="JAX serving artifact"):
        load_serving_artifact(jpath)


def test_artifact_rejects_missing_params_and_other_platforms(built, tmp_path):
    b = built("linear")
    model, inputs = b["model"], b["inputs"]
    art = load_serving_artifact(b["art"])
    with pytest.raises(ValueError, match="missing"):
        art.order_params({})
    with pytest.raises(ValueError, match="cannot bind on 'cuda'"):
        art.bind({}, device="cuda")
    path, imgs = str(tmp_path / "m.ptexp"), serve.artifact_inputs(model, 2, (32, 32), "cpu")
    with pytest.raises(ValueError, match="TPU serving artifact comes from the JAX package"):
        save_serving_artifact(path, model, imgs, platforms=("cpu", "tpu"))
    with pytest.raises(ValueError, match="one artifact per device type"):
        save_serving_artifact(path, model, imgs, platforms=("cuda",))
    # the process's precision settings are recorded; a CUDA bind under others raises before shipping anything
    assert art.header["precision"]["cudnn_allow_tf32"] == torch.backends.cudnn.allow_tf32
    art.device = torch.device("cuda")
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not flag
    try:
        with pytest.raises(ValueError, match="other precision settings"):
            art.bind({}, device="cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    art.device = torch.device("cpu")
    # order_params in calling order, and call() on them: the bound forward's outputs
    arrays, _ = coldstart.load_native_state(b["nsv"])
    ordered = art.order_params(arrays)
    assert len(ordered) == len(art.param_paths) == len(model.state_dict())
    for x, y in zip(art.call(ordered, *inputs), art.bind(arrays)(*inputs)):
        assert torch.equal(x, y)


def test_serving_process_needs_no_model_code(built, tmp_path):
    """The consumer side: a fresh process that imports only utils.export and utils.coldstart reproduces the
    outputs of the int8 trunk bit for bit and imports no model module (no factory, encoders, info sharing, heads
    or nn)."""
    b = built("int8")
    art_path, nsv_path, exp_path = b["art"], b["nsv"], str(tmp_path / "expected.pt")
    torch.save({"inputs": b["inputs"], "ref": b["ref"]}, exp_path)
    worker = textwrap.dedent(f"""
        import sys
        import torch
        from uniception_tpu_torch.utils.export import load_serving_artifact
        from uniception_tpu_torch.utils.coldstart import load_native_state
        art = load_serving_artifact({art_path!r})
        arrays, _ = load_native_state({nsv_path!r})
        exp = torch.load({exp_path!r})
        out = art.bind(arrays)(*exp["inputs"])
        assert all(torch.equal(a, b) for a, b in zip(out, exp["ref"])), "outputs differ"
        forbidden = ("models.factory", "models.encoders", "models.info_sharing", "models.prediction_heads", ".nn")
        loaded = [m for m in sys.modules if m.startswith("uniception_tpu_torch") and any(f in m for f in forbidden)]
        assert not loaded, f"the serving process imported model code: {{loaded}}"
        print("SERVING_OK")
    """)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", worker], env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "SERVING_OK" in r.stdout, f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}"
