"""
Serving artifacts through ``torch.export`` (counterpart of uniception_tpu/utils/export.py).

A serving process that loads an artifact builds no model and runs no model
code: :func:`save_serving_artifact` traces ``module.<method>(*example_inputs)``
once, with the weights as inputs, and writes the traced programs; a serving
process then needs

    * no model code (no ``models.factory``, ``encoders``, ``info_sharing``,
      ``prediction_heads`` and no ``nn`` module): only this module, the
      kernels' op registrations (ops/*.py) and ``utils/coldstart.py``,
    * the weights of a native checkpoint (``.nsv``, written by either package,
      loop or scan layout), matched by the dotted state paths in the header.

The kernels are custom ops of the ``uniception`` namespace (``torch.library``;
K1 with and without its logsumexp, K2, K4, K5 self and cross, K6 and its prep,
K7): the traced program holds one node per launch and replays it, so a loaded
artifact launches, and counts, what the eager call does.

The file is a framed header (utils/framing.py, magic ``UCTORCHEXP1``) and then
two ``torch.export`` programs, each serialized (``torch.export.save``, without
its example inputs or the tracing host's stack traces) and zlib-compressed:

    * ``prepare`` maps the model's state (the checkpoint's arrays in the
      port's layout and dtype) to the layouts its kernels read (K7's HWIO
      copies, K5's padded heads; ops/serving_operands.py); ``bind`` runs it
      once. It is absent when the model needs none;
    * ``forward`` maps (state, those layouts, *inputs) to the outputs.

The weights never enter the file: both programs take them as inputs. A host
branch on the data becomes the static route under export (DUSt3R's
landscape-only second head pass always runs and is selected with ``where``,
as in the JAX package). One artifact serves one set of input shapes on one
device type (``platforms``): a CUDA artifact binds on that CUDA device, a CPU
artifact on the CPU. Precision settings that torch keeps per process, not
per program, change a CUDA program's bits (TF32 for fp32 matmuls and cuDNN
convolutions, reduced-precision bf16 reductions): the header records the
tracing process's, and a CUDA ``bind`` raises where the serving process's
differ.

Typical flow::

    # build host (offline, once)
    model = serve.build_model(...)
    save_native_state("m.nsv", model, dtype=torch.bfloat16, layout="scan")
    save_serving_artifact("m.ptexp", model, (img1, img2))

    # serving host (no model code)
    art = load_serving_artifact("m.ptexp")
    arrays, _ = load_native_state("m.nsv")
    fn = art.bind(arrays)            # weights shipped once, prepare run once
    res1, res2 = fn(img1, img2)
"""

import io
import os
import zlib
from typing import Any, Dict, Optional, Sequence

import torch
from torch.nn.utils.stateless import _reparametrize_module

# the kernels' custom ops: a loaded program names them, so their registrations must be imported
from uniception_tpu_torch.ops import conv3x3, flash_attention, fused_attention, int8_matmul, rope  # noqa: F401
from uniception_tpu_torch.ops.serving_operands import LayoutTrace
from uniception_tpu_torch.utils.coldstart import _from_native, native_key_table, ship_native
from uniception_tpu_torch.utils.framing import read_framed_header, write_framed_header

__all__ = ["save_serving_artifact", "load_serving_artifact", "ServingArtifact"]

_MAGIC = b"UCTORCHEXP1\n"
_JAX_MAGIC = b"UTPEXP1\n"  # uniception_tpu/utils/export.py: a jax.export (StableHLO) artifact
_PROGRAMS = ("prepare", "forward")


class _Program(torch.nn.Module):
    "A module with no state around a function, so ``torch.export`` lifts no weight into the program."

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _live(module: torch.nn.Module, key: str) -> torch.Tensor:
    "The tensor the module holds for its state-dict entry ``key`` (a parameter or a persistent buffer)."
    prefix, _, attr = key.rpartition(".")
    owner = module.get_submodule(prefix)
    return owner._parameters[attr] if attr in owner._parameters else owner._buffers[attr]


def _view(stated: torch.Tensor, held: torch.Tensor) -> str:
    """How the module holds a state-dict entry: "same", or "t" where its state-dict hook exports the transpose
    (Int8Linear's w_q)."""
    if stated is held:
        return "same"
    if (stated.dim() == 2 and stated.data_ptr() == held.data_ptr() and stated.shape == held.shape[::-1]
            and stated.stride() == held.stride()[::-1]):
        return "t"
    raise ValueError(f"state entry {tuple(stated.shape)} is neither the held tensor nor its transpose")


_CASTS = ("to.dtype", "to.device", "to.dtype_layout")


def _prune(program) -> int:
    """Drop the nodes of a traced program that compute nothing: export's dtype and device assertions, and casts of a
    tensor to the dtype, device and strides it has (eager returns the tensor itself; the serving path makes one per
    weight use). Returns the nodes dropped."""
    graph = program.graph_module.graph
    dropped = 0
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        name = str(node.target).replace("aten.", "")
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
            dropped += 1
        elif name in _CASTS and not node.kwargs.get("copy") and not any(u.op == "output" for u in node.users):
            src, out = node.args[0].meta.get("val"), node.meta.get("val")
            if (isinstance(src, torch.Tensor) and isinstance(out, torch.Tensor) and src.dtype == out.dtype
                    and src.device == out.device and src.shape == out.shape and src.stride() == out.stride()):
                node.replace_all_uses_with(node.args[0])
                graph.erase_node(node)
                dropped += 1
    program.graph_module.recompile()
    return dropped


def _precision() -> Dict[str, bool]:
    "The process's precision settings that change a CUDA program's bits (recorded at save, checked at a CUDA bind)."
    return {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.replace("torch.", ""))


def _spec(t: torch.Tensor):
    return [list(t.shape), str(t.dtype).replace("torch.", ""), str(t.device)]


def save_serving_artifact(
    path: str,
    module: torch.nn.Module,
    example_inputs: Sequence[Any],
    method="forward_pair",
    platforms: Optional[Sequence[str]] = None,
    **metadata,
) -> None:
    """Export ``module.<method>(*example_inputs)`` to a serving artifact.

    Every state entry (parameters and persistent buffers) becomes an input of
    the traced programs, so the weights stay out of the file: they ship in a
    native checkpoint, matched by the JAX package's dotted state paths that
    the header lists in calling order (loop layout, with each entry's place in
    the scan layout's stack). Buffers recomputed at construction are traced as
    constants, as the JAX package captures its RNG state.

    example_inputs: tensors fixing the input shapes, dtypes and devices (one
        artifact per served shape); non-tensor inputs are traced as constants.
    method: a method name, or a callable ``fn(module, *inputs)`` for serving
        entry points that wrap the module (e.g. serve.py's uint8 staging and
        normalization around ``forward_pair``).
    platforms: the device type to trace for, ``("cuda",)`` or ``("cpu",)``;
        default (and the only choice) the one the module's state lives on.
    """
    keys = list(module.state_dict().keys())
    stated = module.state_dict(keep_vars=True)
    held = [_live(module, k) for k in keys]
    devices = {t.device for t in held}
    if len(devices) != 1:
        raise ValueError(f"the module's state spans {sorted(map(str, devices))}: an artifact is traced on one device")
    device = devices.pop()
    if platforms is not None:
        asked = [p.lower() for p in platforms]
        if "tpu" in asked:
            raise ValueError("platforms: a torch.export program runs on CUDA or CPU devices; a TPU serving artifact "
                             "comes from the JAX package (uniception_tpu.utils.export)")
        if asked != [device.type]:
            raise ValueError(f"platforms {list(platforms)}: the port traces one artifact per device type, here the "
                             f"module's {device.type!r}")
    call = (lambda m, *a: getattr(m, method)(*a)) if isinstance(method, str) else method
    state = [t.detach() for t in held]
    inputs = list(example_inputs)
    table = native_key_table(module)

    def run(state_list, args, trace):
        with trace, _reparametrize_module(module, dict(zip(keys, state_list))):
            return call(module, *args)

    # discovery: which weight layouts the forward reads, on fake tensors (nothing computed, nothing launched)
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake_state = [mode.from_tensor(t) for t in state]
    fake_inputs = [mode.from_tensor(x) if isinstance(x, torch.Tensor) else x for x in inputs]
    record = LayoutTrace({id(t): i for i, t in enumerate(fake_state)}, "record")
    with mode, torch.no_grad():
        run(fake_state, fake_inputs, record)
    layouts = record.records

    def prepare(state_list):
        out = []
        for _, fn, idx in layouts:
            got = fn(*(state_list[i] for i in idx))
            out.extend([got] if isinstance(got, torch.Tensor) else got)
        return tuple(out)

    def forward(state_list, operands, *args):
        trace = LayoutTrace({id(t): i for i, t in enumerate(state_list)}, "read", operands, record.slots)
        return run(state_list, args, trace)

    blobs = {}
    with torch.no_grad():
        operands = list(prepare(state))
        programs = {"forward": torch.export.export(_Program(forward), (state, operands, *inputs), strict=False)}
        if layouts:
            programs["prepare"] = torch.export.export(_Program(prepare), (state,), strict=False)
    for name, program in programs.items():
        _prune(program)
        program._example_inputs = None  # they hold the weights
        for node in program.graph.nodes:
            node.meta.pop("stack_trace", None)  # the tracing host's source lines: bytes the replay never reads
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs[name] = zlib.compress(buf.getvalue(), 6)

    header = {
        "format": "uniception_tpu_torch_serving_artifact",
        "method": method if isinstance(method, str) else getattr(method, "__qualname__", "callable"),
        "param_paths": [table[k][0] for k in keys],
        "param_stacks": [None if table[k][2] is None else [table[k][2], table[k][3]] for k in keys],
        "param_kinds": [table[k][1] for k in keys],
        "param_views": [_view(stated[k], t) for k, t in zip(keys, held)],
        "param_specs": [_spec(t)[:2] for t in held],
        "input_specs": [_spec(x) if isinstance(x, torch.Tensor) else None for x in inputs],
        "layouts": [[key, list(idx)] for key, _, idx in layouts],
        "platforms": [device.type],
        "device": str(device),
        "torch": torch.__version__,
        "precision": _precision(),
        "programs": {name: len(blobs.get(name, b"")) for name in _PROGRAMS},
        "meta": metadata,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        write_framed_header(f, _MAGIC, header)
        for name in _PROGRAMS:
            f.write(blobs.get(name, b""))


class ServingArtifact:
    """A loaded serving artifact.

    Attributes:
        param_paths: dotted state paths (loop layout), in the programs' calling order.
        exported: the forward ``torch.export.ExportedProgram``; ``prepared`` the prepare one, or None.
        header: the file's header; meta: user metadata passed at save time.
    """

    def __init__(self, programs: Dict[str, Any], header: Dict[str, Any]):
        self.exported = programs["forward"]
        self.prepared = programs.get("prepare")
        self.header = header
        self.param_paths = header["param_paths"]
        self.meta = header.get("meta", {})
        self.device = torch.device(header["device"])

    def _sources(self, arrays):
        "(path in ``arrays``, index in its stack or None) per param; raises ValueError naming what is missing."
        found, missing = [], []
        for p, stack in zip(self.param_paths, self.header["param_stacks"]):
            if p in arrays:
                found.append((p, None))
            elif stack is not None and stack[0] in arrays:
                found.append((stack[0], stack[1]))
            else:
                missing.append(p)
        if missing:
            raise ValueError(f"native state is missing {len(missing)} artifact params (e.g. {missing[:3]})")
        return found

    def order_params(self, arrays) -> list:
        """Order a native-checkpoint mapping (dotted path -> tensor, loop or scan layout) into the calling
        convention: the native tensors (zero-copy views of a packed checkpoint)."""
        return [arrays[p] if i is None else arrays[p][i] for p, i in self._sources(arrays)]

    def _held(self, native: list) -> list:
        "Native-layout tensors on the device -> the tensors the module held (layout, dtype, contiguous)."
        h = self.header
        out = []
        for a, kind, view, (shape, dt) in zip(native, h["param_kinds"], h["param_views"], h["param_specs"]):
            t = _from_native(a, kind).to(_dtype(dt))
            t = (t.t() if view == "t" else t).contiguous()
            if list(t.shape) != shape:
                raise ValueError(f"checkpoint tensor {tuple(t.shape)} does not fit the artifact's {tuple(shape)}")
            out.append(t)
        return out

    def _prepare(self, state: list) -> list:
        return [] if self.prepared is None else list(self.prepared.module()(state))

    def call(self, params: list, *inputs):
        "Raw call: native params in calling order (:meth:`order_params`), then the model inputs."
        state = self._held([torch.as_tensor(a).to(self.device) for a in params])
        with torch.inference_mode():
            return self.exported.module()(state, self._prepare(state), *inputs)

    def bind(self, arrays, device=None):
        """Ship a native checkpoint's arrays to the device and return ``fn(*inputs)``.

        ``arrays`` maps dotted path -> tensor (``load_native_state``'s output,
        packed or dict, loop or scan layout). They are copied to the device
        once (one copy per dtype section), put in the module's layouts and
        dtypes, and the ``prepare`` program runs once; each call then runs the
        forward program. Inputs are moved to the devices they were traced on
        (uint8 frames through pinned memory). ``device`` must be the device
        the artifact was traced on (the default). On CUDA the process's
        precision settings (TF32, bf16 reductions) must be those the artifact
        was traced under, else the outputs' bits would differ: a mismatch
        raises.
        """
        device = self.device if device is None else torch.device(device)
        if device.type != self.device.type:
            raise ValueError(f"this artifact was traced for {self.device.type!r} (platforms "
                             f"{self.header['platforms']}); it cannot bind on {device.type!r}")
        if device.type == "cuda" and (device.index or 0) != (self.device.index or 0):
            raise ValueError(f"this artifact was traced on {self.device}; it cannot bind on {device}")
        traced, now = self.header["precision"], _precision()
        if device.type == "cuda" and traced != now:
            differ = {k: (traced.get(k), v) for k, v in now.items() if traced.get(k) != v}
            raise ValueError(f"this artifact was traced under other precision settings (torch.backends; traced, "
                             f"this process): {differ}; set them as traced to serve its bits")
        sources = self._sources(arrays)
        shipped = ship_native(arrays, sorted({p for p, _ in sources}), device)
        with torch.inference_mode():
            state = self._held([shipped[p] if i is None else shipped[p][i] for p, i in sources])
            operands = self._prepare(state)
        forward = self.exported.module()
        specs = self.header["input_specs"]

        def fn(*inputs):
            staged = []
            for x, spec in zip(inputs, specs):
                if spec is not None:
                    x = torch.as_tensor(x)
                    want = torch.device(spec[2])
                    if x.device != want:
                        if want.type == "cuda" and x.device.type == "cpu":
                            x = x.pin_memory()
                        x = x.to(want, non_blocking=True)
                staged.append(x)
            with torch.inference_mode():
                return forward(state, operands, *staged)

        return fn


def load_serving_artifact(path: str) -> ServingArtifact:
    "Load a :func:`save_serving_artifact` file. No model code required."
    with open(path, "rb") as f:
        head = f.read(len(_JAX_MAGIC))
        if head == _JAX_MAGIC:
            raise ValueError(f"{path} is a JAX serving artifact (uniception_tpu.utils.export, a jax.export program); "
                             "the port's loader reads the port's own artifacts (uniception_tpu_torch.utils.export)")
        f.seek(0)
        header = read_framed_header(f, _MAGIC, what="serving artifact of uniception_tpu_torch")
        blobs = {name: f.read(header["programs"][name]) for name in _PROGRAMS}
    programs = {name: torch.export.load(io.BytesIO(zlib.decompress(blob))) for name, blob in blobs.items() if blob}
    return ServingArtifact(programs, header)
