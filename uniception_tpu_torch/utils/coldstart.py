"""
Serving cold start: construction on the ``meta`` device and batched weight
materialization (counterpart of uniception_tpu/utils/coldstart.py).

    model = abstract_construct(lambda: DUSt3R(...))        # no init compute, no memory
    arrays, meta = load_native_state("dust3r.nsv")           # zero-copy memory map
    materialize(model, arrays=arrays, device="cuda")         # one copy per dtype section

or from a torch-layout checkpoint (``utils.checkpoint.load_checkpoint``):

    materialize(model, state_dict=ckpt["model"], ignore=model.checkpoint_alias_patterns(), device="cuda")

The native serving container is the JAX package's, byte for byte: magic
``UNICEPTION_NSV1\\n``, a framed JSON header (utils/framing.py), then the
tensors grouped by dtype into 64-byte-aligned sections. It is keyed by the
JAX package's state paths in its own layout, so one file serves both
packages:

    * loop layout: ``encoder.enc_blocks.0.attn.qkv.kernel.value``;
    * scan layout (the JAX serving default): ``encoder.enc_blocks.attn.qkv.kernel.value``,
      the depth stacked on a leading axis.

One table maps those paths to the port's state-dict keys, both ways, with the
rules of uniception_tpu/utils/torch_compat.py: a linear kernel (in, out) is
the weight (out, in); a conv kernel (kh, kw, in, out) is (out, in, kh, kw); a
transposed conv's kernel (kh, kw, in, out) is the spatially flipped (in, out,
kh, kw); a LayerNorm/GroupNorm scale is its weight; a block list stacked in
the scan layout is ``root.{i}.rest``; ``Int8Linear``'s keys are the JAX
module's (nn/quant.py exports w_q as (in, out)). The JAX modules' dropout
RNG leaves (``*.rngs.count``) have no counterpart and are skipped on load;
the port does not write them (the JAX loader makes them zeros, their initial
value). A non-persistent buffer (the multi-view info sharing's sinusoid
view- or set-index table) is computed at construction, never written and
never loaded: the JAX package keeps it as a plain array attribute, which its
files hold at ``info_sharing.view_pos_table`` (no ``.value``), and the load
skips that entry. ``.npz`` holds the same state as a numpy zip (bf16 as raw
2-byte words with the true dtype in its metadata).

:func:`materialize` copies each dtype section to the device as one pinned
host-to-device copy, does the layout transforms and casts there, and installs
the tensors with ``load_state_dict(assign=True)``. Every tensor takes the
dtype the module was built with (bf16 trunk, fp32 heads for serving); none is
left on ``meta``.
"""

import json
import os
import re
from collections.abc import Mapping
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from uniception_tpu_torch.utils.framing import read_framed_header, write_framed_header
from uniception_tpu_torch.utils.weights import recomputed_buffers

__all__ = [
    "abstract_construct",
    "materialize",
    "native_key_table",
    "stored_int8_layers",
    "save_native_state",
    "load_native_state",
    "is_native_state",
    "PackedNativeState",
]

_META_KEY = "__native_state_meta__"
_NSV_MAGIC = b"UNICEPTION_NSV1\n"
_ALIGN = 64

# dtype name (numpy's and the JAX package's) -> (numpy dtype of the stored words, torch dtype). bf16 is read
# as 2-byte integer words and viewed as torch.bfloat16, so no numpy extension dtype is needed.
_DTYPES = {
    "float32": (np.float32, torch.float32),
    "float16": (np.float16, torch.float16),
    "bfloat16": (np.int16, torch.bfloat16),
    "int8": (np.int8, torch.int8),
    "int32": (np.int32, torch.int32),
    "uint32": (np.uint32, None),  # the JAX modules' RNG counters: read past, never installed
}
_NAMES = {tdt: name for name, (_, tdt) in _DTYPES.items() if tdt is not None}


def _dtype_name(dt: torch.dtype) -> str:
    if dt not in _NAMES:
        raise ValueError(f"no native-state dtype for {dt}")
    return _NAMES[dt]


def _skipped(path: str) -> bool:
    "JAX state leaves with no counterpart in the port: the dropout modules' RNG state."
    return ".rngs." in path


def abstract_construct(thunk: Callable[[], nn.Module]) -> nn.Module:
    """Build a module on the ``meta`` device, under fast init
    (models/utils/config.py): its tensors have shapes and dtypes but no
    storage, and no initializer computes anything. The thunk must not name a
    device of its own."""
    from uniception_tpu_torch.models.utils.config import fast_init

    with torch.device("meta"), fast_init(True):
        return thunk()


# --- the key table ----------------------------------------------------------------------------------------------


def _stacked_roots(module: nn.Module) -> Dict[str, int]:
    """Dotted names of the block lists the JAX scan layout stacks (encoder blocks, each view's decoder branch, the
    multi-view info sharing's blocks) -> depth."""
    from uniception_tpu_torch.nn.blocks import CrossAttentionBlock, SelfAttentionBlock

    return {
        name: len(mod)
        for name, mod in module.named_modules()
        if isinstance(mod, nn.ModuleList) and len(mod)
        and all(isinstance(b, (SelfAttentionBlock, CrossAttentionBlock)) for b in mod)
    }


def _kind(owner: nn.Module, attr: str):
    "(JAX leaf name, layout transform) of ``owner``'s state entry ``attr``."
    if attr == "weight":
        if isinstance(owner, nn.Linear):
            return "kernel", "linear"
        if isinstance(owner, nn.ConvTranspose2d):
            return "kernel", "conv_transpose"
        if isinstance(owner, nn.Conv2d):
            return "kernel", "conv"
        if isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
            return "scale", "same"
    return attr, "same"


def native_key_table(module: nn.Module) -> Dict[str, tuple]:
    """For each state-dict key of ``module``: (loop-layout JAX path, transform,
    scan-layout JAX path or None, depth index in the stack or None)."""
    roots = _stacked_roots(module)
    owners = dict(module.named_modules())
    table = {}
    for key in module.state_dict():
        prefix, _, attr = key.rpartition(".")
        leaf, kind = _kind(owners[prefix], attr)
        jkey = f"{prefix}.{leaf}" if prefix else leaf
        scan, index = None, None
        for root in roots:
            if jkey.startswith(root + "."):
                idx, rest = jkey[len(root) + 1:].split(".", 1)
                scan, index = f"{root}.{rest}.value", int(idx)
                break
        table[key] = (f"{jkey}.value", kind, scan, index)
    return table


def stored_int8_layers(module: nn.Module, arrays: Mapping):
    """(dotted paths of the linear layers that ``arrays`` stores as Int8Linear,
    those of them with ``w_colsum``), in either layout. The JAX package decides
    which layers to quantize by the kernel's size, which in its scan layout
    includes the depth, so a file, not a policy, says which layers are int8."""
    roots = _stacked_roots(module)

    def stored(path, leaf):
        if f"{path}.{leaf}.value" in arrays:
            return True
        for root in roots:
            if path.startswith(root + "."):
                rest = path[len(root) + 1:].split(".", 1)[1]
                return f"{root}.{rest}.{leaf}.value" in arrays
        return False

    linears = [name for name, mod in module.named_modules() if isinstance(mod, nn.Linear)]
    return ({n for n in linears if stored(n, "w_q")}, {n for n in linears if stored(n, "w_colsum")})


def _to_native(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return t.t()
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    if kind == "conv_transpose":
        return t.flip(2, 3).permute(2, 3, 0, 1)
    return t


def _from_native(a: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return a.t()
    if kind == "conv":
        return a.permute(3, 2, 0, 1)
    if kind == "conv_transpose":
        return a.permute(2, 3, 0, 1).flip(2, 3)
    return a


# --- containers ---------------------------------------------------------------------------------------------------


def _torch_view(words: np.ndarray, name: str) -> torch.Tensor:
    "A CPU tensor over ``words`` (no copy), of the dtype ``name``."
    t = torch.from_numpy(words)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


class PackedNativeState(Mapping):
    """Zero-copy view of a dtype-grouped ``.nsv`` checkpoint: a Mapping of
    JAX state path -> CPU tensor (a view into one memory map).
    :func:`materialize` ships each dtype section as one buffer."""

    def __init__(self, blobs: dict, index: dict, meta: dict):
        self.blobs = blobs  # dtype name -> 1-D numpy view of its section (bf16 as int16 words)
        self.index = index  # path -> (dtype name, shape, element offset in its section)
        self.meta = meta

    def __getitem__(self, k):
        name, shape, eoff = self.index[k]
        n = int(np.prod(shape))
        return _torch_view(self.blobs[name][eoff : eoff + n], name).reshape(shape)

    def __iter__(self):
        return iter(self.index)

    def __len__(self):
        return len(self.index)


def _sniff_nsv(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(_NSV_MAGIC)) == _NSV_MAGIC
    except OSError:
        return False


def is_native_state(path: str) -> bool:
    "True when ``path`` is a native serving checkpoint (``.nsv``, or ``.npz`` written by save_native_state)."
    if _sniff_nsv(path):
        return True
    if not path.endswith(".npz"):
        return False
    with np.load(path, allow_pickle=False) as data:
        return _META_KEY in data.files


def load_native_state(path: str):
    """Load a native serving checkpoint written by either package.

    Returns (arrays, meta): arrays maps JAX state paths to CPU tensors (a
    :class:`PackedNativeState` for the packed container, a dict for ``.npz``);
    meta is the user metadata (e.g. ``quant``, ``quant_policy``, ``quant_asym``).
    """
    if _sniff_nsv(path):
        with open(path, "rb") as f:
            header = read_framed_header(f, _NSV_MAGIC, what="native-state checkpoint")
            base = f.tell()
            base += (-base) % _ALIGN
        # copy-on-write map: zero-copy, and writable views, which torch.from_numpy wants
        if header.get("layout") != "dtype-grouped":
            raise ValueError(f"{path}: native-state layout {header.get('layout')!r} is not the dtype-grouped one")
        region = np.memmap(path, dtype=np.uint8, mode="c")[base:]
        blobs = {}
        for name, sec in header["sections"].items():
            words = np.dtype(_DTYPES[name][0])
            start = int(sec["offset"])
            blobs[name] = region[start : start + int(sec["nelems"]) * words.itemsize].view(words)
        index = {t["path"]: (t["dtype"], tuple(t["shape"]), int(t["eoff"])) for t in header["tensors"]}
        return PackedNativeState(blobs, index, header["meta"]), header["meta"]

    with np.load(path, allow_pickle=False) as data:
        if _META_KEY not in data.files:
            raise ValueError(f"{path} is not a native-state checkpoint (use utils.checkpoint.load_checkpoint)")
        header = json.loads(str(data[_META_KEY]))
        dtypes = header.get("dtypes", {})
        arrays = {}
        for k in data.files:
            if k == _META_KEY:
                continue
            a = data[k]
            name = dtypes.get(k, a.dtype.name)
            words = np.dtype(_DTYPES[name][0])
            arrays[k] = _torch_view(np.ascontiguousarray(a).view(words), name)
    meta = {k: v for k, v in header.items() if k not in ("format", "dtypes")}
    return arrays, meta


def _native_entries(module: nn.Module, dtype: Optional[torch.dtype], layout: str):
    "[(JAX path, CPU tensor in the JAX layout)] of the module's state, sorted by path."
    if layout not in ("loop", "scan"):
        raise ValueError(f"layout must be 'loop' or 'scan', got {layout!r}")
    state = module.state_dict()
    table = native_key_table(module)
    out, stacks = {}, {}
    for key, (path, kind, scan, index) in table.items():
        t = _to_native(state[key].detach(), kind).cpu()
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        if layout == "scan" and scan is not None:
            stacks.setdefault(scan, {})[index] = t
        else:
            out[path] = t.contiguous()
    for scan, layers in stacks.items():
        out[scan] = torch.stack([layers[i] for i in range(len(layers))])
    return sorted(out.items())


def _words(t: torch.Tensor) -> np.ndarray:
    "The tensor's values as numpy words (bf16 as int16 bit patterns)."
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def save_native_state(path: str, module: nn.Module, *, dtype: Optional[torch.dtype] = None, layout: str = "loop",
                      **metadata) -> None:
    """Write the module's state as a native serving checkpoint in the JAX
    package's paths and layout (``layout`` "loop" or "scan"); ``dtype``
    pre-casts the floating tensors (serving: ``torch.bfloat16``). A path
    ending in ``.npz`` gets the numpy zip container, any other (``.nsv``) the
    packed one that :func:`load_native_state` memory-maps."""
    entries = _native_entries(module, dtype, layout)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".npz"):
        payload = {p: _words(t) for p, t in entries}
        dtypes = {p: _dtype_name(t.dtype) for p, t in entries}
        payload[_META_KEY] = np.array(json.dumps({"format": "native_state", "dtypes": dtypes, **metadata}))
        np.savez(path, **payload)
        return
    by_dt = {}
    for p, t in entries:
        by_dt.setdefault(_dtype_name(t.dtype), []).append((p, t))
    sections, tensors, off = {}, [], 0
    for name in sorted(by_dt):
        off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
        eoff = 0
        for p, t in by_dt[name]:
            tensors.append({"path": p, "dtype": name, "shape": list(t.shape), "eoff": eoff})
            eoff += t.numel()
        sections[name] = {"offset": off, "nelems": eoff}
        off += eoff * np.dtype(_DTYPES[name][0]).itemsize
    header = {"format": "native_state", "layout": "dtype-grouped", "sections": sections, "tensors": tensors,
              "meta": metadata}
    with open(path, "wb") as f:
        write_framed_header(f, _NSV_MAGIC, header)
        base = f.tell()
        f.write(b"\0" * ((-base) % _ALIGN))
        base += (-base) % _ALIGN
        for name in sorted(by_dt):
            f.seek(base + sections[name]["offset"])
            for _, t in by_dt[name]:
                f.write(_words(t).tobytes())


# --- materialize ----------------------------------------------------------------------------------------------------


def _pack(tensors: Dict[str, torch.Tensor]):
    "Group CPU tensors by dtype into one 1-D tensor each: (blobs, index) as a PackedNativeState holds them."
    groups, index = {}, {}
    for k, t in tensors.items():
        name = _dtype_name(t.dtype)
        parts = groups.setdefault(name, [])
        index[k] = (name, tuple(t.shape), sum(p.numel() for p in parts))
        parts.append(t.reshape(-1))
    return {name: torch.cat(parts) for name, parts in groups.items()}, index


def _ship(blobs: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    "One host-to-device copy per dtype section, through pinned memory on CUDA."
    out = {}
    for name, host in blobs.items():
        if device.type == "cuda":
            pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            pinned.copy_(host)
            out[name] = pinned.to(device, non_blocking=True)
        else:
            out[name] = host.to(device, copy=True)  # the module never holds views of a memory map
    return out


def materialize(
    module: nn.Module,
    *,
    arrays: Optional[Mapping] = None,
    state_dict: Optional[Mapping] = None,
    device="cuda",
    ignore: Sequence[str] = (),
) -> nn.Module:
    """Fill a module built by :func:`abstract_construct` and place it on ``device``.

    arrays: native state (JAX path -> tensor, from :func:`load_native_state`), loop or scan layout.
    state_dict: torch-layout state (key -> numpy array or tensor, e.g. ``load_checkpoint(...)["model"]``);
        keys matching a regex of ``ignore`` (the reference's aliases) are dropped first.
    In either, an entry naming a non-persistent buffer (recomputed at construction) is not loaded.

    The load is strict: a missing or unexpected entry raises (KeyError), a
    shape mismatch raises (ValueError). Returns the module.
    """
    if (arrays is None) == (state_dict is None):
        raise ValueError("pass arrays= (native state) or state_dict= (torch layout), one of them")
    device = torch.device(device)
    own = module.state_dict()
    recomputed = recomputed_buffers(module)
    table = native_key_table(module)
    sources = {}  # state key -> (source key, index in a scan stack or None)
    if arrays is not None:
        for key, (path, _, scan, index) in table.items():
            if path in arrays:
                sources[key] = (path, None)
            elif scan is not None and scan in arrays:
                sources[key] = (scan, index)
        used = {src for src, _ in sources.values()}
        unexpected = sorted(p for p in arrays if p not in used and not _skipped(p) and p not in recomputed)
        if isinstance(arrays, PackedNativeState):  # ship its sections as they are, those the module uses
            shipped = {arrays.index[p][0] for p in used}
            host = {n: _torch_view(b, n) for n, b in arrays.blobs.items() if n in shipped}
            index = arrays.index
        else:
            host, index = _pack({p: torch.as_tensor(arrays[p]) for p in used})
    else:
        pats = [re.compile(p) for p in ignore]
        kept = {k: v for k, v in state_dict.items() if k not in recomputed and not any(p.search(k) for p in pats)}
        sources = {key: (key, None) for key in own if key in kept}
        unexpected = sorted(k for k in kept if k not in own)
        host, index = _pack({k: torch.as_tensor(kept[k]) for k in sources})
    missing = [k for k in own if k not in sources]
    if missing or unexpected:
        raise KeyError(f"strict load failed: missing_keys={missing[:8]}, unexpected_keys={unexpected[:8]}")

    dev = _ship(host, device)
    state = {}
    for key, (src, i) in sources.items():
        name, shape, eoff = index[src]
        t = dev[name][eoff : eoff + int(np.prod(shape))].view(shape)
        if i is not None:
            t = t[i]
        if arrays is not None:
            t = _from_native(t, table[key][1])
        if tuple(t.shape) != tuple(own[key].shape):
            raise ValueError(f"Shape mismatch for {key}: checkpoint {tuple(t.shape)} vs module {tuple(own[key].shape)}")
        state[key] = t.to(own[key].dtype).contiguous()
    module.load_state_dict(state, strict=True, assign=True)
    for mod in module.modules():
        for name, t in mod._buffers.items():
            if t is None:
                continue
            if name in mod._non_persistent_buffers_set:  # built on the host at construction: placed, not loaded
                t = t.to(device)
            mod._buffers[name] = t.contiguous()  # a load hook may install a transposed view (Int8Linear's w_q)
    left = [n for n, t in list(module.named_parameters()) + list(module.named_buffers()) if t.is_meta]
    if left:
        raise RuntimeError(f"materialize: tensors left on the meta device: {left[:8]}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return module
