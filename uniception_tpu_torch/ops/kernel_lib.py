"""
Build and load the hand-written CUDA kernels of ``uniception_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per file, all started together, and the objects are linked
into ONE shared library with a plain C interface, which is loaded with
``ctypes``. The build happens at the first kernel launch (never at import, so
the package imports on machines without ``nvcc`` or a GPU) into
``uniception_tpu_torch/_build/``, under a name that hashes the sources, the
headers (``csrc/*.cuh``) and the flags: a changed file rebuilds, an unchanged
tree is reused.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero status into an error.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "library", "check"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills of each kernel, kept in BUILD_LOG
)

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # compiler output of the build this process ran ("" when the library was reused)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError(f"nvcc not found on PATH or at {path}: the CUDA kernels cannot be built")
    return str(path)


def _run(procs):
    "Wait for every (cmd, Popen); raise with the compiler's output if any failed. Returns the joined output."
    log, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def build() -> Path:
    "Compile csrc/*.cu into the shared library (if not built yet) and return its path."
    global BUILD_LOG
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):  # sources and headers
        digest.update(p.name.encode() + p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libuniception_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    tmp = out.with_name(f"{tag}.tmp")
    procs = []
    try:
        for src, obj in zip(sources, objects):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = _run(procs)
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objects)]
        log += _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp, out)  # atomic: a concurrent build never sees a half-written library
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    BUILD_LOG = log
    return out


def _declare(lib):
    P, I, L, F, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_double
    lib.uc_flash_attention_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, I] + [L] * 9 + [F, P]
    lib.uc_flash_attention_fwd.restype = I
    lib.uc_flash_attention_bwd.argtypes = [P] * 10 + [I] * 6 + [L] * 12 + [F, P]
    lib.uc_flash_attention_bwd.restype = I
    lib.uc_rope2d.argtypes = [P, P, P, I, I, I, I, I] + [L] * 6 + [Dbl, Dbl, P]
    lib.uc_rope2d.restype = I
    lib.uc_error_string.argtypes = [I]
    lib.uc_error_string.restype = ctypes.c_char_p


def library():
    "The loaded kernel library; builds it on first use."
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def check(status: int, kernel: str):
    "Raise if a launch returned a CUDA error."
    if status != 0:
        msg = library().uc_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch ({msg})")
