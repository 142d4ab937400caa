"""What a run must not load, and where its caches go."""

import os
import sys
from pathlib import Path

__all__ = ["FORBIDDEN", "forbidden_loaded", "pin_cache_dirs"]

# top-level module names a run may not hold once its window has closed: JAX, its libraries and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "uniception_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first dot) is one of :data:`FORBIDDEN`,
    compared whole: ``uniception_tpu_torch`` begins with ``uniception_tpu`` and is not it."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def pin_cache_dirs(checkout: Path) -> None:
    """Fixed cache directories inside the checkout for every build tool a run may start (torch's C++ extensions and
    Triton), and no JAX or Flax through a library that would load it on its own. Set before torch is imported.
    The program's own kernel library builds into its package directory, which is inside the checkout too."""
    cache = checkout / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
