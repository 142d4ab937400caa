"""
Models namespace (counterpart of uniception_tpu/models/__init__.py). Submodule imports are lazy (PEP 562): the
encoders pull in nn/ops modules which themselves read ``models.utils.config``, so an eager import here would make
this package's init circular.
"""

import importlib

_LAZY = {
    "encoders": "uniception_tpu_torch.models.encoders",
    "info_sharing": "uniception_tpu_torch.models.info_sharing",
    "prediction_heads": "uniception_tpu_torch.models.prediction_heads",
    "DUSt3R": "uniception_tpu_torch.models.factory.dust3r",
    "MultiViewPointmapModel": "uniception_tpu_torch.models.factory.multiview",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name) if name[0].isupper() else mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
