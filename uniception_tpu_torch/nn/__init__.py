"""
Neural-network building blocks (counterpart of uniception_tpu/nn). The package
root exports the int8 weight-transform path as the JAX package's does: GPTQ
(nn/gptq.py) and the SmoothQuant / QuaRot rewrites (nn/smooth.py).
"""

from uniception_tpu_torch.nn.gptq import apply_gptq, gptq_int8, harvest_hessians, install_hessian_capture, load_gptq_npz
from uniception_tpu_torch.nn.smooth import hadamard, head_rotation, rotate_trunk, smooth_trunk

__all__ = [
    "apply_gptq",
    "gptq_int8",
    "harvest_hessians",
    "install_hessian_capture",
    "load_gptq_npz",
    "hadamard",
    "head_rotation",
    "rotate_trunk",
    "smooth_trunk",
]
