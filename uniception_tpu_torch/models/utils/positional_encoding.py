"""
Patch-position helper (counterpart of uniception_tpu/models/utils/positional_encoding.py).
"""

import torch

__all__ = ["PositionGetter", "make_patch_positions"]


def make_patch_positions(batch_size: int, height: int, width: int, device=None, dtype=torch.int32) -> torch.Tensor:
    """Return (batch, height*width, 2) integer (y, x) positions of patches.

    Row-major (y outer, x inner), matching torch.cartesian_prod(y, x) in the
    reference. The batch axis is a broadcast view (stride 0).
    """
    y = torch.arange(height, dtype=dtype, device=device)
    x = torch.arange(width, dtype=dtype, device=device)
    pos = torch.cartesian_prod(y, x).reshape(height * width, 2)
    return pos[None].expand(batch_size, height * width, 2)


class PositionGetter:
    "Callable wrapper matching the reference's PositionGetter API: (b, h, w, device) -> (b, h * w, 2) positions."

    def __call__(self, b: int, h: int, w: int, device=None) -> torch.Tensor:
        return make_patch_positions(b, h, w, device=device)
