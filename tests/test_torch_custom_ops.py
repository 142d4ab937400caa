"""
The kernels' custom ops (the ``uniception`` namespace of torch.library) on the CPU: each op's fake kernel, called
under FakeTensorMode, gives the outputs of its real CPU implementation (the plain version) in shape, dtype and
strides, so ``torch.export`` traces what the replay computes; each op is in the namespace a loaded artifact names.
An eager call runs the implementation without the op's dispatch, and a call that a dispatch mode watches goes
through the op, with the same bits (ops/serving_operands.py ``kernel_op``).
The CUDA implementations' outputs (contiguous, the kernels' layouts) are held by the card tests
(tests/test_torch_cuda_kernels.py ``test_custom_op_under_export_gives_the_kernels_bits``).
"""

import collections

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

import uniception_tpu_torch.utils.export  # noqa: F401  (imports every op's registration)
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.ops import conv3x3, flash_attention, fused_attention, int8_matmul, rope

NAMES = ["rope2d", "flash_attention_fwd", "flash_attention_fwd_lse", "flash_attention_int8", "flash_attention_int8_prep",
         "int8_matmul", "conv3x3", "fused_self_attention", "fused_cross_attention"]
KERNEL_OPS = {"rope2d": rope.rope2d_op, "flash_attention_fwd": flash_attention.flash_attention_fwd_op,
              "flash_attention_fwd_lse": flash_attention.flash_attention_fwd_lse_op,
              "flash_attention_int8": flash_attention.flash_attention_int8_op,
              "flash_attention_int8_prep": flash_attention.flash_attention_int8_prep_op,
              "int8_matmul": int8_matmul.int8_matmul_op, "conv3x3": conv3x3.conv3x3_op,
              "fused_self_attention": fused_attention.fused_self_op,
              "fused_cross_attention": fused_attention.fused_cross_op}


def _args(name):
    rng = np.random.RandomState(len(name))
    t = lambda *shape, dt=torch.float32: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt)  # noqa: E731
    bf = torch.bfloat16
    q, k, v = t(2, 16, 4, 20), t(2, 24, 4, 20), t(2, 24, 4, 20)
    pos = make_patch_positions(2, 4, 4).to(torch.int32)
    return {
        "rope2d": (t(2, 16, 4, 32), pos, 100.0, 1.0, False),
        "flash_attention_fwd": (q, k, v, 0.2, 20),
        "flash_attention_fwd_lse": (q.to(bf), k.to(bf), v.to(bf), 0.2, 20),
        "flash_attention_int8": (q.to(bf), k.to(bf), v.to(bf), 0.2, "int8pv", 20),
        "flash_attention_int8_prep": (k.to(bf), v.to(bf), "int8pv", 20),
        "int8_matmul": (t(2, 5, 64), torch.randint(-127, 128, (48, 64), dtype=torch.int8).t(), t(1, 48).abs(),
                        t(48), torch.bfloat16),
        "conv3x3": (t(2, 6, 5, 64, dt=bf), t(3, 3, 64, 16, dt=bf), t(16)),
        "fused_self_attention": (t(2, 16, 32), t(96, 32), t(96), pos, 2, 16, 0.25, 100.0, 1.0, False),
        "fused_cross_attention": (t(2, 16, 32), t(2, 16, 24), t(32, 32), t(32, 24), t(32, 24), t(32), None, t(32),
                                  pos, pos, 2, 16, 0.25, 100.0, 1.0, False),
    }[name]


def _meta(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [(tuple(o.shape), o.dtype, o.stride() if o.numel() else None, o.device.type) for o in outs]


@pytest.mark.parametrize("name", NAMES)
def test_fake_kernel_matches_the_cpu_implementation(name):
    op = getattr(torch.ops.uniception, name)
    args = _args(name)
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    assert _meta(fake) == _meta(real)


class _OpCalls(TorchDispatchMode):
    "Counts the ``uniception::`` op calls made under it."

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "uniception":
            self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _refuse(*args):
    raise AssertionError("an eager call went through the op's dispatch")


@pytest.mark.parametrize("name", NAMES)
def test_eager_call_skips_the_op_and_a_watched_call_takes_it(name, monkeypatch):
    kop, args = KERNEL_OPS[name], _args(name)
    via_op = getattr(torch.ops.uniception, name)(*args)
    with monkeypatch.context() as m:
        m.setattr(kop, "op", _refuse)
        direct = kop(*args)
    with _OpCalls() as mode:
        watched = kop(*args)
    assert mode.calls == {f"uniception.{name}.default": 1}
    for a, b, c in zip(*((o if isinstance(o, tuple) else (o,)) for o in (via_op, direct, watched))):
        assert torch.equal(a, b) and torch.equal(a, c)
