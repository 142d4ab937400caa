"""K1's share of its roofline in the traced serving window: the least time of every K1 call there (the larger
of its operations, 4 * B * H * Nq * Nk * D, at the card's bf16 peak and its bytes, q, k and v read and o written
once in bf16, at the card's HBM bandwidth), over the device time of the kernels named below. The calls are the
configuration's attention calls (portbench/models/<family>.py) for each batch traced; when the trace holds
another number of K1 launches than those calls, the program took another path and nothing is read. Moves
``pairs_per_s``."""

from portbench.core.device import peak_of
from portbench.core.stats import roofline_least_s

KERNELS = ("fa_fwd_bf16",)  # K1's kernels in uniception_tpu_torch/csrc/flash_attention.cu


def read(record):
    t, peak = record.trace, peak_of(record.device_kind)
    if t is None or peak is None or not record.traced_units:
        return None
    fam = record.family
    calls = fam.attention_calls(record.arch, record.pairs_per_unit)
    count, seconds = t.device_seconds(KERNELS)
    if count != len(calls) * record.traced_units or seconds <= 0:
        return None
    least = sum(roofline_least_s(4 * B * H * Nq * Nk * D, fam.attention_bytes((B, H, Nq, Nk, D)),
                                 peak["bf16_flops"], peak["hbm_bytes_per_s"]) for B, H, Nq, Nk, D in calls)
    return 100.0 * least * record.traced_units / seconds
