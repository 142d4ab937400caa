"""K3's share of its roofline in the traced training window: the least time of every attention backward there
(the larger of its five products, 10 * B * H * Nq * Nk * D with the recomputed scores, at the card's bf16 peak,
and its bytes, q, k, v, o and dO read in bf16 with the fp32 logsumexp, dq, dk and dv written in bf16, at the
card's HBM bandwidth), over the device time of all of K3's kernels (``fa_bwd_*``: the row-sum pre-pass, dq,
dk and dv). The calls are the configuration's attention calls (portbench/models/<family>.py) for each step
traced; when the trace holds another number of K3 dq launches, the program took another path and nothing is
read. Moves ``train_pairs_per_s``."""

from portbench.core.device import peak_of
from portbench.core.stats import roofline_least_s

KERNELS = ("fa_bwd_",)  # K3's kernels in uniception_tpu_torch/csrc/flash_attention_bwd.cu
ONE_PER_CALL = ("fa_bwd_dq",)


def _bytes(B, H, Nq, Nk, D):
    return 2 * B * H * D * (3 * Nq + 2 * Nk) + 4 * B * H * Nq + 2 * B * H * D * (Nq + 2 * Nk)


def read(record):
    t, peak = record.trace, peak_of(record.device_kind)
    if t is None or peak is None or not record.traced_units:
        return None
    calls = record.family.attention_calls(record.arch, record.pairs_per_unit)
    count, _ = t.device_seconds(ONE_PER_CALL)
    _, seconds = t.device_seconds(KERNELS)
    if count != len(calls) * record.traced_units or seconds <= 0:
        return None
    least = sum(roofline_least_s(10 * B * H * Nq * Nk * D, _bytes(B, H, Nq, Nk, D), peak["bf16_flops"],
                                 peak["hbm_bytes_per_s"]) for B, H, Nq, Nk, D in calls)
    return 100.0 * least * record.traced_units / seconds
