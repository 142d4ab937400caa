"""The whole training step's share of the card's peak: three times the configuration's forward operations per
pair (forward, and a backward of twice its products; no recompute counted) for the pairs trained in the measured
window, over the window's seconds times the card's published dense bf16 peak (the fp32 heads' operations at the
same peak). Moves ``train_pairs_per_s``; bounds K3's roofline share from above in time."""

from portbench.core.device import peak_of


def read(record):
    peak = peak_of(record.device_kind)
    if peak is None or record.window_s <= 0:
        return None
    flops = 3 * record.family.forward_flops_per_pair(record.arch) * record.units
    return 100.0 * flops / (record.window_s * peak["bf16_flops"])
