"""The whole serving step's share of the card's peak: the configuration's forward operations (every linear, conv
and attention product, portbench/models/<family>.py) for the pairs served in the measured window, over the
window's seconds times the card's published dense bf16 peak. The fp32 heads' operations are counted at the same
peak. Moves ``pairs_per_s``; bounds every kernel's roofline share from above in time."""

from portbench.core.device import peak_of


def read(record):
    peak = peak_of(record.device_kind)
    if peak is None or record.window_s <= 0:
        return None
    flops = record.family.forward_flops_per_pair(record.arch) * record.units
    return 100.0 * flops / (record.window_s * peak["bf16_flops"])
