"""The share of the traced serving window in which no operation ran on the card (the union of the profiler's
device intervals: kernels, copies, memsets), in percent. Moves ``pairs_per_s``."""

from portbench.core.trace import idle_percent


def read(record):
    return idle_percent(record.trace)
