"""Host milliseconds of each train ``step(...)`` call (the forward's and backward's launches, the gradient list
and AdamW's launches, up to the call's return; the feed's staging is its own span), averaged over every step of
the measured window, on the benchmark's host clock. Moves ``train_pairs_per_s`` while the host sets the pace."""


def read(record):
    calls = record.spans.durations("step")
    return 1e3 * sum(calls) / len(calls) if calls else None
