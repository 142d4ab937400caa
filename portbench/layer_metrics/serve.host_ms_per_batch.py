"""Host milliseconds of each ``serve(...)`` call of the serving loop (the program's normalizer, its copy to the
card and the forward's launches, up to the call's return), averaged over every batch of the measured window, on
the benchmark's host clock. Moves ``pairs_per_s`` while the host sets the pace."""


def read(record):
    calls = record.spans.durations("serve")
    return 1e3 * sum(calls) / len(calls) if calls else None
