"""The idle-share, roofline and all-batches tail arithmetic on hand-made timelines, and the readers built on it."""

import types

import pytest

from portbench.core.registry import load_module
from portbench.core.spans import Spans
from portbench.core.stats import idle_gaps, percentile_all, roofline_least_s, union_length
from portbench.core.trace import WINDOW_SPAN, summarize
from portbench.tests.tiny_cells import tiny_arch


def test_percentile_takes_every_sample_by_nearest_rank():
    values = list(range(1, 201))  # 200 batches: 10 lie beyond the 95th percentile
    assert percentile_all(values, 95) == 190
    assert percentile_all([5.0], 95) == 5.0
    assert percentile_all([3, 1, 2, 100], 95) == 100  # the slowest of 4 is the tail, no chunk's median hides it
    with pytest.raises(ValueError):
        percentile_all([], 95)


def test_union_and_gaps():
    iv = [(1.0, 2.0), (1.5, 3.0), (4.0, 5.0), (9.0, 12.0)]
    assert union_length(iv, 0.0, 10.0) == pytest.approx(4.0)  # [1, 3], [4, 5], [9, 10]
    assert idle_gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (3.0, 4.0), (5.0, 9.0)]
    assert union_length([], 0.0, 1.0) == 0.0
    assert idle_gaps([(0.0, 1.0)], 0.0, 1.0) == []


def test_roofline_takes_the_larger_bound():
    assert roofline_least_s(989e12, 0, 989e12, 3.35e12) == pytest.approx(1.0)
    assert roofline_least_s(1, 3.35e12 * 2, 989e12, 3.35e12) == pytest.approx(2.0)


def _timeline():
    device = [("k1", 0.10, 0.30), ("k2", 0.25, 0.40), ("memcpy", 0.60, 0.72), ("k1", 0.90, 1.20)]
    host = [(WINDOW_SPAN, 0.0, 1.0), ("serve", 0.0, 0.45), ("sync", 0.45, 0.62), ("serve", 0.62, 0.95)]
    return summarize(device, host, 0.0, 1.0)


def test_summarize_busy_breakdown_and_named_gaps():
    t = _timeline()
    assert t.window_s == pytest.approx(1.0)
    assert t.busy_s == pytest.approx(0.30 + 0.12 + 0.10)  # [0.1, 0.4], [0.6, 0.72], [0.9, 1.0]
    assert t.breakdown["device_ops"][0] == ["k1", pytest.approx(0.30)]
    gaps = t.breakdown["idle_gaps"]
    assert gaps[0] == ["sync", pytest.approx(0.20)] and gaps[1] == ["serve", pytest.approx(0.18)]
    assert gaps[2] == ["serve", pytest.approx(0.10)]
    assert t.device_seconds(("k1",)) == (2, pytest.approx(0.30))


def _record(trace=None, kind="NVIDIA H100 80GB HBM3", traced_units=0, units=160, window_s=10.0, P=16):
    fam = load_module("models", "dust3r")
    arch = tiny_arch("linear")
    spans = Spans(__import__("torch"))
    spans.records = [("serve", 0.0, 0.020), ("sync", 0.020, 0.1), ("serve", 0.1, 0.130)]
    return types.SimpleNamespace(trace=trace, device_kind=kind, traced_units=traced_units, family=fam, arch=arch,
                                 units=units, window_s=window_s, pairs_per_unit=P, spans=spans)


def test_layer_readers():
    read = lambda name, rec: load_module("layer_metrics", name).read(rec)  # noqa: E731
    rec = _record(trace=_timeline())
    assert read("device_idle.serve", rec) == pytest.approx(48.0)
    assert read("serve.host_ms_per_batch", rec) == pytest.approx(25.0)
    flops = rec.family.forward_flops_per_pair(rec.arch) * 160
    assert read("step_mfu.serve", rec) == pytest.approx(100 * flops / (10.0 * 989e12))
    assert read("step_mfu.serve", _record(kind="some other card")) is None
    assert read("device_idle.serve", _record()) is None
    # K1: the trace's launch count must be the configuration's calls times the batches traced
    assert read("k1_roofline.serve", _record(trace=_timeline(), traced_units=1)) is None
    calls = rec.family.attention_calls(rec.arch, 16)
    device = [("void fa_fwd_bf16_kernel<64>", i * 1e-3, i * 1e-3 + 5e-4) for i in range(len(calls))]
    t = summarize(device, [(WINDOW_SPAN, 0.0, 1.0)], 0.0, 1.0)
    share = read("k1_roofline.serve", _record(trace=t, traced_units=1))
    least = sum(roofline_least_s(4 * B * H * Nq * Nk * D, rec.family.attention_bytes((B, H, Nq, Nk, D)),
                                 989e12, 3.35e12) for B, H, Nq, Nk, D in calls)
    assert share == pytest.approx(100 * least / (len(calls) * 5e-4))
