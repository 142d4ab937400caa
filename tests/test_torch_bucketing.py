"""
The port's aspect bucketing and ManyAR packing (uniception_tpu_torch/data/)
against the JAX package's data/bucketing.py on the CPU: bucket assignment,
portrait canvases, the resize (the JAX package's goes through PIL, the
port's is PIL's fixed-point bicubic in torch), the batchers' emission order,
flush padding and n_valid, pack/extract round trips, and the prefetch ring
on the CPU. Inputs come from numpy.
"""

import numpy as np
import pytest
import torch

from uniception_tpu.data import bucketing as jb
from uniception_tpu_torch.data import bucketing as tb
from uniception_tpu_torch.data.pipeline import prefetch_to_device

SIZES = [(480, 640), (640, 480), (300, 1000), (1000, 300), (512, 512), (100, 320), (720, 1280), (37, 61), (1023, 3273)]


@pytest.mark.parametrize("manyar", [True, False])
def test_assign_bucket_matches_jax(manyar):
    buckets = tb.DUST3R_512_BUCKETS if manyar else tb.with_portrait_buckets(tb.DUST3R_512_BUCKETS)
    for h, w in SIZES:
        assert tb.assign_bucket(h, w, buckets, manyar=manyar) == jb.assign_bucket(h, w, buckets, manyar=manyar)
    with pytest.raises(ValueError):
        tb.assign_bucket(0, 5)
    with pytest.raises(ValueError):  # a portrait canvas in a ManyAR family
        tb.assign_bucket(10, 20, [(512, 384)])


def test_bucket_families_match_jax():
    assert tb.DUST3R_512_BUCKETS == jb.DUST3R_512_BUCKETS and tb.DUST3R_224_BUCKETS == jb.DUST3R_224_BUCKETS
    for family in (tb.DUST3R_512_BUCKETS, tb.DUST3R_224_BUCKETS, ((32, 64), (48, 64), (64, 64))):
        assert tb.with_portrait_buckets(family) == jb.with_portrait_buckets(family)


# (source h, w, bucket, portrait): downscales by 2-6x, upscales, a square canvas and the 160x512 bucket's aspect 3.2
RESIZE_CASES = [
    (600, 800, (384, 512), False), (1023, 3274, (160, 512), False), (256, 819, (160, 512), False),
    (300, 400, (384, 512), False), (2000, 1500, (384, 512), True), (37, 60, (160, 512), False),
    (819, 256, (160, 512), True), (100, 100, (224, 224), True), (1500, 1600, (336, 512), False),
]


@pytest.mark.parametrize("h,w,bucket,portrait", RESIZE_CASES)
def test_resize_to_bucket_matches_jax_pil(h, w, bucket, portrait):
    """Against the JAX function (PIL BICUBIC): the bar is 1 LSB with at most 1% of the pixels off by one; the port
    follows PIL's fixed-point arithmetic, so it measures 0 LSB on every case here."""
    img = np.random.RandomState(h * 7 + w).randint(0, 256, (h, w, 3), np.uint8)
    out, ts = tb.resize_to_bucket(img, bucket, portrait)
    ref, ref_ts = jb.resize_to_bucket(img, bucket, portrait)
    assert out.shape == ref.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(ts, ref_ts)
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    assert diff.max() == 0  # measured: PIL's own integer arithmetic


def test_resize_of_a_smooth_image_matches_pil_exactly():
    "A smooth gradient (no clipping) at aspect 3.2, down by 4x: the fixed-point sums land where PIL's do."
    y, x = np.mgrid[0:640, 0:2048]
    img = np.stack([(x * 255) // 2047, (y * 255) // 639, (x + y) % 256], -1).astype(np.uint8)
    out, _ = tb.resize_to_bucket(img, (160, 512))
    ref, _ = jb.resize_to_bucket(img, (160, 512))
    np.testing.assert_array_equal(out, ref)


def _pairs(n, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        h = rng.randint(40, 120)
        w = int(h * [1.33, 1.52, 1.78, 2.0, 3.2][i % 5])
        if i % 3 == 2:
            h, w = w, h
        yield i, rng.randint(0, 256, (h, w, 3), np.uint8), rng.randint(0, 256, (w, h, 3) if i % 4 == 0 else (h, w, 3),
                                                                      np.uint8)


def _same(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:-1], b[1:-1]):
        np.testing.assert_array_equal(x, y)
    assert a[-1] == b[-1]


@pytest.mark.parametrize("manyar", [True, False])
def test_pair_batcher_matches_jax(manyar):
    "Emission order, canvases, true shapes, keys and the flush's padding with n_valid, batch by batch."
    buckets = ((48, 64), (32, 64), (16, 64))
    buckets = buckets if manyar else tb.with_portrait_buckets(buckets)
    mine, ref = tb.PairBucketedBatcher(3, buckets, manyar=manyar), jb.PairBucketedBatcher(3, buckets, manyar=manyar)
    got, want = [], []
    for key, a, b in _pairs(17):
        got += list(mine.add(a, b, key))
        want += list(ref.add(a, b, key))
    got += list(mine.flush())
    want += list(ref.flush())
    assert len(got) == len(want) and any(m["n_valid"] < 3 for *_, m in got)
    for g, w in zip(got, want):
        _same(g, w)
    for *_, meta in got:  # padded rows carry key None, so a key is never served twice
        assert meta["keys"][meta["n_valid"]:] == [None] * (3 - meta["n_valid"])
    assert sum(m["n_valid"] for *_, m in got) == 17


def test_single_view_batcher_matches_jax():
    mine, ref = tb.BucketedBatcher(2), jb.BucketedBatcher(2)
    got, want = [], []
    for key, a, _ in _pairs(7, seed=1):
        got += list(mine.add(a, key))
        want += list(ref.add(a, key))
    got += list(mine.flush())
    want += list(ref.flush())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_pack_and_extract_round_trip_match_jax():
    rng = np.random.RandomState(3)
    images = [rng.randn(3, 4, 6), rng.randn(3, 6, 4), rng.randn(3, 4, 6)]
    canvas, ts = tb.pack_views(images)
    ref_canvas, ref_ts = jb.pack_views(images)
    np.testing.assert_array_equal(canvas, ref_canvas)
    np.testing.assert_array_equal(ts, ref_ts)
    hwc = np.transpose(canvas, (0, 2, 3, 1))  # an output in the factory's channel-last layout
    for i, (img, view) in enumerate(zip(images, tb.extract_views(torch.from_numpy(hwc), ts))):
        np.testing.assert_array_equal(view, np.transpose(img, (1, 2, 0)))
        np.testing.assert_array_equal(view, jb.extract_view(hwc[i], ts[i]))
    with pytest.raises(ValueError):
        tb.pack_views([rng.randn(3, 4, 6), rng.randn(3, 4, 8)])
    with pytest.raises(ValueError):
        tb.extract_view(hwc[0], np.array([5, 6]))


def test_prefetch_to_device_on_the_cpu():
    "Top-level arrays become tensors, everything else passes through, in order."
    batches = [{"img": np.full((2, 3), i, np.uint8), "rest": (i, np.zeros(1))} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu"))
    assert [b["rest"][0] for b in out] == list(range(5))
    assert all(isinstance(b["img"], torch.Tensor) and int(b["img"][0, 0]) == i for i, b in enumerate(out))
    assert isinstance(out[0]["rest"][1], np.ndarray)
    with pytest.raises(ValueError):
        list(prefetch_to_device(iter(batches), "cpu", buffer_size=0))
