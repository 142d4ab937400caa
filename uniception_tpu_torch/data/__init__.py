from uniception_tpu_torch.data.bucketing import (
    DUST3R_224_BUCKETS,
    DUST3R_512_BUCKETS,
    BucketedBatcher,
    PairBucketedBatcher,
    assign_bucket,
    extract_view,
    extract_views,
    pack_views,
    resize_bicubic_u8,
    resize_to_bucket,
    with_portrait_buckets,
)
from uniception_tpu_torch.data.pipeline import prefetch_to_device
