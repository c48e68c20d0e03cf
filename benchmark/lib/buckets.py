"""The program's device buckets as of this benchmark (``DEFAULT_BUCKETS`` in
``portello_tpu_torch/models/pipeline_model.py``), in order: an item takes
the first it fits, and one that fits none is finished on the host.  The
generator records each mix's share per bucket with it, and the kernels'
byte bounds follow from its shapes."""

from collections import namedtuple

Bucket = namedtuple("Bucket", "max_ops max_blocks max_seq max_clusters")

BUCKETS = (
    Bucket(128, 48, 24_576, 96),
    Bucket(256, 96, 24_576, 160),
    Bucket(1_024, 384, 65_536, 512),
)
