"""KiB copied to the device per primary read: bytes per batch times
batches (``h2d_bytes_per_batch``, ``batches_per_bucket``) over
``n_primary``."""


def read(ctx):
    calls = ctx["calls"]
    reads = sum(c["stats"]["n_primary"] for c in calls)
    if not reads:
        return None
    nbytes = sum(c["stats"]["h2d_bytes_per_batch"] * sum(c["stats"]["batches_per_bucket"])
                 for c in calls)
    return nbytes / 1024 / reads
