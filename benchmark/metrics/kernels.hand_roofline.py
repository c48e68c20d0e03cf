"""The three hand kernels' share of their byte bound (``%``): the bytes that
the window's replays must move through them at 3.35 TB/s
(``benchmark/lib/roofline.py``, per batch from each bucket's shapes) over
their summed profiler time inside those replays.

The bytes are a lower bound: the data-dependent traffic is left out, and
under device-shift routing, where the stats give reverse batches only in
total, they are counted in the primary bucket first, the cheapest."""

from benchmark.lib.roofline import HBM_BYTES_PER_S, KERNELS, batch_bytes


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    seconds = sum(t for name, t in tr["replay_kernel_s"].items()
                  if any(f in name for f in KERNELS.values()))
    if not seconds:
        return None
    nbytes = 0
    for c in ctx["calls"]:
        s = c["stats"]
        rev_left = s["rev_batches"]
        for bucket, n in enumerate(s["batches_per_bucket"]):
            if s["resident"]:
                kinds = {"fwd_resident": n}
            else:
                rev = min(rev_left, n)
                rev_left -= rev
                kinds = {"rev": rev, "fwd": n - rev}
            for kind, count in kinds.items():
                nbytes += count * sum(batch_bytes(kind, bucket, ctx["batch_size"]).values())
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
