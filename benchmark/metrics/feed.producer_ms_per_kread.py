"""The native feed's producer (``ptscan.cc``: BAM decode, prep, slot fill,
drain), in ms per 1,000 primary reads: the sum of ``t_native_read``,
``_prepare``, ``_fill`` and ``_drain`` (reported under
``PTPU_FEED_TIMING=1``, which the traced run sets) over ``n_primary``."""

PHASES = ("read", "prepare", "fill", "drain")


def read(ctx):
    calls = ctx["calls"]
    if not calls or any(f"t_native_{p}" not in c["stats"] for c in calls for p in PHASES):
        return None
    busy = sum(c["stats"][f"t_native_{p}"] for c in calls for p in PHASES)
    return busy * 1e3 / (sum(c["stats"]["n_primary"] for c in calls) / 1e3)
