"""Time in the exact host path (``host_lift_item``), in ms per 1,000
primary reads: both entries of the stats' ``host_lift_s`` (``prep``, summed
over the prep threads; ``post``, the main thread's intake of device
fallbacks) over ``n_primary``."""


def read(ctx):
    calls = ctx["calls"]
    reads = sum(c["stats"]["n_primary"] for c in calls)
    if not reads or any("host_lift_s" not in c["stats"] for c in calls):
        return None
    busy = sum(v for c in calls for v in c["stats"]["host_lift_s"].values())
    return busy * 1e3 / (reads / 1e3)
