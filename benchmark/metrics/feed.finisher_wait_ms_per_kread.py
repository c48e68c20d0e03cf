"""The wait for room in the finisher's queue, in ms per 1,000 primary
reads: every ``wait_s["drain_fifo fin space@<role>"]`` of the stats (the
producer's drain and the main thread's, after each post) over
``n_primary``."""

SITE = "drain_fifo fin space@"


def read(ctx):
    calls = ctx["calls"]
    reads = sum(c["stats"]["n_primary"] for c in calls)
    if not reads or any("wait_s" not in c["stats"] for c in calls):
        return None
    wait = sum(v for c in calls for k, v in c["stats"]["wait_s"].items()
               if k.startswith(SITE))
    return wait * 1e3 / (reads / 1e3)
