"""The finisher's wait for room in the BGZF writer's deflate queue, in ms
per 1,000 primary reads: the stats' ``wait_s["writer_submit
space@finisher"]`` (0 where it never blocked) over ``n_primary``."""

KEY = "writer_submit space@finisher"


def read(ctx):
    calls = ctx["calls"]
    reads = sum(c["stats"]["n_primary"] for c in calls)
    if not reads or any("wait_s" not in c["stats"] for c in calls):
        return None
    wait = sum(c["stats"]["wait_s"].get(KEY, 0.0) for c in calls)
    return wait * 1e3 / (reads / 1e3)
