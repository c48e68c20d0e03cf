"""The producer's wait on the readahead pool's BGZF inflate, in ms per
1,000 primary reads: the stats' ``wait_s["load_block ra@producer"]`` (0
where it never blocked) over ``n_primary``."""

KEY = "load_block ra@producer"


def read(ctx):
    calls = ctx["calls"]
    reads = sum(c["stats"]["n_primary"] for c in calls)
    if not reads or any("wait_s" not in c["stats"] for c in calls):
        return None
    wait = sum(c["stats"]["wait_s"].get(KEY, 0.0) for c in calls)
    return wait * 1e3 / (reads / 1e3)
