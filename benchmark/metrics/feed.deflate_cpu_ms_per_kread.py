"""CPU time of the BGZF writers' deflate pools, in ms per 1,000 primary
reads: the stats' ``cpu_s["deflate"]`` (each pool thread's own CPU clock,
read as it ends) over ``n_primary``."""


def read(ctx):
    calls = ctx["calls"]
    reads = sum(c["stats"]["n_primary"] for c in calls)
    if not reads or any("deflate" not in c["stats"].get("cpu_s", {}) for c in calls):
        return None
    cpu = sum(c["stats"]["cpu_s"]["deflate"] for c in calls)
    return cpu * 1e3 / (reads / 1e3)
