"""The share of the calls' wall in which the main thread waited in
``ptscan_next_batch`` for the producer's next slot: the stats'
``wait_s["next_batch ready@main"]`` (0 where it never blocked) over the
calls' wall."""

KEY = "next_batch ready@main"


def read(ctx):
    calls = ctx["calls"]
    wall = sum(c["wall"] for c in calls)
    if not wall or any("wait_s" not in c["stats"] for c in calls):
        return None
    return sum(c["stats"]["wait_s"].get(KEY, 0.0) for c in calls) / wall
