"""The share of the calls' wall time in which the feed dispatched batches
or waited on their results: the stats' ``t_dev`` over the calls' wall."""


def read(ctx):
    calls = ctx["calls"]
    wall = sum(c["wall"] for c in calls)
    return sum(c["stats"]["t_dev"] for c in calls) / wall if wall else None
