"""Milliseconds to build the resident genome per GB of it: the program's
``startup.genome_build`` span over the stats' ``genome_bytes`` (the bytes of
the resident table uploaded to each device), mean over the window's calls;
None where the stats lack the counter (a program without it) or a call
built no resident genome (table slots)."""

SPAN = "startup.genome_build"


def read(ctx):
    calls = ctx["calls"]
    if not calls or any(not c["stats"].get("genome_bytes") or "spans" not in c["stats"]
                        for c in calls):
        return None
    per_call = []
    for c in calls:
        ns = sum(t1 - t0 for name, _, _, t0, t1 in c["stats"]["spans"] if name == SPAN)
        per_call.append(ns / 1e6 / (c["stats"]["genome_bytes"] / 1e9))
    return sum(per_call) / len(per_call)
