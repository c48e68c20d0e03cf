"""Seconds of a call's start-up: the program's ``startup`` span, from
``main.run``'s entry until the native scanner exists (chromosome lists,
contig index, resident genome build and upload, scanner creation), mean
over the window's calls."""

SPAN = "startup"


def read(ctx):
    calls = ctx["calls"]
    if not calls or any("spans" not in c["stats"] for c in calls):
        return None
    seconds = [sum(t1 - t0 for name, _, _, t0, t1 in c["stats"]["spans"]
                   if name == SPAN) / 1e9 for c in calls]
    return sum(seconds) / len(seconds)
