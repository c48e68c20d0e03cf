"""Seconds of a call's tail: the program's ``finish`` span, from the return
of the last batch's post until ``main.run`` returns (the finisher's last
encodes, the BGZF writers' last deflates and closes, the scanner's
teardown), mean over the window's calls."""

SPAN = "finish"


def read(ctx):
    calls = ctx["calls"]
    if not calls or any("spans" not in c["stats"] for c in calls):
        return None
    seconds = [sum(t1 - t0 for name, _, _, t0, t1 in c["stats"]["spans"]
                   if name == SPAN) / 1e9 for c in calls]
    return sum(seconds) / len(seconds)
