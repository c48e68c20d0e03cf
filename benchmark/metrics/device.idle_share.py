"""The share of the traced window in which no operation ran on the card:
1 - (union of the profiler's device activity) / (the window's wall, from
the first call's start to the last call's end)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
