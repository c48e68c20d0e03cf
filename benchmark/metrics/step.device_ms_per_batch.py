"""Device ms per batch of the compiled step: the profiler's time of every
kernel launched by a CUDA graph replay in the window, over the replays
(the stats' ``replays``, summed over the calls)."""


def read(ctx):
    tr = ctx["trace"]
    replays = sum(c["stats"]["replays"] for c in ctx["calls"])
    if not tr or not tr["replay_kernel_s"] or not replays:
        return None
    return sum(tr["replay_kernel_s"].values()) * 1e3 / replays
