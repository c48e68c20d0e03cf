"""Seconds of CUDA graph warm-up and capture per call: the program's
``t_capture`` (``models/compiled.StepCache.stats``), mean over the window's
calls."""


def read(ctx):
    calls = ctx["calls"]
    if not calls:
        return None
    return sum(c["stats"]["t_capture"] for c in calls) / len(calls)
