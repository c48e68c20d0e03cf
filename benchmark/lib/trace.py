"""The traced window: ``torch.profiler`` over the calls, reduced to the
numbers the per-layer readers take.

Each call runs under a ``record_function`` span named ``bench.call.<i>``,
so the calls' intervals are in the trace's own clock.  Device activity is
every CUDA event (kernels, copies, sets).  A kernel belongs to a graph
replay when the runtime call that launched it, matched by correlation id,
is a ``cudaGraphLaunch``.
"""

from __future__ import annotations

import contextlib

SPAN = "bench.call."


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


@contextlib.contextmanager
def traced(enabled: bool):
    """A started profiler (CPU and CUDA activity), or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def span(prof, i: int):
    if prof is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"{SPAN}{i}")


def _union(intervals):
    total, cur_s, cur_e = 0, None, None
    merged = []
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
    for s, e in merged:
        total += e - s
    return total, merged


def reduce(prof) -> dict:
    """The window's device activity: ``window_s`` (first call's start to the
    last call's end), ``busy_s`` (union of device activity inside it),
    ``replay_kernel_s`` (seconds of replay-launched kernels by name), and
    ``breakdown``: the top device ops and the idle gaps by where the host
    was."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    calls, device, runtime = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if name.startswith(SPAN):
            if e.device_type() != cuda:  # not its device-side annotation
                calls.append((start, start + dur, int(name[len(SPAN):])))
        elif e.device_type() == cuda:
            device.append((start, start + dur, name, e.correlation_id()))
        elif name.startswith("cudaGraphLaunch") or name.startswith("cudaLaunchKernel"):
            runtime[e.correlation_id()] = name
    if not calls:
        return {}
    calls.sort()
    w0, w1 = calls[0][0], max(c[1] for c in calls)
    inside = [d for d in device if d[1] > w0 and d[0] < w1]
    busy, merged = _union((max(s, w0), min(e, w1)) for s, e, _, _ in inside)

    by_name: dict[str, float] = {}
    replay: dict[str, float] = {}
    for s, e, name, corr in inside:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if runtime.get(corr, "").startswith("cudaGraphLaunch"):
            replay[name] = replay.get(name, 0.0) + (e - s) / 1e9

    gaps = []
    for start, end, i in calls:
        mine = [(s, e) for s, e in merged if s < end and e > start]
        edges = [start] + [x for s, e in mine for x in (s, e)] + [end]
        for k in range(0, len(edges), 2):
            a, b = edges[k], edges[k + 1]
            if b > a:
                where = ("startup" if k == 0 else
                         "finish" if k == len(edges) - 2 else "feed")
                gaps.append((f"call{i}.{where}", (b - a) / 1e9))
    for (_, e0, i), (s1, _, _) in zip(calls, calls[1:]):
        if s1 > e0:
            gaps.append((f"call{i}.between_calls", (s1 - e0) / 1e9))
    kinds: dict[str, float] = {}
    for label, sec in gaps:
        key = "call." + label.split(".", 1)[1]
        kinds[key] = kinds.get(key, 0.0) + sec
    longest = sorted(gaps, key=lambda g: -g[1])
    idle = sorted(kinds.items(), key=lambda g: -g[1])
    idle = (idle + longest)[:10]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "replay_kernel_s": replay,
        "breakdown": {
            "device_ops": [[n[:120], v] for n, v in top],
            "idle_gaps": [[n, s] for n, s in idle],
        },
    }
