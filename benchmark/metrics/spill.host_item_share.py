"""The share of work items that no device bucket takes and the host
finishes exactly: ``host_items / (device_items + host_items)``."""


def read(ctx):
    calls = ctx["calls"]
    host = sum(c["stats"]["host_items"] for c in calls)
    total = host + sum(c["stats"]["device_items"] for c in calls)
    return host / total if total else None
