"""The resident genome's upload against its bound: the stats' ``genome_bytes``
over the program's ``startup.genome_upload`` span (which ends with the
device synchronised), as a share of 64 GB/s, the H100 SXM's PCIe 5.0 x16 peak
in one direction; mean over the window's calls.  None where the stats lack
the counter (a program without it), a call uploaded no resident genome
(table slots) or its span took no time."""

SPAN = "startup.genome_upload"
LINK_BYTES_PER_S = 64e9


def read(ctx):
    calls = ctx["calls"]
    if not calls or any(not c["stats"].get("genome_bytes") or "spans" not in c["stats"]
                        for c in calls):
        return None
    per_call = []
    for c in calls:
        ns = sum(t1 - t0 for name, _, _, t0, t1 in c["stats"]["spans"] if name == SPAN)
        if ns <= 0:
            return None
        per_call.append(c["stats"]["genome_bytes"] / (ns / 1e9) / LINK_BYTES_PER_S)
    return sum(per_call) / len(per_call)
