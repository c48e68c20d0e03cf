"""The native feed's finisher (post, encode, BGZF write), in ms per 1,000
primary reads: ``t_native_finish_enc`` (under ``PTPU_FEED_TIMING=1``) over
``n_primary``."""


def read(ctx):
    calls = ctx["calls"]
    if not calls or any("t_native_finish_enc" not in c["stats"] for c in calls):
        return None
    busy = sum(c["stats"]["t_native_finish_enc"] for c in calls)
    return busy * 1e3 / (sum(c["stats"]["n_primary"] for c in calls) / 1e3)
