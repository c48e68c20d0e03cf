"""The share of the two BGZF writers' blocks that the card deflated: the
stats' ``deflate_blocks["card"]`` over ``card + host``, summed over the
calls; None where the stats lack the key (a program without the card's
compressor)."""


def read(ctx):
    calls = ctx["calls"]
    if not calls or any("deflate_blocks" not in c["stats"] for c in calls):
        return None
    card = sum(c["stats"]["deflate_blocks"]["card"] for c in calls)
    total = card + sum(c["stats"]["deflate_blocks"]["host"] for c in calls)
    return card / total if total else None
