"""Migration rounds a frame, summed over its bounces (`migration_rounds`
of the distributed frame's stats): each round is one exchange and one
host sync."""


def read(ctx):
    stats = [s for s in ctx.stats if s is not None]
    if not stats:
        return None
    return sum(sum(sum(b) for b in s["migration_rounds"]) for s in stats) / len(stats)
