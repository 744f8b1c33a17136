"""Paths shipped between partitions a frame (`paths_moved` of the
distributed frame's stats)."""


def read(ctx):
    stats = [s for s in ctx.stats if s is not None]
    if not stats:
        return None
    return sum(s["paths_moved"] for s in stats) / len(stats)
