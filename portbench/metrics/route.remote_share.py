"""The share of the live paths routed from bounce 1 on that the routing
stage settles on another partition (`route_remote` over `route_queries` of
the distributed frame's stats, over the window): K7's route decisions, which
a change that only makes K7 faster leaves as they are."""


def read(ctx):
    stats = [s for s in ctx.stats if s is not None and "route_queries" in s]
    queries = sum(s["route_queries"] for s in stats)
    if not queries:
        return None
    return sum(s["route_remote"] for s in stats) / queries
