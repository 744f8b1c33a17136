"""Bytes a frame handed to the mesh's `all_to_all` (`exchange_bytes` of the
distributed frame's stats): the migration's handshakes and fixed buckets,
pad rows included, and in exact frames the ring's shadow rays and flags."""


def read(ctx):
    stats = [s for s in ctx.stats if s is not None and "exchange_bytes" in s]
    if not stats:
        return None
    return sum(s["exchange_bytes"] for s in stats) / len(stats)
