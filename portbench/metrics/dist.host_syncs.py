"""Places a frame made the host wait for the card (`host_syncs` of the
distributed frame's stats): reads of device values, blocking copies to the
card, host-staged collectives."""


def read(ctx):
    stats = [s for s in ctx.stats if s is not None and "host_syncs" in s]
    if not stats:
        return None
    return sum(s["host_syncs"] for s in stats) / len(stats)
