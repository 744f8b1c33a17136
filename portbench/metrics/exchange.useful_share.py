"""The share of the bytes handed to the mesh's `all_to_all` that carry rows
their receivers use (`exchange_useful_bytes` over `exchange_bytes` of the
distributed frame's stats, over the window): granted paths, valid shadow
rays and their flags."""


def read(ctx):
    stats = [s for s in ctx.stats if s is not None and "exchange_bytes" in s]
    shipped = sum(s["exchange_bytes"] for s in stats)
    if not shipped:
        return None
    return sum(s["exchange_useful_bytes"] for s in stats) / shipped
