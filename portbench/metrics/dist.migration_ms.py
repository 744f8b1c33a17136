"""Device ms a frame of the operations inside the distributed frame's
`migration` range (the migration loop: local traces, routing, exchange)."""


def read(ctx):
    ms = ctx.trace.stage_ms.get("migration") if ctx.trace else None
    return None if not ms else ms / ctx.trace.frames
