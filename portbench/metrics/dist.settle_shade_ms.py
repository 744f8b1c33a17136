"""Device ms a frame of the operations inside the distributed frame's
`settle_shade` range (shading where each path settled; in neural mode the
re-trace at the destination)."""


def read(ctx):
    ms = ctx.trace.stage_ms.get("settle_shade") if ctx.trace else None
    return None if not ms else ms / ctx.trace.frames
