"""Device ms a frame of the operations inside the `neural_route` range
(the secondary rays' routing from bounce 1 on)."""


def read(ctx):
    ms = ctx.trace.stage_ms.get("neural_route") if ctx.trace else None
    return None if not ms else ms / ctx.trace.frames
