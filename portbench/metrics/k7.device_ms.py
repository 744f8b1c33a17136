"""Device ms a frame of the route kernel K7 (`route_kernel`, launched by
`route_secondary` and `route_shadow`), matched by its CUDA function
name."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.op_ms("route_kernel")
    return ms / ctx.trace.frames if ms > 0.0 else None
