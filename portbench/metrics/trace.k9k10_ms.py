"""Device ms a frame of the grouped trace kernels K9 and K10
(`grouped_closest_kernel`, `grouped_anyhit_kernel`)."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.op_ms("grouped_closest_kernel", "grouped_anyhit_kernel")
    return ms / ctx.trace.frames if ms > 0.0 else None
