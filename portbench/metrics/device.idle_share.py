"""1 minus the union of the device operations' intervals over the traced
window's wall time: how far the host holds the card back."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
