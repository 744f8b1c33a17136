"""The 95th percentile of every frame's wall time in the window, each
frame ending in a device synchronize: the frame a viewer waits longest
for. Read only where the window completes hundreds of frames."""

import statistics


def read(ctx):
    if len(ctx.frame_ms) < 20:
        return None
    return statistics.quantiles(ctx.frame_ms, n=20, method="inclusive")[18]
