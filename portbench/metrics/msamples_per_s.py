"""Camera-path samples completed in the window (pixels x spp of every
frame), over the window's seconds, in millions: a user's frames a second
at a fixed quality, whatever the resolution."""


def read(ctx):
    return ctx.frames * ctx.samples_per_frame / ctx.window_s / 1e6
