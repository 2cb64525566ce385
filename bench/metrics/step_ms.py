"""The window's wall time over the steps it completed, each ending in a
device synchronize: all the time of all the steps."""


def read(ctx):
    w = ctx.window
    return w["seconds"] / w["steps"] * 1e3 if w and w["steps"] else None
