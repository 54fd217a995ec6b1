"""backward+forward(FULL) pairs completed over all of the window, per second
(every pair of every fenced block, from the first dispatch to the last fence)."""


def read(ctx):
    w = ctx.window
    return w["pairs"] / w["seconds"] if w["pairs"] and w["seconds"] > 0 else None
