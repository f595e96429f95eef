"""Blocks whose outputs reached the host in the window, over the window's
wall time (first call to the last outputs on the host)."""


def read(ctx):
    w = ctx["window"]
    return w["blocks"] / w["seconds"] if w["seconds"] > 0 else None
