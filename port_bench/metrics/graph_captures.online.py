"""Solve graphs captured inside the window (ICPEngine.graph_captures)."""


def read(ctx):
    return float(ctx.graph_captures)
