"""Rows per lockstep detect wave: the mean rows of the window's
detect_many calls."""


def read(ctx):
    rows = ctx["layer"].get("detect_rows")
    return sum(rows) / len(rows) if rows else None
