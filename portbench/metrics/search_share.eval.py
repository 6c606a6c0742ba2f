"""The lockstep search's share of the window (%): the union of the
search phases' spans (run_grouped_searches, each ending with its results
on the host) over the window."""


def read(ctx):
    lay = ctx["layer"]
    if not lay.get("window_s"):
        return None
    return 100.0 * lay["search_s"] / lay["window_s"]
