"""solve_s: the window's wall time over the eigensolver runs it completed
(host clock, ending on a synchronise after the run in flight)."""


def read(ctx):
    if ctx["job"] != "polish":
        return None
    return ctx["window_s"] / ctx["work"]["jobs"]
