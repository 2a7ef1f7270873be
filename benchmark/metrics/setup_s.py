"""setup_s: seconds from the port's import to the window's start (the
operator build, a warm job and, for a polish mix, the training that makes
its start); host clock, ending on a synchronise."""


def read(ctx):
    return ctx["setup_s"]
