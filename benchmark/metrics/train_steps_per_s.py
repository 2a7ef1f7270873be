"""train_steps_per_s: the training cells' rate: every step
of the window's jobs over the window's wall time (host clock, ending on a
synchronise after the job in flight)."""


def read(ctx):
    if ctx["job"] != "train":
        return None
    return ctx["work"]["steps"] / ctx["window_s"]
