"""device_idle_share.solve (%): the idle share of the polish cells'
traced window (`readers.idle_share`)."""

import readers


def read(ctx):
    return readers.idle_share(ctx, "polish")
