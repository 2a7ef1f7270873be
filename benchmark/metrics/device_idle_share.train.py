"""device_idle_share.train (%): the idle share of the training cells'
traced window (`readers.idle_share`)."""

import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
