"""train_step_mfu (%): the training cells' step MFU
(`readers.train_step_mfu`: bench.py's step convention on nonzeros)."""

import readers


def read(ctx):
    return readers.train_step_mfu(ctx)
