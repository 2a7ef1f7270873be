"""loss_spmm_roofline (%): the training cells' loss products
over their kernels' traced time (`readers.loss_spmm_roofline`; the
kernel-name patterns are `readers.SPMM_PATTERNS`)."""

import readers


def read(ctx):
    return readers.loss_spmm_roofline(ctx)
