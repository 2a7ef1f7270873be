"""solve_spmm_ms_per_iter (ms/iter): the polish window's device time in
the port's `sparse.spmm` spans (the forward products of the formats with
hand kernels: K X and K S each iteration, a run's closing K X) over its
LOBPCG iterations."""

import program_spans


def read(ctx):
    return program_spans.polish_spans_ms_per_iter(ctx, "sparse.spmm")
