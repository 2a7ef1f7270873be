"""solve_gram_ms_per_iter (ms/iter): the polish window's device time in
the port's `lobpcg.gram` spans (each k x k Gram of the eigensolver with
its sum over the rows' shards: 8 at k and 1 at 3k an iteration) over its
LOBPCG iterations."""

import program_spans


def read(ctx):
    return program_spans.polish_spans_ms_per_iter(ctx, "lobpcg.gram")
