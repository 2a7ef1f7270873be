"""solve_select_syncs_per_iter (syncs/iter): the host's waits for the
card at the Rayleigh-Ritz step's choice of its well-conditioned
directions (`C[good]`) in the traced polish window (the port's
`sync.select` counter: one an iteration) over its LOBPCG iterations."""

import program_spans


def read(ctx):
    return program_spans.polish_syncs_per_iter(ctx, "select")
