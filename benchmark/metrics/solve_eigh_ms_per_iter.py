"""solve_eigh_ms_per_iter (ms/iter): the polish window's device time in
the port's `lobpcg.eigh` spans (each dense eigensolve: the fp64
Rayleigh-Ritz step's and the two whitenings' an iteration, the card's
idle around their host checks included) over its LOBPCG iterations."""

import program_spans


def read(ctx):
    return program_spans.polish_spans_ms_per_iter(ctx, "lobpcg.eigh")
