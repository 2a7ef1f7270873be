"""solve_lobpcg_rest_ms_per_iter (ms/iter): the polish window's device
time in the port's `lobpcg` spans (one whole eigensolver call each) less
that of the spans directly inside them (its Grams, eigensolves and
sparse products) over its LOBPCG iterations: the iteration's elementwise
kernels, its block rotations and concatenations, and the idle between."""

import program_spans


def read(ctx):
    t, iterations = program_spans.polish_tracer(ctx)
    if t is None:
        return None
    recs = t.records()
    whole = program_spans.device_ms(recs, {"lobpcg"})
    inside = program_spans.device_ms(
        recs, {"lobpcg.gram", "lobpcg.eigh", "sparse.spmm"}, parent="lobpcg")
    if whole is None or inside is None:
        return None
    return (whole - inside) / iterations
