"""solve_stop_check_syncs_per_iter (syncs/iter): the host's waits for
the card at the convergence test in the traced polish window (the
port's `sync.stop_check` counter: one every tenth iteration) over its
LOBPCG iterations."""

import program_spans


def read(ctx):
    return program_spans.polish_syncs_per_iter(ctx, "stop_check")
