"""solve_eigh_syncs_per_iter (syncs/iter): the host's waits for the card
at the port's dense eigensolves in the traced polish window (its
`sync.eigh` counter: `torch.linalg.eigh` on CUDA checks its result on
the host; three an iteration and a run's start whitening) over its
LOBPCG iterations."""

import program_spans


def read(ctx):
    return program_spans.polish_syncs_per_iter(ctx, "eigh")
