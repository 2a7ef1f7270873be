"""solve_host_syncs_per_iter: the host's waits for the card that CUDA's
sync debug mode reports in the traced window, over its LOBPCG
iterations."""


def read(ctx):
    if ctx["job"] != "polish" or ctx["host_syncs"] is None:
        return None
    return ctx["host_syncs"] / ctx["work"]["iterations"]
