"""solve_iter_mfu (%): one LOBPCG iteration's counted FLOPs
(`yardstick.lobpcg_iteration_flops` on the guarded block) of each type
over that type's published peak, summed, over the traced window's mean
iteration time."""

import yardstick


def read(ctx):
    if ctx["job"] != "polish" or not ctx["work"]["iterations"]:
        return None
    c = ctx["config"]
    block = c["train"]["n_modes"] + c["polish"]["guard"]
    flops = yardstick.lobpcg_iteration_flops(ctx["n"], ctx["nnz"], block)
    iter_s = ctx["window_s"] / ctx["work"]["iterations"]
    return 100.0 * yardstick.least_s(flops) / iter_s
