"""solve_spmm_roofline (%): the least time of the polish's K products over
the traced time of the kernels of `readers.SPMM_PATTERNS`: each LOBPCG
iteration's K X (the guarded block, k = n_modes + guard) and K S (3k),
and each run's closing K X, in fp32 at `yardstick.spmm_least_s` on the
handed K's nonzeros."""

import readers
import yardstick


def read(ctx):
    if ctx["job"] != "polish":
        return None
    seconds = yardstick.matched_seconds(ctx["kernel_seconds"],
                                        readers.SPMM_PATTERNS,
                                        ctx["launches"])
    if seconds is None:
        return None
    c = ctx["config"]
    k = c["train"]["n_modes"] + c["polish"]["guard"]
    n, nnz, w = ctx["n"], ctx["nnz"], ctx["work"]
    least = (w["iterations"] * (yardstick.spmm_least_s(nnz, n, k, "fp32")
                                + yardstick.spmm_least_s(nnz, n, 3 * k,
                                                         "fp32"))
             + w["jobs"] * yardstick.spmm_least_s(nnz, n, k, "fp32"))
    return 100.0 * least / seconds
