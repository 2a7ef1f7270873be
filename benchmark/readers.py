"""What several metric readers share: a training window's step MFU, its
loss products' roofline share, and a traced window's idle share. Each
metric keeps its own file in `metrics/`, which calls these."""

import yardstick

# The port's hand sparse kernels and the rounding of U to bf16 that feeds
# them: the kernels a product's roofline share sums.
SPMM_PATTERNS = ["rows_kernel", "rows_gram_kernel", "round_kernel",
                 "gram_reduce_kernel", "narrow_kernel", "bsr_spmm_kernel",
                 "band_spmm_kernel", "band_staged_kernel"]


def kinds(ctx) -> tuple:
    """(the loss operator's type, the MLP's type) of the configuration."""
    t = ctx["config"]["train"]
    return ("bf16" if t["loss_mxu_precision"] == "bf16" else "fp32",
            "bf16" if t["mlp_compute_dtype"] == "bfloat16" else "fp32")


def train_step_mfu(ctx):
    """A training step's counted FLOPs of each type over that type's
    published peak, summed, over the window's mean step time, in %."""
    if ctx["job"] != "train":
        return None
    t = ctx["config"]["train"]
    flops = yardstick.train_step_flops(
        ctx["n"], ctx["nnz"], [3, *t["hidden"], t["n_modes"]], *kinds(ctx))
    step_s = ctx["window_s"] / ctx["work"]["steps"]
    return 100.0 * yardstick.least_s(flops) / step_s


def loss_spmm_roofline(ctx):
    """The least time of the training's K U products over the traced time
    of the kernels of SPMM_PATTERNS, in %: per step the loss's product
    and its VJP in the loss operator's type, per job the Rayleigh
    quotients' fp32 product, all at width n_modes on the handed K's
    nonzeros. A fused Gram epilogue is in the kernels' time, not in the
    work."""
    if ctx["job"] != "train":
        return None
    seconds = yardstick.matched_seconds(ctx["kernel_seconds"],
                                        SPMM_PATTERNS, ctx["launches"])
    if seconds is None:
        return None
    n, nnz, k = ctx["n"], ctx["nnz"], ctx["config"]["train"]["n_modes"]
    least = (2 * ctx["work"]["steps"]
             * yardstick.spmm_least_s(nnz, n, k, kinds(ctx)[0])
             + ctx["work"]["jobs"] * yardstick.spmm_least_s(nnz, n, k,
                                                            "fp32"))
    return 100.0 * least / seconds


def idle_share(ctx, job: str):
    """The traced window less the time in which a kernel, copy or set ran
    on the card, over the window, in %; `job` windows only."""
    if ctx["job"] != job or ctx["busy_s"] is None:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
