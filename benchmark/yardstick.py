"""The benchmark's yardstick: the card's published peaks, the least time
of a product, and the operation counts of a training step and of a
LOBPCG iteration. Frozen copies: a change to the program cannot move
them.

`bound` and `least_bytes` are copies of `chip_smoke.py`'s. The training
step's count is `bench.py`'s convention (`phase_large`, `phase_xl`): the
operator's products forward and in the VJP, the MLP forward plus twice
that backward, three k x k Grams and four dots, with the operator's
nonzeros in place of its stored slots. The LOBPCG iteration counts the
textbook iteration's work over the basis S = [X, W, P] of 3k columns:
K X and K S, the Grams S^T K S and S^T M S, the Ritz updates of X and P,
and the 3k x 3k eigensolve.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): HBM
# bytes/s, and FLOP/s of fp32 FFMA, of bf16 tensor-core products and of
# fp64 tensor-core products.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "fp64": 67e12}
VALUE_BYTES = {"fp32": 4, "bf16": 2}


def bound(n_bytes: float, flops: dict) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the HBM rate and its operations ({type:
    count}) over the peak rate of their type; and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[kind] for kind, n in flops.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def least_bytes(nnz: int, value_bytes: int, n: int, k: int,
                gram: bool = False, n_cols: int | None = None) -> int:
    """Least bytes of W = A U (n x n_cols A, n_cols = n by default, with
    nnz nonzeros, U and W fp32 of width k): each nonzero's value and
    4-byte column index and the row pointers read once, U read once, W
    (and the k x k fp32 Gram) written once. Zeros that a kernel's tiles
    hold are not counted."""
    n_cols = n if n_cols is None else n_cols
    return (nnz * (value_bytes + 4) + (n + 1) * 4 + (n + n_cols) * k * 4
            + (k * k * 4 if gram else 0))


def spmm_least_s(nnz: int, n: int, k: int, kind: str) -> float:
    """The least seconds of one product A U, A (n x n, nnz nonzeros)
    stored in `kind` ('fp32' or 'bf16'), U of width k."""
    return bound(least_bytes(nnz, VALUE_BYTES[kind], n, k),
                 {kind: 2.0 * nnz * k})["bound_ms"] / 1e3


def mlp_forward_flops(n: int, dims: list) -> float:
    """FLOPs of one dense MLP forward over n rows with layer widths
    `dims` (input, hidden..., output)."""
    return 2.0 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def train_step_flops(n: int, nnz: int, dims: list, loss_kind: str,
                     mlp_kind: str) -> dict:
    """{type: FLOPs} of one penalty-mode training step over all n rows:
    K U forward and its VJP in the loss operator's type, the MLP forward
    and ~2x backward in the MLP's type, the Grams (forward and backward)
    and the Rayleigh and residual dots in fp32."""
    k = dims[-1]
    flops = {"fp32": 3.0 * (2.0 * n * k * k) + 4.0 * (2.0 * n * k)}
    for kind, count in ((loss_kind, 2 * (2.0 * nnz * k)),
                        (mlp_kind, 3.0 * mlp_forward_flops(n, dims))):
        flops[kind] = flops.get(kind, 0.0) + count
    return flops


def lobpcg_iteration_flops(n: int, nnz: int, k: int) -> dict:
    """{type: FLOPs} of one LOBPCG iteration on a block of k columns
    (fp32, S = [X, W, P] of 3k columns): K X and K S (2 nnz k and
    2 nnz 3k), the Grams S^T K S and S^T M S (2 n (3k)^2 each), the
    updates X = S C and P = S C' (2 n 3k k each), and the generalized
    eigensolve of the 3k x 3k pencil in fp64 (~9 (3k)^3)."""
    return {"fp32": 2.0 * nnz * 4 * k + 2 * 2.0 * n * (3 * k) ** 2
            + 2 * 2.0 * n * 3 * k * k,
            "fp64": 9.0 * (3 * k) ** 3}


def least_s(flops: dict) -> float:
    """Seconds of `flops` ({type: count}) at the peak rate of each type."""
    return sum(count / PEAK_FLOPS[kind] for kind, count in flops.items())


def matched_seconds(kernel_seconds: dict, patterns: list,
                    launches: int) -> float | None:
    """Device seconds of the kernels whose names hold one of `patterns`.
    None when the window ran none of the port's hand kernels; raises
    RuntimeError when it launched some and no kernel of the trace
    matches, so that a renamed kernel fails the traced run instead of
    reading 0."""
    if not kernel_seconds or launches == 0:
        return None
    t = sum(s for name, s in kernel_seconds.items()
            if any(p in name for p in patterns))
    if t == 0:
        raise RuntimeError(f"{launches} hand-kernel launches in the window "
                           f"and no kernel in the trace named {patterns}")
    return t
