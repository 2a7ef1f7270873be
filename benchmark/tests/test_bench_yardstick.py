"""The yardstick's counts against hand counts."""

import pytest

import yardstick


def test_least_bytes_by_hand():
    # 10 nonzeros fp32 (4 + 4 bytes), 5 row pointers + 1, U and W 4 x 2.
    assert yardstick.least_bytes(10, 4, 4, 2) == 80 + 20 + 64
    assert yardstick.least_bytes(10, 2, 4, 2, gram=True) == 60 + 20 + 64 + 16
    assert yardstick.least_bytes(10, 4, 4, 2, n_cols=6) == 80 + 20 + 80


def test_bound_picks_the_larger():
    b = yardstick.bound(3.35e12, {"fp32": 67e12})
    assert b == {"bound_ms": 1e3, "bound_by": "bytes"}
    b = yardstick.bound(1.0, {"fp32": 2 * 67e12, "bf16": 989e12})
    assert b["bound_ms"] == pytest.approx(3e3) and b["bound_by"] == "operations"


def test_spmm_least_s():
    nnz, n, k = 7_000_000, 1_000_000, 20
    want = (nnz * 6 + (n + 1) * 4 + 2 * n * k * 4) / 3.35e12
    assert yardstick.spmm_least_s(nnz, n, k, "bf16") == pytest.approx(want)


def test_train_step_flops_by_hand():
    # dims 3 -> 4 -> 2 over 10 rows: forward 2 * 10 * (12 + 8) = 400.
    f = yardstick.train_step_flops(10, 30, [3, 4, 2], "bf16", "bf16")
    assert f["bf16"] == 3 * 400 + 2 * 2 * 30 * 2
    assert f["fp32"] == 3 * 2 * 10 * 4 + 4 * 2 * 10 * 2
    g = yardstick.train_step_flops(10, 30, [3, 4, 2], "fp32", "bf16")
    assert g["bf16"] == 1200 and g["fp32"] == f["fp32"] + 240


def test_lobpcg_iteration_flops_by_hand():
    n, nnz, k = 100, 700, 2
    f = yardstick.lobpcg_iteration_flops(n, nnz, k)
    # K X + K S, the two 3k x 3k Grams, the two n x 3k by 3k x k updates.
    assert f["fp32"] == 2 * 700 * 2 + 2 * 700 * 6 + 2 * 2 * 100 * 36 + \
        2 * 2 * 100 * 6 * 2
    assert f["fp64"] == 9 * 6 ** 3


def test_matched_seconds():
    kernels = {"void nz::rows_kernel<float>(...)": 0.5, "gemm": 2.0}
    assert yardstick.matched_seconds(kernels, ["rows_kernel"], 3) == 0.5
    assert yardstick.matched_seconds(kernels, ["rows_kernel"], 0) is None
    assert yardstick.matched_seconds(None, ["rows_kernel"], 3) is None
    with pytest.raises(RuntimeError):
        yardstick.matched_seconds(kernels, ["bsr_spmm_kernel"], 3)
