"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is `cuda`-marked and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the other files.)
Tolerances: W and the fused Gram rel 1e-5 in fp32 modes (sums in another
order); in 'bf16' rel 2e-3 for the rolling band, whose plain product
keeps the operator's own rounding, and rel 1e-4 for strip-BSR, where the
plain version rounds U exactly as the kernels do. The full-window band
(K4, K5): W rel 1e-5, G rel 2e-5 and the gradient through the fused Gram
rel 1e-4, with an fp32 or a bf16 band (the plain version rounds U as the
kernels do).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sparse import banded as tbanded
from eigenpinns_torch.sparse import bsr as tbsr
from eigenpinns_torch.sparse import rolling as trolling
from eigenpinns_torch.utils.fixtures import adversarial_rolling_matrix


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def _check_rolling(op, U, tol):
    """K1 on one operator: W and G vs the plain version, one launch
    counted per call, W the same bits from both column blocks, with and
    without the Gram and from a second launch, G from a second launch."""
    before = trolling.rolling_kernel_launches
    W, G = tsparse.rolling_spmm_cuda(op, U, with_gram=True)
    torch.cuda.synchronize()
    assert trolling.rolling_kernel_launches == before + 1
    Wp, Gp = tsparse.rolling_spmm_gram_plain(op, U)
    assert _rel(W.cpu(), Wp.cpu()) < tol
    assert _rel(G.cpu(), Gp.cpu()) < tol
    for cb in (32, 64):
        assert torch.equal(tsparse.rolling_spmm_cuda(op, U, col_block=cb), W)
        W2, G2 = tsparse.rolling_spmm_cuda(op, U, with_gram=True,
                                           col_block=cb)
        assert torch.equal(W2, W)
        assert _rel(G2.cpu(), Gp.cpu()) < tol
    assert torch.equal(tsparse.rolling_spmm_cuda(op, U, with_gram=True)[1], G)
    return W, G, Wp


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("k", [10, 39])
def test_rolling_cuda_kernel_matches_plain(precision, k):
    """K1 vs plain version on a 500-point cloud Laplacian, and the
    gradient through the fused Gram."""
    _need_card()
    r2 = np.random.default_rng(7)
    X = r2.normal(size=(500, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    A = point_cloud_laplacian(X, n_neighbors=12)[0]
    op, _ = tsparse.RollingBanded.from_scipy(A, device="cuda")
    op = op.with_precision(precision)
    U = torch.from_numpy(np.random.default_rng(4).normal(
        size=(op.n, k)).astype(np.float32)).cuda()
    tol = 2e-3 if precision == "bf16" else 1e-5
    _, _, Wp = _check_rolling(op, U, tol)
    gen = torch.Generator("cuda").manual_seed(k)
    gW = torch.randn((op.n, k), generator=gen, device="cuda")
    gG = torch.randn((k, k), generator=gen, device="cuda")
    Uk = U.clone().requires_grad_(True)
    Wk, Gk = tsparse.rolling_spmm_gram(op, Uk)
    ((Wk * gW).sum() + (Gk * gG).sum()).backward()
    ref = tsparse.rolling_spmm_plain(op, gW + U @ gG) + Wp @ gG.T
    assert _rel(Uk.grad.cpu(), ref.cpu()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("k", [20, 60])
def test_rolling_cuda_kernel_adversarial(precision, k):
    """K1 on the adversarial operator (a tile whose only nonzero sits on
    bit 63, windows that start before row 0 and end past n, a ragged last
    tile) and on its stored transpose, also against the dense product."""
    _need_card()
    A = adversarial_rolling_matrix()
    op, _ = tsparse.RollingBanded.from_scipy(A, device="cuda", reorder=False)
    assert sorted(op.occupancy[1].tolist()) == [-2**63] + [0] * 5
    op = op.with_precision(precision)
    U = torch.from_numpy(np.random.default_rng(k).normal(
        size=(op.n, k)).astype(np.float32)).cuda()
    Ur = U.bfloat16().float() if precision == "bf16" else U
    tol = 2e-3 if precision == "bf16" else 1e-5
    for o, dense in ((op, A.toarray()), (op.transpose_rolling, A.T.toarray())):
        W, _, _ = _check_rolling(o, U, tol)
        D = torch.as_tensor(dense, dtype=torch.float32, device="cuda")
        assert _rel(W.cpu(), (D.to(o.band.dtype).float() @ Ur).cpu()) < 1e-5


def _asym800():
    """The asymmetric n=800 operator of tests/test_sparse.py:812-817."""
    r = np.random.default_rng(9)
    n = 800
    rows = r.integers(0, n, 4 * n)
    cols = np.clip(rows + r.integers(-90, 90, 4 * n), 0, n - 1)
    return sp.coo_matrix((r.normal(size=4 * n), (rows, cols)),
                         shape=(n, n)).tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("k", [5, 40])
def test_bsr_cuda_kernels_match_plain(precision, k):
    """K2 and K3 vs the plain version (rel 1e-5; 1e-4 in 'bf16'), and the
    gradient through the dispatcher (A^T from the stored transpose)."""
    _need_card()
    op, _ = tbsr.BSRTile.from_scipy(_asym800(), device="cuda")
    op = op.with_precision(precision)
    burst = dataclasses.replace(op, gcid=None, lcid=None, gid=None)
    U = torch.from_numpy(np.random.default_rng(4).normal(
        size=(op.n, k)).astype(np.float32)).cuda()
    tol = 1e-4 if precision == "bf16" else 1e-5
    Wp = tbsr.bsr_spmm_plain(op, U)
    before = dict(tbsr.bsr_kernel_launches)
    Wg = tbsr.bsr_spmm_grouped_cuda(op, U)
    Wb = tbsr.bsr_spmm_burst_cuda(burst, U)
    torch.cuda.synchronize()
    assert tbsr.bsr_kernel_launches == {
        "grouped": before["grouped"] + 1, "burst": before["burst"] + 1}
    assert _rel(Wg.cpu(), Wp.cpu()) < tol
    assert _rel(Wb.cpu(), Wp.cpu()) < tol
    # One summation order whatever the kernel and its column block.
    for cb in (32, 64):
        assert torch.equal(tbsr.bsr_spmm_grouped_cuda(op, U, col_block=cb),
                           Wg)
        assert torch.equal(tbsr.bsr_spmm_burst_cuda(burst, U, col_block=cb),
                           Wg)
    g = torch.randn_like(U)
    Ut = U.clone().requires_grad_(True)
    (tbsr.bsr_spmm(op, Ut) * g).sum().backward()
    ref = tbsr.bsr_spmm_plain(op.transpose_bsr, g)
    assert _rel(Ut.grad.cpu(), ref.cpu()) < tol


def _banded_op(case, dtype):
    if case == "cloud":
        X = np.random.default_rng(7).normal(size=(700, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        A = point_cloud_laplacian(X, n_neighbors=12)[0]
        return tsparse.SplitBanded.from_scipy(A, X=X, window=256,
                                              order="hilbert", dtype=dtype,
                                              device="cuda")[0].core
    return tbanded.BandedELL.from_scipy(_asym800(), dtype=dtype,
                                        reorder=False, device="cuda")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [5, 40])
@pytest.mark.parametrize("case", ["cloud", "asym800"])
def test_banded_cuda_kernels_match_plain(case, k, dtype):
    """K4 and K5 vs the plain version: a split core whose windows reach
    past n, and a nonsymmetric band whose gradient applies the stored
    transpose."""
    _need_card()
    op = _banded_op(case, dtype)
    gen = torch.Generator("cuda").manual_seed(k)
    U = torch.randn((op.n, k), generator=gen, device="cuda")
    gW = torch.randn((op.n, k), generator=gen, device="cuda")
    gG = torch.randn((k, k), generator=gen, device="cuda")
    before = dict(tbanded.banded_kernel_launches)
    W = tbanded.banded_spmm_cuda(op, U)
    W2, G = tbanded.banded_spmm_cuda(op, U, with_gram=True)
    torch.cuda.synchronize()
    assert tbanded.banded_kernel_launches == {
        "spmm": before["spmm"] + 1, "spmm_gram": before["spmm_gram"] + 1}
    Wp, Gp = tbanded.banded_spmm_gram_plain(op, U)
    assert torch.equal(W, W2)
    for cb in (32, 64):
        assert torch.equal(tbanded.banded_spmm_cuda(op, U, col_block=cb), W)
        W3, G3 = tbanded.banded_spmm_cuda(op, U, with_gram=True,
                                          col_block=cb)
        assert torch.equal(W3, W)
        assert _rel(G3.cpu(), Gp.cpu()) < 2e-5
    assert torch.equal(tbanded.banded_spmm_cuda(op, U, with_gram=True)[1], G)
    assert _rel(W.cpu(), Wp.cpu()) < 1e-5
    assert _rel(G.cpu(), Gp.cpu()) < 2e-5
    Uk = U.clone().requires_grad_(True)
    Wk, Gk = tbanded.banded_spmm_gram(op, Uk)
    ((Wk * gW).sum() + (Gk * gG).sum()).backward()
    At = op.transpose_banded if op.transpose_banded is not None else op
    ref = tbanded.banded_spmm_plain(At, gW + U @ gG) + Wp @ gG.T
    assert _rel(Uk.grad.cpu(), ref.cpu()) < 1e-4
