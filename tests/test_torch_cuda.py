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
kernels do). The bf16 row-wise route (bf16 strips, a bf16 band): rel 1e-4
of the plain version, which rounds U as the kernel does; its bits are
its own, not the tensor-core walk's. A bf16 rolling band on that route
(and with its Gram, from the unrounded U) is held to the same 1e-4, as
is a bf16 full-window band's (K5), whose W is K4's row-wise W bit for
bit; the row-wise route's Gram on an fp32 band, rolling or full window,
gives the walk's W and G bit for bit, as the shard blocks' row-wise
route gives the staged route's W.
"""

import dataclasses
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sparse import banded as tbanded
from eigenpinns_torch.sparse import bsr as tbsr
from eigenpinns_torch.sparse import rolling as trolling
from eigenpinns_torch.sparse.occupancy import band_grid, sm_count
from eigenpinns_torch.utils.fixtures import adversarial_rolling_matrix


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def _check_rolling(op, U, tol):
    """K1 on one operator: W and G vs the plain version, one launch
    counted per call, W the same bits from both column blocks (the
    walk's; on a bf16 band the row-wise route, where it is the default,
    sums in another order), with and without the Gram and from a second
    launch, G from a second launch."""
    before = trolling.rolling_kernel_launches
    W, G = tsparse.rolling_spmm_cuda(op, U, with_gram=True)
    torch.cuda.synchronize()
    assert trolling.rolling_kernel_launches == before + 1
    Wp, Gp = tsparse.rolling_spmm_gram_plain(op, U)
    assert _rel(W.cpu(), Wp.cpu()) < tol
    assert _rel(G.cpu(), Gp.cpu()) < tol
    Wn = tsparse.rolling_spmm_cuda(op, U)
    if op.band.dtype == torch.float32:
        assert torch.equal(Wn, W)
        Wb = W
    else:   # with and without the Gram the default routes may differ
        assert _rel(Wn.cpu(), W.cpu()) < 1e-4
        Wb = tsparse.rolling_spmm_cuda(op, U, route="walk")
    for cb in (32, 64):
        assert torch.equal(tsparse.rolling_spmm_cuda(op, U, col_block=cb),
                           Wb)
        W2, G2 = tsparse.rolling_spmm_cuda(op, U, with_gram=True,
                                           col_block=cb)
        assert torch.equal(W2, Wb)
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
@pytest.mark.parametrize("k", [1, 5, 40])
def test_bsr_cuda_kernels_match_plain(precision, k):
    """K2 and K3 vs the plain version (rel 1e-5; 1e-4 in 'bf16'), and the
    gradient through the dispatcher (A^T from the stored transpose); k = 1
    is the width of the Dirichlet CG's products."""
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
    route = tbsr.strip_route(op.data.dtype, k)
    bf16 = op.data.dtype == torch.bfloat16
    assert tbsr.bsr_kernel_launches == {
        "grouped": before["grouped"] + 1, "burst": before["burst"] + 1,
        "narrow": before["narrow"] + 2 * (route == "narrow"),
        "rows": before["rows"] + 2 * (route == "rows" and not bf16),
        "rows_bf16": before["rows_bf16"] + 2 * (route == "rows" and bf16)}
    assert _rel(Wg.cpu(), Wp.cpu()) < tol
    assert _rel(Wb.cpu(), Wp.cpu()) < tol
    assert torch.equal(Wb, Wg)
    # One summation order whatever the kernel and its column block (on
    # bf16 strips the walk's tensor-core order, which the row-wise route
    # does not keep).
    Ww = tbsr.bsr_spmm_grouped_cuda(op, U, route="walk") if bf16 else Wg
    for cb in (32, 64):
        assert torch.equal(tbsr.bsr_spmm_grouped_cuda(op, U, col_block=cb),
                           Ww)
        assert torch.equal(tbsr.bsr_spmm_burst_cuda(burst, U, col_block=cb),
                           Ww)
    g = torch.randn_like(U)
    Ut = U.clone().requires_grad_(True)
    (tbsr.bsr_spmm(op, Ut) * g).sum().backward()
    ref = tbsr.bsr_spmm_plain(op.transpose_bsr, g)
    assert _rel(Ut.grad.cpu(), ref.cpu()) < tol


def _cloud_bsr(n_points, seed=3):
    """The RCM strip-BSR K of an n-point cloud Laplacian on the card."""
    X = np.random.default_rng(seed).normal(size=(n_points, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return tbsr.BSRTile.from_scipy(
        point_cloud_laplacian(X, n_neighbors=15)[0], device="cuda")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("case", ["cloud", "asym800"])
def test_bsr_cuda_narrow_path_matches_the_walk(case, k, precision):
    """The narrow path (fp32 strips, k <= NARROW_MAX_K): both wrappers
    take it by default (one narrow launch counted each), W within rel
    1e-5 of the plain version, the same bits as the column-block walk
    (col_block 32 and 64) and from a second launch."""
    _need_card()
    op = (_cloud_bsr(6000) if case == "cloud" else
          tbsr.BSRTile.from_scipy(_asym800(), device="cuda")[0])
    op = op.with_precision(precision)
    burst = dataclasses.replace(op, gcid=None, lcid=None, gid=None)
    U = torch.from_numpy(np.random.default_rng(k).normal(
        size=(op.n, k)).astype(np.float32)).cuda()
    before = tbsr.bsr_kernel_launches["narrow"]
    Wg = tbsr.bsr_spmm_grouped_cuda(op, U)
    Wb = tbsr.bsr_spmm_burst_cuda(burst, U)
    torch.cuda.synchronize()
    assert tbsr.bsr_kernel_launches["narrow"] == before + 2
    assert _rel(Wg.cpu(), tbsr.bsr_spmm_plain(op, U).cpu()) < 1e-5
    assert torch.equal(Wb, Wg)
    assert torch.equal(tbsr.bsr_spmm_grouped_cuda(op, U), Wg)
    for cb in (32, 64):
        assert torch.equal(tbsr.bsr_spmm_grouped_cuda(op, U, col_block=cb),
                           Wg)
        assert torch.equal(tbsr.bsr_spmm_burst_cuda(burst, U, col_block=cb),
                           Wg)
    assert tbsr.bsr_kernel_launches["narrow"] == before + 3
    with pytest.raises(ValueError, match="narrow table"):
        tbsr.bsr_spmm_grouped_cuda(dataclasses.replace(op, narrow=None), U)


@pytest.mark.cuda
def test_bsr_cuda_narrow_path_gradient():
    """The gradient through the dispatcher at k = 1 (the Dirichlet CG's
    width): A^T from the stored transpose's own narrow table, vs the
    plain version (rel 1e-5), the same bits as the walk on the
    transpose."""
    _need_card()
    op, _ = tbsr.BSRTile.from_scipy(_asym800(), device="cuda")
    gen = torch.Generator("cuda").manual_seed(1)
    U = torch.randn((op.n, 1), generator=gen, device="cuda")
    g = torch.randn((op.n, 1), generator=gen, device="cuda")
    before = tbsr.bsr_kernel_launches["narrow"]
    Ut = U.clone().requires_grad_(True)
    (tbsr.bsr_spmm(op, Ut) * g).sum().backward()
    torch.cuda.synchronize()
    assert tbsr.bsr_kernel_launches["narrow"] == before + 2
    At = op.transpose_bsr
    assert _rel(Ut.grad.cpu(), tbsr.bsr_spmm_plain(At, g).cpu()) < 1e-5
    assert torch.equal(Ut.grad,
                       tbsr.bsr_spmm_grouped_cuda(At, g, col_block=32))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_bsr_cuda_small_operator_grid(precision):
    """An operator of 35 row tiles at k = 64 (CLI run B's K_blk has as
    many): the walk's default grid takes fewer stripes a block than 8
    on a card of 132 SMs, and every grid (8, 4 or 2 warps a block, both
    column blocks) gives the 8-warp grid's bits, within rel 1e-5 of the
    plain version (1e-4 in 'bf16')."""
    _need_card()
    op = _cloud_bsr(4480).with_precision(precision)
    assert op.n_row_tiles == 35
    U = torch.from_numpy(np.random.default_rng(6).normal(
        size=(op.n, 64)).astype(np.float32)).cuda()
    if torch.cuda.get_device_properties(0).multi_processor_count >= 72:
        assert tbsr.walk_grid(op, 64) == (32, 2)
    W8 = tbsr.bsr_spmm_grouped_cuda(op, U, warps=8, route="walk")
    tol = 1e-4 if precision == "bf16" else 1e-5
    Wp = tbsr.bsr_spmm_plain(op, U)
    assert _rel(W8.cpu(), Wp.cpu()) < tol
    # The default route (the row-wise one at k = 64) has the walk's bits
    # on fp32 strips; on bf16 strips it sums in another order.
    Wd = tbsr.bsr_spmm_grouped_cuda(op, U)
    torch.cuda.synchronize()
    if precision == "bf16":
        assert _rel(Wd.cpu(), Wp.cpu()) < tol
    else:
        assert torch.equal(Wd, W8)
    burst = dataclasses.replace(op, gcid=None, lcid=None, gid=None)
    for warps in (8, 4, 2):
        for col_block in (32, 64):
            assert torch.equal(tbsr.bsr_spmm_grouped_cuda(
                op, U, col_block=col_block, warps=warps), W8)
            assert torch.equal(tbsr.bsr_spmm_burst_cuda(
                burst, U, col_block=col_block, warps=warps), W8)


def _wide_strip_matrix(n_rt=2100, per_row=64):
    """A nonsymmetric matrix of n_rt row tiles, each with `per_row`
    nonempty 128 x 128 tiles (column tiles r + 33 j mod n_rt, distinct):
    8 chunks of 8 tiles a row tile, so the strips hold n_rt * 8 chunks of
    128 x 1024 values, 2.2e9 at 2100 row tiles: past 2^31 elements (8.8
    GB in fp32, 4.4 GB in bf16), as a 1M-point cloud's K nearly is. One
    random entry per tile, plus the diagonal."""
    n = 128 * n_rt
    r = np.random.default_rng(11)
    rt = np.repeat(np.arange(n_rt), per_row)
    ct = (rt + 33 * np.tile(np.arange(per_row), n_rt)) % n_rt
    rows = np.concatenate([rt * 128 + r.integers(0, 128, rt.size),
                           np.arange(n)])
    cols = np.concatenate([ct * 128 + r.integers(0, 128, rt.size),
                           np.arange(n)])
    return sp.coo_matrix((r.normal(size=rows.size), (rows, cols)),
                         shape=(n, n)).tocsr()


@pytest.fixture(scope="module")
def wide_bsr():
    _need_card()
    A = _wide_strip_matrix()
    op, _ = tbsr.BSRTile.from_scipy(A, device="cuda", reorder=False,
                                    with_transpose=False)
    return A, op


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_bsr_cuda_kernels_past_2_31_elements(wide_bsr, precision):
    """K2 and K3 on strips of more than 2^31 elements (and bytes): the
    data offsets are 64-bit. W vs the plain version (rel 1e-5; 1e-4 in
    'bf16') on the default route and the walk and, in fp32, vs scipy's
    product in float64 (rel 1e-5); the same bits from both kernels."""
    A, op = wide_bsr
    assert op.data.numel() > 2**31 and op.n_chunks == 8 * op.n_row_tiles
    op = op.with_precision(precision)
    assert op.data.nbytes > 2**31
    burst = dataclasses.replace(op, gcid=None, lcid=None, gid=None)
    U_np = np.random.default_rng(5).normal(size=(op.n, 20))
    U = torch.from_numpy(U_np.astype(np.float32)).cuda()
    tol = 1e-4 if precision == "bf16" else 1e-5
    Wg = tbsr.bsr_spmm_grouped_cuda(op, U)
    Wb = tbsr.bsr_spmm_burst_cuda(burst, U)
    Wp = tbsr.bsr_spmm_plain(op, U)
    torch.cuda.synchronize()
    assert torch.equal(Wg, Wb)
    # The walk (the strips take the row-wise route by default): its bits
    # in fp32, within the tolerance of the plain version in 'bf16'.
    Ww = tbsr.bsr_spmm_grouped_cuda(op, U, col_block=32)
    torch.cuda.synchronize()
    assert torch.equal(tbsr.bsr_spmm_burst_cuda(burst, U, col_block=32), Ww)
    if precision == "highest":
        assert torch.equal(Ww, Wg)
    assert _rel(Ww.cpu(), Wp.cpu()) < tol
    assert _rel(Wg.cpu(), Wp.cpu()) < tol
    if precision == "highest":
        assert _rel(Wg.cpu(), A @ U_np.astype(np.float32)) < tol


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
    transpose; each launch counted, by route (K4's and K5's row-wise
    launches apart)."""
    _need_card()
    op = _banded_op(case, dtype)
    gen = torch.Generator("cuda").manual_seed(k)
    U = torch.randn((op.n, k), generator=gen, device="cuda")
    gW = torch.randn((op.n, k), generator=gen, device="cuda")
    gG = torch.randn((k, k), generator=gen, device="cuda")
    before = dict(tbanded.banded_kernel_launches)
    Wd = tbanded.banded_spmm_cuda(op, U)
    W2, G = tbanded.banded_spmm_cuda(op, U, with_gram=True)
    torch.cuda.synchronize()
    rows, gram_rows = (int(band_grid(
        op.band.shape[0] // 128, k, dtype, sm_count(U.device), gram,
        rows=op.narrow is not None, window=op.band.shape[1])[0] == "rows")
        for gram in (False, True))
    bf16 = dtype == torch.bfloat16
    assert tbanded.banded_kernel_launches == {
        "spmm": before["spmm"] + 1, "spmm_rect": before["spmm_rect"],
        "spmm_gram": before["spmm_gram"] + 1,
        "rows": before["rows"] + rows * (not bf16),
        "rows_bf16": before["rows_bf16"] + rows * bf16,
        "gram_rows": before["gram_rows"] + gram_rows * (not bf16),
        "gram_rows_bf16": before["gram_rows_bf16"] + gram_rows * bf16}
    Wp, Gp = tbanded.banded_spmm_gram_plain(op, U)
    assert _rel(Wd.cpu(), Wp.cpu()) < 1e-5
    # The block routes' bits (on an fp32 band every route's); K5 on the
    # bf16 row-wise route has K4's row-wise bits.
    W = tbanded.banded_spmm_cuda(op, U, route="walk") if bf16 else Wd
    assert torch.equal(W2, tbanded.banded_spmm_cuda(op, U, route="rows")
                       if bf16 and gram_rows else W)
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


@pytest.fixture(scope="module")
def shard_blocks():
    """Rank 1's (per x per + 2B) block of a 4-shard split core of a
    6000-point cloud and its (win_pad x per) transpose, in fp32 and bf16
    (host tables on the CPU; moved to the card per test)."""
    from eigenpinns_torch.parallel import build_sharded_operator

    _need_card()
    rng = np.random.default_rng(5)
    X = rng.normal(size=(6000, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=15)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        _, (core, _), _ = build_sharded_operator(
            L, 4, X=X, dtype=dtype, max_bandwidth=512, window=512,
            shards=(1,), device="cpu")
        out[dtype] = core
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["block", "transpose"])
def test_banded_cuda_rectangular_shard_blocks(shard_blocks, which, dtype, k):
    """K4 on a shard's rectangular block against its halo window (U of
    per + 2B rows) and on the block's transpose (W of win rows from a U
    of per rows, the rows past U's end read as zero), vs the plain
    version; W the same bits from both column blocks (the walk's: on a
    bf16 block the row-wise route, where it is the default, sums in
    another order), counted under "spmm_rect" and by its width. K5
    refuses a rectangular operator."""
    _need_card()
    A = shard_blocks[dtype].block(1, "cuda")
    if which == "transpose":
        A = A.transpose_banded
    gen = torch.Generator("cuda").manual_seed(k)
    U = torch.randn((A.n_cols, k), generator=gen, device="cuda")
    before = tbanded.banded_kernel_launches["spmm_rect"]
    width = tbanded.banded_rect_widths.get(k, 0)
    W = tbanded.banded_spmm_cuda(A, U)
    torch.cuda.synchronize()
    assert tbanded.banded_kernel_launches["spmm_rect"] == before + 1
    assert tbanded.banded_rect_widths[k] == width + 1
    assert W.shape == (A.n, k)
    assert _rel(W.cpu(), tbanded.banded_spmm_plain(A, U).cpu()) < 1e-5
    if dtype == torch.bfloat16:
        W = tbanded.banded_spmm_cuda(A, U, route="walk")
    for cb in (32, 64):
        assert torch.equal(tbanded.banded_spmm_cuda(A, U, col_block=cb), W)
    with pytest.raises(ValueError, match="square"):
        tbanded.banded_spmm_cuda(A, U, with_gram=True)


# ---- the band kernels' staged route ------------------------------------

def _staged_grids(k):
    """Every (col_block, warps) of the staged route at width k."""
    return [(cb, w) for cb in (32, 64) if k <= cb for w in (8, 4, 2)]


def _check_routes(launch, op, U, tol=1e-5):
    """W from the walk against the plain version (rel `tol`), then every
    grid of the staged route and a second launch the same bits."""
    k = U.shape[1]
    Ww = launch(op, U, route="walk")
    plain = (tsparse.rolling_spmm_plain if launch is tsparse.rolling_spmm_cuda
             else tbanded.banded_spmm_plain)
    torch.cuda.synchronize()
    assert _rel(Ww.cpu(), plain(op, U).cpu()) < tol
    assert torch.equal(launch(op, U), Ww)
    for cb, w in _staged_grids(k):
        W = launch(op, U, col_block=cb, warps=w, route="staged")
        torch.cuda.synchronize()
        assert torch.equal(W, Ww), (cb, w)
        assert torch.equal(launch(op, U, col_block=cb, warps=w,
                                  route="staged"), W)
    return Ww


def _rolling_cloud_op(n=500):
    X = np.random.default_rng(7).normal(size=(n, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    A = point_cloud_laplacian(X, n_neighbors=12)[0]
    return tsparse.RollingBanded.from_scipy(A, device="cuda")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 10, 20, 60, 67, 128])
@pytest.mark.parametrize("case", ["rolling", "cloud", "asym800"])
def test_band_staged_route_matches_the_walk(case, k):
    """The staged route (fp32 band, k <= col_block) on every grid (8, 4
    and 2 warps a block, both column blocks) gives the walk's W bit for
    bit, and the walk is within rel 1e-5 of the plain version: a rolling
    band whose windows start above row 0 ('high', as the multigrid loss
    runs it), a split core whose clamped windows reach past n, and a
    nonsymmetric band and its stored transpose. Odd k puts the groups of
    an arbitrary window start off 16-byte alignment; k = 67 and 128 take
    the walk whatever the grid."""
    _need_card()
    if case == "rolling":
        ops, launch = ([_rolling_cloud_op().with_precision("high")],
                       tsparse.rolling_spmm_cuda)
        assert ops[0].pre > 0
    else:
        op = _banded_op(case, torch.float32)
        ops, launch = [op], tbanded.banded_spmm_cuda
        if op.transpose_banded is not None:
            ops.append(op.transpose_banded)
    for op in ops:
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n, k)).astype(np.float32)).cuda()
        _check_routes(launch, op, U)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 20, 60])
@pytest.mark.parametrize("which", ["block", "transpose"])
def test_band_staged_route_on_shard_blocks(shard_blocks, which, k):
    """A shard's rectangular block (U rows past its halo window's end
    zero-filled) and its transpose: every staged grid gives the walk's
    bits."""
    _need_card()
    A = shard_blocks[torch.float32].block(1, "cuda")
    if which == "transpose":
        A = A.transpose_banded
    U = torch.from_numpy(np.random.default_rng(k).normal(
        size=(A.n_cols, k)).astype(np.float32)).cuda()
    _check_routes(tbanded.banded_spmm_cuda, A, U)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 60])
def test_band_staged_route_with_every_sub_block_of_a_piece(k):
    """A band whose first tiles hold a dense 256 x 256 corner: pieces
    with all 64 sub-blocks occupied stage all 8 groups (the ring's slot
    full) and every stripe lists 8 entries of the piece; W is the walk's
    and the dense product's (rel 1e-5)."""
    _need_card()
    r = np.random.default_rng(2)
    n = 1500
    A = sp.random(n, n, density=0.004, random_state=3, format="lil")
    A[:256, :256] = r.normal(size=(256, 256))
    A = (sp.csr_matrix(A) + sp.diags(np.full(n, 3.0))).tocsr()
    op, _ = tbanded.BandedELL.from_scipy(A, reorder=False, device="cuda",
                                         with_transpose=False)
    occ = op.occupancy.cpu().numpy().view(np.uint64)
    assert (occ == np.uint64(2**64 - 1)).sum() >= 4
    U = torch.from_numpy(r.normal(size=(n, k)).astype(np.float32)).cuda()
    W = _check_routes(tbanded.banded_spmm_cuda, op, U)
    D = torch.as_tensor(A.toarray(), dtype=torch.float32, device="cuda")
    assert _rel(W.cpu(), (D @ U).cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 39, 60])
def test_band_staged_route_gram_is_reproducible(k):
    """K5 and K1 with the Gram on the staged route (8-warp blocks, one a
    tile; these small operators take the walk by default): W is the
    product's bits, G the same from launch to launch and within rel
    2e-5 of the plain version's; the walk's G likewise."""
    _need_card()
    for launch, op in ((tbanded.banded_spmm_cuda,
                        _banded_op("cloud", torch.float32)),
                       (tsparse.rolling_spmm_cuda, _rolling_cloud_op())):
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n, k)).astype(np.float32)).cuda()
        W = launch(op, U)
        W1, G1 = launch(op, U, with_gram=True, route="staged")
        W2, G2 = launch(op, U, with_gram=True, route="staged")
        Wk, Gk = launch(op, U, with_gram=True, route="walk")
        Wd, Gd = launch(op, U, with_gram=True)
        torch.cuda.synchronize()
        assert torch.equal(W1, W) and torch.equal(W2, W)
        assert torch.equal(Wk, W) and torch.equal(Wd, W)
        assert torch.equal(G1, G2) and torch.equal(Gd, Gk)
        Gp = (U.T @ W).cpu()
        assert _rel(G1.cpu(), Gp) < 2e-5 and _rel(Gk.cpu(), Gp) < 2e-5
        with pytest.raises(ValueError):
            launch(op, U, with_gram=True, warps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 60])
def test_band_staged_route_walks_many_tiles_a_block(k):
    """A band of 1600 tiles, more than the card holds blocks at once: the
    staged route's blocks each walk several tiles, the ring's slots and
    barriers carried from one to the next; W is the walk's bits and
    within rel 1e-5 of the plain version."""
    _need_card()
    r = np.random.default_rng(4)
    n = 128 * 1600
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + r.integers(-300, 300, rows.size), 0, n - 1)
    A = sp.coo_matrix((r.normal(size=rows.size), (rows, cols)),
                      shape=(n, n)).tocsr()
    op, _ = tbanded.BandedELL.from_scipy(A, reorder=False, device="cuda",
                                         with_transpose=False)
    U = torch.from_numpy(r.normal(size=(n, k)).astype(np.float32)).cuda()
    _check_routes(tbanded.banded_spmm_cuda, op, U)


# ---- the row-wise route over the nonzero table --------------------------

ROWS_KS = [12, 20, 28, 30, 60, 84, 85, 128]


def _rect_bsr():
    """A rectangular 700 x 450 strip-BSR operator: its last column tile
    reaches past n_cols (U rows 450..511 do not exist)."""
    A = sp.random(700, 450, density=0.02, random_state=4, format="csr")
    return tbsr.BSRTile.from_scipy(A, device="cuda", reorder=False,
                                   with_transpose=False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("k", ROWS_KS)
@pytest.mark.parametrize("case", ["cloud", "asym800", "rect700x450"])
def test_bsr_cuda_rows_route_matches_the_walk(case, k):
    """The row-wise route (fp32 strips, 8 < k <= ROWS_MAX_K by default;
    forced past it): both wrappers give the walk's W bit for bit (both
    column blocks), a second launch the same bits, W within rel 1e-5 of
    the plain version, and each launch on the route is counted under
    "rows"; on a nonsymmetric operator and its stored transpose, and on a
    rectangular one whose last column tile reaches past n_cols. Odd k
    (30, 85) reads U by scalar loads."""
    _need_card()
    if case == "cloud":
        ops = [_cloud_bsr(6000)]
    elif case == "asym800":
        op = tbsr.BSRTile.from_scipy(_asym800(), device="cuda")[0]
        ops = [op, op.transpose_bsr]
    else:
        ops = [_rect_bsr()]
    for op in ops:
        burst = dataclasses.replace(op, gcid=None, lcid=None, gid=None)
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n_cols, k)).astype(np.float32)).cuda()
        before = tbsr.bsr_kernel_launches["rows"]
        W = tbsr.bsr_spmm_grouped_cuda(op, U, route="rows")
        Wb = tbsr.bsr_spmm_burst_cuda(burst, U, route="rows")
        torch.cuda.synchronize()
        assert tbsr.bsr_kernel_launches["rows"] == before + 2
        assert W.shape == (op.n, k)
        assert _rel(W.cpu(), tbsr.bsr_spmm_plain(op, U).cpu()) < 1e-5
        assert torch.equal(Wb, W)
        assert torch.equal(tbsr.bsr_spmm_grouped_cuda(op, U, route="rows"),
                           W)
        for cb in (32, 64):
            assert torch.equal(
                tbsr.bsr_spmm_grouped_cuda(op, U, col_block=cb), W)
            assert torch.equal(
                tbsr.bsr_spmm_burst_cuda(burst, U, col_block=cb), W)
        before = tbsr.bsr_kernel_launches["rows"]
        assert torch.equal(tbsr.bsr_spmm_grouped_cuda(op, U), W)
        assert tbsr.bsr_kernel_launches["rows"] == before + int(
            k <= tbsr.ROWS_MAX_K)


@pytest.mark.cuda
def test_bsr_cuda_rows_route_raises_where_it_cannot_run():
    """No fallback: the row-wise route refuses fp32 or bf16 strips
    without their narrow table, and the narrow path bf16 strips."""
    _need_card()
    op = tbsr.BSRTile.from_scipy(_asym800(), device="cuda")[0]
    U = torch.zeros((op.n, 28), device="cuda")
    for bare in (op, op.with_precision("bf16")):
        with pytest.raises(ValueError, match="narrow table"):
            tbsr.bsr_spmm_grouped_cuda(dataclasses.replace(bare, narrow=None),
                                       U, route="rows")
    with pytest.raises(ValueError, match="fp32"):
        tbsr.bsr_spmm_grouped_cuda(op.with_precision("bf16"), U[:, :4],
                                   route="narrow")


def _band_cases():
    """(launch, op, table) for the band layouts: the rolling cloud band
    ('high', windows above row 0) and the adversarial rolling operator
    (windows before row 0 and past n, a word with only bit 63 set) with
    their own tables; a split core whose clamped windows reach past n
    and a nonsymmetric band and its transpose, with the tables their
    builds give them (`BandedELL.narrow`), and a shard's rectangular
    block and its transpose (U rows past U's end read as zero), with the
    tables `ShardedBanded.block` gives them (`band_table`'s)."""
    from eigenpinns_torch.parallel import build_sharded_operator
    from eigenpinns_torch.sparse.nonzeros import band_table
    from eigenpinns_torch.utils.fixtures import adversarial_rolling_matrix

    out = []
    for op in (_rolling_cloud_op().with_precision("high"),
               tsparse.RollingBanded.from_scipy(
                   adversarial_rolling_matrix(), reorder=False,
                   device="cuda")[0]):
        out.append(("rolling", op, op.narrow))
    X = np.random.default_rng(5).normal(size=(6000, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=15)
    _, (core, _), _ = build_sharded_operator(
        L, 4, X=X, dtype=torch.float32, max_bandwidth=512, window=512,
        shards=(1,), device="cpu")
    block = core.block(1, "cuda")
    asym = _banded_op("asym800", torch.float32)
    for op in (_banded_op("cloud", torch.float32), asym,
               asym.transpose_banded):
        out.append(("full", op, op.narrow))
    for op in (block, block.transpose_banded):
        fresh = band_table(op.band, op.occupancy, op.starts)
        assert torch.equal(op.narrow.val, fresh.val)
        assert torch.equal(op.narrow.idx, fresh.idx)
        out.append(("full", op, op.narrow))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", ROWS_KS)
def test_band_rows_route_matches_the_walk(k):
    """The row-wise route over a band's nonzero table gives the walk's W
    bit for bit on both band layouts (the rolling band's default route
    in BAND_ROWS_K, counted in rolling_rows_launches; K4's on a band that
    carries its table where `band_grid` sends it (FULL_ROWS_K, and a
    window of FULL_ROWS_MIN_WINDOW_64 columns where the staged route
    would run 64 columns), counted under "rows", and equal to the staged
    route too; forced elsewhere), the same bits from a second launch, and
    W within rel 1e-5 of the plain version."""
    from eigenpinns_torch.sparse.occupancy import BAND_ROWS_K

    _need_card()
    for layout, op, table in _band_cases():
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n_cols if layout == "full" else op.n, k)).astype(
                np.float32)).cuda()
        starts = op.starts if layout == "full" else None
        pre = 0 if layout == "full" else op.pre
        W, G, route = tbanded.launch_band_kernel(
            op.band, starts, pre, op.occupancy, U, op.n, False, None,
            route="rows", table=table)
        assert route == "rows" and G is None and W.shape == (op.n, k)
        W2 = tbanded.launch_band_kernel(
            op.band, starts, pre, op.occupancy, U, op.n, False, None,
            route="rows", table=table)[0]
        torch.cuda.synchronize()
        assert torch.equal(W2, W)
        if layout == "rolling":
            Ww = tsparse.rolling_spmm_cuda(op, U, route="walk")
            plain = tsparse.rolling_spmm_plain(op, U)
            before = trolling.rolling_rows_launches
            Wd = tsparse.rolling_spmm_cuda(op, U)
            assert trolling.rolling_rows_launches == before + int(
                BAND_ROWS_K[0] <= k <= BAND_ROWS_K[1])
            assert torch.equal(Wd, W)
        else:
            Ww = tbanded.banded_spmm_cuda(op, U, route="walk")
            plain = tbanded.banded_spmm_plain(op, U)
            if op.narrow is not None:
                # K4's default route: the row-wise one where band_grid
                # sends the band with its table.
                before = tbanded.banded_kernel_launches["rows"]
                Wd = tbanded.banded_spmm_cuda(op, U)
                rows = band_grid(op.band.shape[0] // 128, k, torch.float32,
                                 sm_count(U.device), rows=True,
                                 window=op.band.shape[1])[0] == "rows"
                assert tbanded.banded_kernel_launches["rows"] == before + int(
                    rows)
                assert torch.equal(Wd, W)
                if k <= 64:
                    assert torch.equal(tbanded.banded_spmm_cuda(
                        op, U, route="staged"), W)
        torch.cuda.synchronize()
        assert torch.equal(W, Ww), (layout, op.band.shape)
        assert _rel(W.cpu(), plain.cpu()) < 1e-5


@pytest.mark.cuda
def test_band_rows_route_raises_where_it_cannot_run():
    """No fallback: the row-wise route refuses a band without its table
    (an fp32 or a bf16 one, rolling or full window, with the Gram or
    without) and the Gram past ROWS_GRAM_MAX_K on either band."""
    from eigenpinns_torch.sparse.occupancy import ROWS_GRAM_MAX_K

    _need_card()
    op = _rolling_cloud_op()
    U = torch.zeros((op.n, 84), device="cuda")
    wide = torch.zeros((op.n, ROWS_GRAM_MAX_K + 1), device="cuda")
    for bad, V, kw in (
            (dataclasses.replace(op, narrow=None), U, {}),
            (dataclasses.replace(op, narrow=None), U, {"with_gram": True}),
            (dataclasses.replace(op.with_precision("bf16"), narrow=None), U,
             {}),
            (op, wide, {"with_gram": True})):
        with pytest.raises(ValueError, match="row-wise"):
            tsparse.rolling_spmm_cuda(bad, V, route="rows", **kw)
    for dtype in (torch.float32, torch.bfloat16):
        band = _banded_op("asym800", dtype)
        U = torch.zeros((band.n, 84), device="cuda")
        wide = torch.zeros((band.n, ROWS_GRAM_MAX_K + 1), device="cuda")
        for bad, V, kw in (
                (dataclasses.replace(band, narrow=None), U, {}),
                (dataclasses.replace(band, narrow=None), U,
                 {"with_gram": True}),
                (band, wide, {"with_gram": True})):
            with pytest.raises(ValueError, match="row-wise"):
                tbanded.banded_spmm_cuda(bad, V, route="rows", **kw)


# ---- the bf16 row-wise route -------------------------------------------

BF16_KS = [12, 20, 30, 84, 85]


def _bf16_rows_check(launch, op, U, plain, counter, key, default):
    """One bf16 operator's row-wise route at width k = U.shape[1]: a
    second launch the same bits, W within BSR_TOL['bf16'] (1e-4) of the
    plain version, which rounds U as the kernel does, and the default
    route (`default`: whether it is the row-wise one) counted under
    `key` of `counter`."""
    W = launch(op, U, route="rows")
    torch.cuda.synchronize()
    assert W.shape == (op.n, U.shape[1])
    assert torch.equal(launch(op, U, route="rows"), W)
    assert _rel(W.cpu(), plain(op, U).cpu()) < 1e-4
    before = counter[key]
    Wd = launch(op, U)
    assert counter[key] == before + int(default)
    if default:
        assert torch.equal(Wd, W)


@pytest.mark.cuda
@pytest.mark.parametrize("k", BF16_KS)
@pytest.mark.parametrize("case", ["cloud", "asym800", "rect700x450"])
def test_bsr_cuda_bf16_rows_route_matches_plain(case, k):
    """K2 and K3 on bf16 strips by the row-wise route over the bf16 table
    (by default at BF16_ROWS_K): within 1e-4 of the plain version, the
    same bits from both wrappers and a second launch; on a
    nonsymmetric operator and its transpose and a rectangular one whose
    last column tile reaches past n_cols. Odd k (85) stores W by scalar
    stores; the bf16 copy's rows are padded to 8 values."""
    _need_card()
    if case == "cloud":
        ops = [_cloud_bsr(6000)]
    elif case == "asym800":
        op = tbsr.BSRTile.from_scipy(_asym800(), device="cuda")[0]
        ops = [op, op.transpose_bsr]
    else:
        ops = [_rect_bsr()]
    lo, hi = tbsr.BF16_ROWS_K
    for op in ops:
        op = op.with_precision("bf16")
        burst = dataclasses.replace(op, gcid=None, lcid=None, gid=None)
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n_cols, k)).astype(np.float32)).cuda()
        for launch, o in ((tbsr.bsr_spmm_grouped_cuda, op),
                          (tbsr.bsr_spmm_burst_cuda, burst)):
            _bf16_rows_check(launch, o, U, tbsr.bsr_spmm_plain,
                             tbsr.bsr_kernel_launches, "rows_bf16",
                             lo <= k <= hi)
        assert torch.equal(
            tbsr.bsr_spmm_grouped_cuda(op, U, route="rows"),
            tbsr.bsr_spmm_burst_cuda(burst, U, route="rows"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", BF16_KS)
@pytest.mark.parametrize("case", ["cloud", "asym800"])
def test_band_bf16_rows_route_matches_plain(case, k):
    """K4 on a bf16 band by the row-wise route over its bf16 table (by
    default at FULL_ROWS_K[bf16]): a split core whose clamped windows
    reach past U (U rows past n read as zero), a nonsymmetric band and
    its transpose; within 1e-4 of the plain version, a second launch the
    same bits; the gradient through `banded_spmm`
    applies the transpose through the same route."""
    from eigenpinns_torch.sparse.occupancy import FULL_ROWS_K

    _need_card()
    op = _banded_op(case, torch.bfloat16)
    if case == "cloud":
        assert int(op.starts.max()) + op.bandwidth > op.n
    lo, hi = FULL_ROWS_K[torch.bfloat16]
    ops = [op] + ([op.transpose_banded] if op.transpose_banded is not None
                  else [])
    for o in ops:
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(o.n, k)).astype(np.float32)).cuda()
        _bf16_rows_check(tbanded.banded_spmm_cuda, o, U,
                         tbanded.banded_spmm_plain,
                         tbanded.banded_kernel_launches, "rows_bf16",
                         lo <= k <= hi)
    U = torch.from_numpy(np.random.default_rng(k).normal(
        size=(op.n, k)).astype(np.float32)).cuda()
    g = torch.randn_like(U)
    Ut = U.clone().requires_grad_(True)
    (tbanded.banded_spmm(op, Ut) * g).sum().backward()
    At = op.transpose_banded if op.transpose_banded is not None else op
    assert _rel(Ut.grad.cpu(),
                tbanded.banded_spmm_plain(At, g).cpu()) < 1e-4


# ---- the shard blocks' tables, the rolling band's Gram and bf16 rows ----

SHARD_KS = [10, 20, 28, 60, 84]


@pytest.mark.cuda
@pytest.mark.parametrize("k", SHARD_KS)
@pytest.mark.parametrize("which", ["block", "transpose"])
def test_band_rows_route_on_shard_blocks(shard_blocks, which, k):
    """K4 on a shard's block and its transpose over the table that
    `ShardedBanded.block` gives them: the row-wise route gives the
    walk's bits and the staged route's (where it runs, k <= 64), a
    second launch the same bits, W within 1e-5 of the plain version; the
    default route (`band_grid` with the block's window) is counted under
    "rows" where it is the row-wise one."""
    _need_card()
    A = shard_blocks[torch.float32].block(1, "cuda")
    if which == "transpose":
        A = A.transpose_banded
    assert A.narrow is not None
    U = torch.from_numpy(np.random.default_rng(k).normal(
        size=(A.n_cols, k)).astype(np.float32)).cuda()
    W = tbanded.banded_spmm_cuda(A, U, route="rows")
    torch.cuda.synchronize()
    assert W.shape == (A.n, k)
    assert torch.equal(tbanded.banded_spmm_cuda(A, U, route="rows"), W)
    assert torch.equal(tbanded.banded_spmm_cuda(A, U, route="walk"), W)
    if k <= 64:
        assert torch.equal(tbanded.banded_spmm_cuda(A, U, route="staged"),
                           W)
    rows = band_grid(A.band.shape[0] // 128, k, torch.float32,
                     sm_count(U.device), rows=True,
                     window=A.band.shape[1])[0] == "rows"
    before = tbanded.banded_kernel_launches["rows"]
    assert torch.equal(tbanded.banded_spmm_cuda(A, U), W)
    assert tbanded.banded_kernel_launches["rows"] == before + int(rows)
    assert _rel(W.cpu(), tbanded.banded_spmm_plain(A, U).cpu()) < 1e-5


def _rolling_gram_ops(case, precision):
    """A rolling band and its stored transpose (if any) in `precision`:
    the 500-point cloud band, or the adversarial operator (windows before
    row 0 and past n, n not a multiple of 128)."""
    if case == "cloud":
        op = _rolling_cloud_op()
    else:
        op = tsparse.RollingBanded.from_scipy(adversarial_rolling_matrix(),
                                              reorder=False,
                                              device="cuda")[0]
    op = op.with_precision(precision)
    return [o for o in (op, op.transpose_rolling) if o is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 10, 20, 28, 39, 84, 128])
@pytest.mark.parametrize("case", ["cloud", "adversarial"])
def test_rolling_rows_gram_matches_the_walk(case, k):
    """K1 with the Gram on the row-wise route (forced; by default at
    BAND_GRAM_ROWS_K, counted in rolling_rows_gram_launches) on an fp32
    band: W and G the walk's bits (each tile's partial summed in the
    walk's order, then the same reduce), the same bits from a second
    launch, both within 1e-5 of the plain version; the stored transpose
    too."""
    from eigenpinns_torch.sparse.occupancy import BAND_GRAM_ROWS_K

    _need_card()
    lo, hi = BAND_GRAM_ROWS_K[torch.float32]
    for op in _rolling_gram_ops(case, "high"):
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n, k)).astype(np.float32)).cuda()
        W, G = tsparse.rolling_spmm_cuda(op, U, with_gram=True, route="rows")
        W2, G2 = tsparse.rolling_spmm_cuda(op, U, with_gram=True,
                                           route="rows")
        Ww, Gw = tsparse.rolling_spmm_cuda(op, U, with_gram=True,
                                           route="walk")
        torch.cuda.synchronize()
        assert W.shape == (op.n, k) and G.shape == (k, k)
        for a, b in ((W2, W), (G2, G), (Ww, W), (Gw, G)):
            assert torch.equal(a, b)
        Wp, Gp = tsparse.rolling_spmm_gram_plain(op, U)
        assert _rel(W.cpu(), Wp.cpu()) < 1e-5
        assert _rel(G.cpu(), Gp.cpu()) < 1e-5
        before = trolling.rolling_rows_gram_launches
        Wd, Gd = tsparse.rolling_spmm_cuda(op, U, with_gram=True)
        assert trolling.rolling_rows_gram_launches == before + int(
            lo <= k <= hi)
        assert torch.equal(Wd, W) and torch.equal(Gd, G)


def _full_gram_ops(case, dtype):
    """A full-window band (the split cloud core, whose clamped windows
    reach past n, or the nonsymmetric band) with its table, and its
    stored transpose (if any)."""
    op = _banded_op(case, dtype)
    return [o for o in (op, op.transpose_banded) if o is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 10, 20, 28, 39, 60, 84, 128])
@pytest.mark.parametrize("case", ["cloud", "asym800"])
def test_band_rows_gram_matches_the_walk(case, k):
    """K5 with the Gram on the row-wise route (forced; by default at
    FULL_GRAM_ROWS_K[fp32], counted under "gram_rows") on an fp32
    full-window band with its table: W and G the walk's bits (and the
    staged route's, k <= 64: each tile's partial in the walk's order,
    then the same reduce), the same bits from a second launch, W the
    same bits as K4's row-wise route, both within 1e-5 of the plain
    version; the stored transpose too; the gradient through
    `banded_spmm_gram` within 1e-4 of torch autograd on the plain
    version."""
    from eigenpinns_torch.sparse.occupancy import FULL_GRAM_ROWS_K

    _need_card()
    lo, hi = FULL_GRAM_ROWS_K[torch.float32]
    ops = _full_gram_ops(case, torch.float32)
    for op in ops:
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n, k)).astype(np.float32)).cuda()
        W, G = tbanded.banded_spmm_cuda(op, U, with_gram=True, route="rows")
        W2, G2 = tbanded.banded_spmm_cuda(op, U, with_gram=True,
                                          route="rows")
        Ww, Gw = tbanded.banded_spmm_cuda(op, U, with_gram=True,
                                          route="walk")
        torch.cuda.synchronize()
        assert W.shape == (op.n, k) and G.shape == (k, k)
        for a, b in ((W2, W), (G2, G), (Ww, W), (Gw, G)):
            assert torch.equal(a, b)
        if k <= 64:
            Ws, Gs = tbanded.banded_spmm_cuda(op, U, with_gram=True,
                                              route="staged")
            assert torch.equal(Ws, W) and torch.equal(Gs, G)
        assert torch.equal(tbanded.banded_spmm_cuda(op, U, route="rows"), W)
        Wp, Gp = tbanded.banded_spmm_gram_plain(op, U)
        assert _rel(W.cpu(), Wp.cpu()) < 1e-5
        assert _rel(G.cpu(), Gp.cpu()) < 1e-5
        before = dict(tbanded.banded_kernel_launches)
        Wd, Gd = tbanded.banded_spmm_cuda(op, U, with_gram=True)
        after = tbanded.banded_kernel_launches
        assert after["gram_rows"] == before["gram_rows"] + int(
            lo <= k <= hi)
        assert after["spmm_gram"] == before["spmm_gram"] + 1
        assert after["rows"] == before["rows"]
        assert torch.equal(Wd, W) and torch.equal(Gd, G)
    op = ops[0]
    gen = torch.Generator("cuda").manual_seed(k)
    U = torch.randn((op.n, k), generator=gen, device="cuda")
    gW = torch.randn((op.n, k), generator=gen, device="cuda")
    gG = torch.randn((k, k), generator=gen, device="cuda")
    grads = []
    for fn in (tbanded.banded_spmm_gram, tbanded.banded_spmm_gram_plain):
        Uk = U.clone().requires_grad_(True)
        Wk, Gk = fn(op, Uk)
        ((Wk * gW).sum() + (Gk * gG).sum()).backward()
        grads.append(Uk.grad)
    assert _rel(grads[0].cpu(), grads[1].cpu()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k", BF16_KS)
@pytest.mark.parametrize("case", ["cloud", "asym800"])
def test_band_bf16_rows_gram_matches_plain(case, k):
    """K5 on a bf16 full-window band over its bf16 table, on the
    row-wise route with the Gram (forced; by default at
    FULL_GRAM_ROWS_K[bf16], counted under "gram_rows_bf16"): W the same
    bits as K4's bf16 row-wise route (one FFMA chain a row over the same
    table), W and G within 1e-4 of the plain version (which rounds U as
    the kernel does; G from the unrounded U), both the same bits from a
    second launch; the stored transpose too; the gradient through
    `banded_spmm_gram` within 1e-4 of the plain version's dU = A^T (gW +
    U gG) + W gG^T, which rounds the cotangent as K4's bf16 route does
    (torch autograd through the plain version rounds A^T's output
    instead)."""
    from eigenpinns_torch.sparse.occupancy import FULL_GRAM_ROWS_K

    _need_card()
    lo, hi = FULL_GRAM_ROWS_K[torch.bfloat16]
    ops = _full_gram_ops(case, torch.bfloat16)
    for op in ops:
        assert op.narrow.val.dtype == torch.bfloat16
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n, k)).astype(np.float32)).cuda()
        W, G = tbanded.banded_spmm_cuda(op, U, with_gram=True, route="rows")
        W2, G2 = tbanded.banded_spmm_cuda(op, U, with_gram=True,
                                          route="rows")
        torch.cuda.synchronize()
        assert W.shape == (op.n, k) and G.shape == (k, k)
        assert torch.equal(W2, W) and torch.equal(G2, G)
        assert torch.equal(tbanded.banded_spmm_cuda(op, U, route="rows"), W)
        Wp, Gp = tbanded.banded_spmm_gram_plain(op, U)
        assert _rel(W.cpu(), Wp.cpu()) < 1e-4
        assert _rel(G.cpu(), Gp.cpu()) < 1e-4
        before = dict(tbanded.banded_kernel_launches)
        Wd, Gd = tbanded.banded_spmm_cuda(op, U, with_gram=True)
        after = tbanded.banded_kernel_launches
        assert after["gram_rows_bf16"] == before["gram_rows_bf16"] + int(
            lo <= k <= hi)
        assert after["rows_bf16"] == before["rows_bf16"]
        if lo <= k <= hi:
            assert torch.equal(Wd, W) and torch.equal(Gd, G)
    op = ops[0]
    gen = torch.Generator("cuda").manual_seed(k)
    U = torch.randn((op.n, k), generator=gen, device="cuda")
    gW = torch.randn((op.n, k), generator=gen, device="cuda")
    gG = torch.randn((k, k), generator=gen, device="cuda")
    Uk = U.clone().requires_grad_(True)
    Wk, Gk = tbanded.banded_spmm_gram(op, Uk)
    ((Wk * gW).sum() + (Gk * gG).sum()).backward()
    At = op.transpose_banded if op.transpose_banded is not None else op
    Wp = tbanded.banded_spmm_plain(op, U)
    ref = tbanded.banded_spmm_plain(At, gW + U @ gG) + Wp @ gG.T
    assert _rel(Uk.grad.cpu(), ref.cpu()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k", BF16_KS)
@pytest.mark.parametrize("case", ["cloud", "adversarial"])
def test_rolling_bf16_rows_route_matches_plain(case, k):
    """K1 on a bf16 rolling band over the bf16 table `with_precision`
    gives it, by the bf16 row-wise route (by default at BAND_BF16_ROWS_K,
    counted in rolling_rows_bf16_launches): W within 1e-4 of the plain
    version, which rounds U as the kernel does, the same bits from a
    second launch; with the Gram (by default at BAND_GRAM_ROWS_K[bf16])
    W the same bits as without it, G within 1e-4 of the plain version's
    (from the unrounded U) and the same bits from a second launch; the
    gradient through the fused Gram within 1e-4 of the plain version's;
    the stored transpose too."""
    from eigenpinns_torch.sparse.occupancy import (
        BAND_BF16_ROWS_K,
        BAND_GRAM_ROWS_K,
    )

    _need_card()
    lo, hi = BAND_BF16_ROWS_K
    glo, ghi = BAND_GRAM_ROWS_K[torch.bfloat16]
    ops = _rolling_gram_ops(case, "bf16")
    for op in ops:
        assert op.narrow.val.dtype == torch.bfloat16
        U = torch.from_numpy(np.random.default_rng(k).normal(
            size=(op.n, k)).astype(np.float32)).cuda()
        W = tsparse.rolling_spmm_cuda(op, U, route="rows")
        torch.cuda.synchronize()
        assert torch.equal(tsparse.rolling_spmm_cuda(op, U, route="rows"), W)
        assert _rel(W.cpu(), tsparse.rolling_spmm_plain(op, U).cpu()) < 1e-4
        before = trolling.rolling_rows_bf16_launches
        Wd = tsparse.rolling_spmm_cuda(op, U)
        assert trolling.rolling_rows_bf16_launches == before + int(
            lo <= k <= hi)
        if lo <= k <= hi:
            assert torch.equal(Wd, W)
        Wg, G = tsparse.rolling_spmm_cuda(op, U, with_gram=True,
                                          route="rows")
        Wg2, G2 = tsparse.rolling_spmm_cuda(op, U, with_gram=True,
                                            route="rows")
        torch.cuda.synchronize()
        assert torch.equal(Wg, W) and torch.equal(Wg2, W)
        assert torch.equal(G2, G)
        _, Gp = tsparse.rolling_spmm_gram_plain(op, U)
        assert _rel(G.cpu(), Gp.cpu()) < 1e-4
        before = trolling.rolling_rows_gram_launches
        tsparse.rolling_spmm_cuda(op, U, with_gram=True)
        assert trolling.rolling_rows_gram_launches == before + int(
            glo <= k <= ghi)
    op = ops[0]
    U = torch.from_numpy(np.random.default_rng(k).normal(
        size=(op.n, k)).astype(np.float32)).cuda()
    gen = torch.Generator("cuda").manual_seed(k)
    gW = torch.randn((op.n, k), generator=gen, device="cuda")
    gG = torch.randn((k, k), generator=gen, device="cuda")
    Uk = U.clone().requires_grad_(True)
    Wk, Gk = tsparse.rolling_spmm_gram(op, Uk)
    ((Wk * gW).sum() + (Gk * gG).sum()).backward()
    At = op.transpose_rolling if op.transpose_rolling is not None else op
    Wp = tsparse.rolling_spmm_plain(op, U)
    ref = tsparse.rolling_spmm_plain(At, gW + U @ gG) + Wp @ gG.T
    assert _rel(Uk.grad.cpu(), ref.cpu()) < 1e-4


# The kernels of a dense eigensolve: the hand-written one
# (`csrc/small_eigh.cu`, n <= 84), cuSOLVER's (`torch.linalg.eigh`) and
# ATen's check of its result.
EIGH_KERNELS = re.compile(
    r"small_eigh|(sy|he)(trd|evd|evj)|ormtr|orgtr|ste(dc|qr)|sterf|"
    r"lar[fg]|latrd|lansy|lascl|copy_info", re.IGNORECASE)


@pytest.mark.cuda
def test_tracer_spans_share_the_device_trace_clock():
    """Under a profile of CUDA activity alone (the benchmark's traced
    window) tracing is on, every span of a small polish has a device
    time, and every kernel of its eigensolves (the hand-written
    eigensolver's at 3k = 84 and k = 28) starts inside the host interval
    of a `lobpcg.eigh` span: the spans' host times and the device trace
    share one clock."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from eigenpinns_torch.solvers import lobpcg
    from eigenpinns_torch.utils import profiling
    from eigenpinns_torch.utils.fixtures import make_cloud

    L, Mmat = point_cloud_laplacian(make_cloud(4000, seed=1),
                                    n_neighbors=15)
    K, perm = tsparse.BSRTile.from_scipy(L, device="cuda")
    M = tsparse.Diagonal(torch.as_tensor(
        np.asarray(Mmat.diagonal())[perm], dtype=torch.float32,
        device="cuda"))
    X0 = torch.randn((L.shape[0], 28), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    lobpcg(K, M, X0, max_iter=2, tol=0.0)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch.autograd._profiler_enabled()
        lobpcg(K, M, X0, max_iter=20, tol=0.0)
        torch.cuda.synchronize()
    recs = profiling.records()
    profiling.reset()
    assert {r["name"] for r in recs} == {"lobpcg", "lobpcg.eigh",
                                         "lobpcg.gram", "sparse.spmm"}
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0
               for r in recs)
    eighs = [(r["start_ns"], r["end_ns"]) for r in recs
             if r["name"] == "lobpcg.eigh"]
    assert len(eighs) == 3 * 20 + 1
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()
              and EIGH_KERNELS.search(e.name())]
    assert starts
    assert all(any(a <= s <= b for a, b in eighs) for s in starts)


# ---- the small symmetric eigensolver (csrc/small_eigh.cu) -------------------
#
# Against torch.linalg.eigh on the card, for an n x n input in precision
# eps: eigenvalues (against the fp64 library's) and the residual
# ||A V - V diag(w)||_F within EIGH_VAL n eps ||A||_F, orthonormality
# ||V^T V - I||_F within EIGH_ORTH n eps. The largest the kernel reads
# over these tests' inputs on an H100: eigenvalues 0.41, residual 0.54,
# orthonormality 10.8 (fp32, n = 80 and 84; 3.7 in fp64); the library's
# fp32 orthonormality reads up to 16.1 on the same inputs.

EIGH_VAL = 1.0
EIGH_ORTH = 16.0


def _small_eigh(A):
    from eigenpinns_torch.solvers import small_eigh

    status = torch.zeros((), dtype=torch.int32, device=A.device)
    before = small_eigh.small_eigh_launches
    w, V = small_eigh.small_eigh_cuda(A, status)
    torch.cuda.synchronize()
    assert small_eigh.small_eigh_launches == before + 1
    return w, V, int(status)


def _check_eigh(A, w, V):
    n, eps = A.shape[0], torch.finfo(A.dtype).eps
    assert w.dtype == V.dtype == A.dtype
    Ad, Vd, wd = A.double(), V.double(), w.double()
    norm = torch.linalg.matrix_norm(Ad)
    assert torch.all(wd[1:] >= wd[:-1])
    assert (wd - torch.linalg.eigvalsh(Ad)).abs().max() <= (
        EIGH_VAL * n * eps * norm)
    assert torch.linalg.matrix_norm(Ad @ Vd - Vd * wd) <= (
        EIGH_VAL * n * eps * norm)
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    assert torch.linalg.matrix_norm(Vd.T @ Vd - eye) <= EIGH_ORTH * n * eps


def _sym_card(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((n, n), generator=g, dtype=torch.float64)
    return (X + X.T).to(dtype).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 27, 28, 84])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_small_eigh_matches_linalg(n, dtype):
    _need_card()
    A = _sym_card(n, dtype, n)
    w, V, status = _small_eigh(A)
    assert status == 0
    _check_eigh(A, w, V)
    # The lower triangle is what it reads.
    w2, V2, _ = _small_eigh(A + torch.triu(torch.full_like(A, 3.0), 1))
    assert torch.equal(w2, w) and torch.equal(V2, V)


@pytest.mark.cuda
def test_small_eigh_every_n_on_its_grid():
    """Every n the kernel takes, in both types: its launch grid (m = S * P
    covers n with at most 7 padded positions, S <= 16 positions a thread,
    within the launch bound) and its result against the library's."""
    _need_card()
    from eigenpinns_torch.solvers import small_eigh

    for n in range(1, small_eigh.MAX_N + 1):
        S, P, threads = small_eigh.grid(n)
        assert S % 2 == 0 and S <= 16 and n <= S * P <= n + 7
        assert threads % 32 == 0 and threads <= 576
        for dtype in (torch.float32, torch.float64):
            A = _sym_card(n, dtype, 1000 + n)
            w, V, status = _small_eigh(A)
            assert status == 0
            _check_eigh(A, w, V)
    assert small_eigh.grid(84)[:2] == (14, 6)
    assert small_eigh.grid(28)[:2] == (4, 7)
    for bad in (0, small_eigh.MAX_N + 1):
        with pytest.raises(ValueError):
            small_eigh.grid(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [85, 127, 128])
def test_eigh_past_the_kernel_takes_the_library(n):
    """Past n = 84 `rayleigh_ritz.eigh` on the card is torch.linalg.eigh
    bit for bit, one host sync and no kernel launch."""
    _need_card()
    import sys

    from torch.profiler import ProfilerActivity, profile

    from eigenpinns_torch.solvers import small_eigh
    from eigenpinns_torch.utils import profiling

    rr = sys.modules["eigenpinns_torch.solvers.rayleigh_ritz"]
    A = _sym_card(n, torch.float64, n)
    before = small_eigh.small_eigh_launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]):
        w, V = rr.eigh(A)
    counts = profiling.counters()
    profiling.reset()
    assert counts == {"sync.eigh": 1}
    assert small_eigh.small_eigh_launches == before
    wl, Vl = torch.linalg.eigh(A)
    assert torch.equal(w, wl) and torch.equal(V, Vl)


@pytest.mark.cuda
def test_small_eigh_near_degenerate_pair():
    """A pair 1e-9 apart (relative) in fp64: its subspace is the
    library's, whatever rotation inside it each returns."""
    _need_card()
    n = 84
    g = torch.Generator().manual_seed(11)
    Q = torch.linalg.qr(torch.randn((n, n), generator=g,
                                    dtype=torch.float64))[0]
    lam = torch.sort(torch.rand(n, generator=g, dtype=torch.float64)
                     * 100).values
    lam[11] = lam[10] * (1 + 1e-9)
    A = ((Q * lam) @ Q.T).cuda()
    w, V, status = _small_eigh(A)
    assert status == 0
    _check_eigh(A, w, V)
    Vl = torch.linalg.eigh(A)[1]
    proj = V[:, 10:12] @ V[:, 10:12].T - Vl[:, 10:12] @ Vl[:, 10:12].T
    assert torch.linalg.matrix_norm(proj) < 1e-8


@pytest.mark.cuda
def test_small_eigh_rank_deficient_whitening_gram():
    """A whitening Gram of rank 20 at n = 28 in fp32, eigenvalues at and
    below zero."""
    _need_card()
    g = torch.Generator().manual_seed(5)
    B = torch.randn((28, 20), generator=g, dtype=torch.float64)
    G = (B @ B.T).float().cuda()
    w, V, status = _small_eigh(G)
    assert status == 0 and float(w[:8].abs().max()) < 1e-4
    assert float(torch.linalg.eigvalsh(G.double()).min()) < 0
    _check_eigh(G, w, V)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rayleigh_ritz", "whiten_w", "whiten_p"])
def test_small_eigh_on_the_1m_polish_grams(name):
    """The three eigensolves' inputs of one iteration (the 400th) of the
    benchmark's 1M polish (`direct1m_bsr.solve`, seed 1): the fp64
    Rayleigh-Ritz Gram at 84 and the two fp32 whitening Grams at 28."""
    _need_card()
    import os

    path = os.path.join(os.path.dirname(__file__), "data",
                        "polish1m_grams.npz")
    A = torch.as_tensor(np.load(path)[name]).cuda()
    assert A.shape == ((84, 84) if name == "rayleigh_ritz" else (28, 28))
    w, V, status = _small_eigh(A)
    assert status == 0
    _check_eigh(A, w, V)


@pytest.mark.cuda
def test_small_eigh_nonfinite_input_fails_on_the_card():
    """A NaN input: NaN outputs and the status word set, no host sync;
    `rayleigh_ritz.eigh` without a status word raises LinAlgError as
    torch.linalg.eigh does."""
    _need_card()
    import sys

    rr = sys.modules["eigenpinns_torch.solvers.rayleigh_ritz"]
    A = torch.eye(28, device="cuda")
    A[5, 2] = float("nan")
    w, V, status = _small_eigh(A)
    assert status == 1 and torch.isnan(w).all() and torch.isnan(V).all()
    with pytest.raises(torch.linalg.LinAlgError):
        rr.eigh(A)


def _small_polish_problem(k=8):
    from eigenpinns_torch.utils.fixtures import make_cloud

    L, Mmat = point_cloud_laplacian(make_cloud(2000, seed=2),
                                    n_neighbors=15)
    K, perm = tsparse.BSRTile.from_scipy(L, device="cuda")
    M = tsparse.Diagonal(torch.as_tensor(
        np.asarray(Mmat.diagonal())[perm], dtype=torch.float32,
        device="cuda"))
    X0 = torch.randn((L.shape[0], k), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    return K, M, X0


@pytest.mark.cuda
def test_lobpcg_raises_on_a_failed_eigensolve():
    """A NaN in the start makes the start's whitening eigensolve fail on
    the card; the first stop check reads the status word with the stop
    flag and raises LinAlgError, where the NaN residuals alone would read
    as converged."""
    _need_card()
    from eigenpinns_torch.solvers import lobpcg

    K, M, X0 = _small_polish_problem()
    X0[7, 3] = float("nan")
    with pytest.raises(torch.linalg.LinAlgError):
        lobpcg(K, M, X0, max_iter=10, tol=1e-6)
    with pytest.raises(torch.linalg.LinAlgError):   # no check in the loop
        lobpcg(K, M, X0, max_iter=3, tol=1e-6)


@pytest.mark.cuda
def test_lobpcg_iterations_make_no_host_sync(monkeypatch):
    """Between two stop checks a polish iteration on the card runs under
    CUDA's sync debug mode "error" (any host sync raises): its eigensolves
    are the kernel's and its selection a masked sum. Its counters: three
    kernel eigensolves an iteration (and the start's), no sync at the
    eigensolves or the selection, one at each stop check."""
    _need_card()
    import sys

    from torch.profiler import ProfilerActivity, profile

    from eigenpinns_torch.utils import profiling

    lob = sys.modules["eigenpinns_torch.solvers.lobpcg"]
    K, M, X0 = _small_polish_problem()
    lob.lobpcg(K, M, X0, max_iter=2, tol=0.0)    # builds, first-use checks
    torch.cuda.synchronize()
    check = lob._keep_going

    def allowed(res, tol, status):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return check(res, tol, status)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(lob, "_keep_going", allowed)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = lob.lobpcg(K, M, X0, max_iter=30, tol=0.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    counts = profiling.counters()
    profiling.reset()
    assert int(res.iterations) == 30
    assert counts == {"eigh.kernel": 3 * 30 + 1, "sync.eigh": 0,
                      "sync.select": 0, "sync.stop_check": 3}
