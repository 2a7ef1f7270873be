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
    narrow = k <= tbsr.NARROW_MAX_K and precision != "bf16"
    assert tbsr.bsr_kernel_launches == {
        "grouped": before["grouped"] + 1, "burst": before["burst"] + 1,
        "narrow": before["narrow"] + 2 * narrow}
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
    W8 = tbsr.bsr_spmm_grouped_cuda(op, U, warps=8)
    tol = 1e-4 if precision == "bf16" else 1e-5
    assert _rel(W8.cpu(), tbsr.bsr_spmm_plain(op, U).cpu()) < tol
    assert torch.equal(tbsr.bsr_spmm_grouped_cuda(op, U), W8)
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
    'bf16') and, in fp32, vs scipy's product in float64 (rel 1e-5); the
    same bits from both kernels."""
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
        "spmm": before["spmm"] + 1, "spmm_rect": before["spmm_rect"],
        "spmm_gram": before["spmm_gram"] + 1}
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
    version; W the same bits from both column blocks. K5 refuses a
    rectangular operator."""
    _need_card()
    A = shard_blocks[dtype].block(1, "cuda")
    if which == "transpose":
        A = A.transpose_banded
    gen = torch.Generator("cuda").manual_seed(k)
    U = torch.randn((A.n_cols, k), generator=gen, device="cuda")
    before = tbanded.banded_kernel_launches["spmm_rect"]
    W = tbanded.banded_spmm_cuda(A, U)
    torch.cuda.synchronize()
    assert tbanded.banded_kernel_launches["spmm_rect"] == before + 1
    assert W.shape == (A.n, k)
    assert _rel(W.cpu(), tbanded.banded_spmm_plain(A, U).cpu()) < 1e-5
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
