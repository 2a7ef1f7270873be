"""The nonzero table of a band (`sparse/nonzeros.py`) and the routes that
read it, against the JAX package's layouts.

The row-wise route (csrc/nonzero_spmm.cuh) reads a tiled operator's
nonzeros as a sliced ELL, each row in the order in which the column-block
walk sums it, so that it gives the walk's bits on fp32 layouts. Strip-BSR's
table is held in tests/test_torch_bsr_narrow.py; here, on the CPU, the
band's, and the bf16 tables:

  * `band_table` lists every nonzero of the band once, bit for bit, with
    its U row, in band-column order (the walk's: pieces, sub-block column,
    column), derived independently from the JAX package's band and the
    permuted matrix's triplets, for the rolling layout (windows above row
    0 and past n, the stored transpose) and the full-window layout;
    padding is a zero value with index -1 after each row's entries;
  * its plain reader (`table_spmm_plain`) equals `rolling_spmm_plain` and
    the JAX package's rolling reference, `banded_spmm_plain` and the JAX
    banded reference, at rel 1e-6 (fp32, sums in another order);
  * a full-window band (`BandedELL.from_scipy`, its transpose) carries
    its table;
  * `RollingBanded.with_precision` keeps, rebuilds or drops the table;
  * strip-BSR's bf16 table (`with_precision("bf16")`) is the fp32 table
    with its values rounded, the same as a bf16 build's, and its plain
    reader, which rounds U, matches `bsr_spmm_plain` in 'bf16' and both
    JAX Pallas kernels in interpret mode at rel 1e-5;
  * `strip_route` and `band_grid` take the row-wise route where they
    should (fp32 and bf16 strips, fp32 rolling bands, fp32 and bf16
    full-window bands, each at its widths) and raise where the kernels
    cannot take it (the Gram, no table, past the kernel's widest k).

The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu import sparse as jsparse
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sparse import banded as tbanded
from eigenpinns_torch.sparse import bsr as tbsr
from eigenpinns_torch.sparse.nonzeros import (
    band_table,
    gram_partials_plain,
    table_spmm_plain,
)
from eigenpinns_torch.sparse.occupancy import (
    BAND_BF16_ROWS_K,
    BAND_GRAM_ROWS_K,
    BAND_ROWS_K,
    FULL_GRAM_ROWS_K,
    ROWS_GRAM_MAX_K,
    band_grid,
)

F32_GRAM, BF16_GRAM = (FULL_GRAM_ROWS_K[torch.float32],
                       FULL_GRAM_ROWS_K[torch.bfloat16])
from eigenpinns_torch.utils.fixtures import adversarial_rolling_matrix

torch.set_num_threads(2)


def _cloud_points():
    X = np.random.default_rng(20240818).normal(size=(900, 3))
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def _cloud():
    return point_cloud_laplacian(_cloud_points(), n_neighbors=12)[0].tocsr()


def _asym800():
    r = np.random.default_rng(9)
    n = 800
    rows = r.integers(0, n, 4 * n)
    cols = np.clip(rows + r.integers(-90, 90, 4 * n), 0, n - 1)
    A = sp.coo_matrix((r.normal(size=4 * n), (rows, cols)),
                      shape=(n, n)).tocsr()
    return (A + sp.diags(np.full(n, 4.0))).tocsr()


# (layout, matrix, reorder)
CASES = {
    "rolling-cloud": ("rolling", _cloud, True),
    "rolling-asym": ("rolling", _asym800, False),
    "rolling-adversarial": ("rolling", adversarial_rolling_matrix, False),
    "full-cloud": ("full", _cloud, True),
    "full-asym": ("full", _asym800, False),
}


@pytest.fixture(scope="module")
def ops():
    out = {}
    for name, (layout, make, reorder) in CASES.items():
        A = make()
        if layout == "rolling":
            top, perm = tsparse.RollingBanded.from_scipy(
                A, reorder=reorder, device="cpu")
            jop, jperm = jsparse.RollingBanded.from_scipy(A, reorder=reorder)
        else:
            top, perm = tbanded.BandedELL.from_scipy(A, reorder=reorder,
                                                     device="cpu")
            jop, jperm = jsparse.BandedELL.from_scipy(A, reorder=reorder)
        np.testing.assert_array_equal(perm, jperm)
        out[name] = (layout, A[perm][:, perm].tocsr(), top, jop)
    return out


def _pairs(layout, top, jop, Ap):
    """[(torch op, its table, JAX op, its matrix)]: the operator and, for
    a nonsymmetric one, its stored transpose."""
    out = []
    if layout == "rolling":
        out.append((top, top.narrow, jop, Ap))
        if top.transpose_rolling is not None:
            out.append((top.transpose_rolling, top.transpose_rolling.narrow,
                        jop.transpose_rolling, Ap.T.tocsr()))
    else:
        out.append((top, top.narrow, jop, Ap))
        if top.transpose_banded is not None:
            t = top.transpose_banded
            out.append((t, t.narrow, jop.transpose_banded, Ap.T.tocsr()))
    return out


def _rows_of(t):
    """Each table entry's row, and its rank within the row."""
    width = np.diff(t.slice_start.numpy()) // 32
    e = np.arange(t.val.numel())
    slice_of = np.repeat(np.arange(t.n_slices), width * 32)
    offset = e - t.slice_start.numpy()[slice_of]
    return slice_of * 32 + offset % 32, offset // 32


def _walk_lists(layout, jop, A):
    """Per row, (values, U rows) in the walk's order, from the JAX band
    and the triplets of the matrix it stores: each nonzero (r, c) sits at
    band column (c + pre) mod B' (rolling) or c - starts[r // 128] (full
    window), and a row is summed in band-column order."""
    band = np.asarray(jop.band, np.float32)
    coo = sp.coo_matrix(A)
    if layout == "rolling":
        b = (coo.col + jop.pre) % band.shape[1]
    else:
        b = coo.col - np.asarray(jop.starts)[coo.row // 128]
    order = np.lexsort((b, coo.row))
    r, c, b = coo.row[order], coo.col[order], b[order]
    out = {}
    for row in np.unique(r):
        sel = r == row
        out[row] = (band[row, b[sel]], c[sel])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_band_table_lists_every_nonzero_in_walk_order(ops, name):
    layout, Ap, top, jop = ops[name]
    for op, t, j_op, A in _pairs(layout, top, jop, Ap):
        assert t is not None
        val, idx = t.val.numpy(), t.idx.numpy()
        assert t.n_slices * 32 == op.band.shape[0] and t.slice_start[0] == 0
        assert np.all(np.diff(t.slice_start.numpy()) % 32 == 0)
        row, rank = _rows_of(t)
        live = idx >= 0
        assert np.all(val[~live] == 0)
        # The live entries of each row come first, then its padding.
        counts = np.bincount(row[live], minlength=t.n_slices * 32)
        assert np.array_equal(live, rank < counts[row])
        # Every nonzero once, in the walk's order, bit for bit.
        walk = _walk_lists(layout, j_op, A)
        assert int(live.sum()) == A.nnz == sum(v.size for v, _ in
                                               walk.values())
        order = np.lexsort((rank, row))
        order = order[live[order]]
        starts = np.concatenate(([0], np.cumsum(counts)))
        for r, (v, u) in walk.items():
            sel = order[starts[r]:starts[r + 1]]
            assert np.array_equal(val[sel].view(np.int32),
                                  v.view(np.int32)), r
            assert np.array_equal(idx[sel], u), r


@pytest.mark.parametrize("k", [3, 28])
@pytest.mark.parametrize("name", list(CASES))
def test_band_table_plain_reader_matches_plain_and_jax(ops, name, k):
    layout, Ap, top, jop = ops[name]
    U = np.random.default_rng(k).normal(size=(top.n, k)).astype(np.float32)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    for op, t, j_op, _ in _pairs(layout, top, jop, Ap):
        W = table_spmm_plain(t, Ut, op.n).numpy()
        if layout == "rolling":
            Wp = tsparse.rolling_spmm_plain(op, Ut).numpy()
            ref = jsparse.rolling.rolling_spmm_reference(j_op, Uj)
        else:
            Wp = tbanded.banded_spmm_plain(op, Ut).numpy()
            ref = jsparse.banded.banded_spmm_reference(j_op, Uj)
        for other in (Wp, np.asarray(ref)):
            assert np.abs(W - other).max() <= 1e-6 * np.abs(other).max()


@pytest.mark.parametrize("name", ["full-cloud", "full-asym"])
def test_full_band_carries_its_table(ops, name):
    """`BandedELL.from_scipy` gives the band and its stored transpose the
    table `band_table` builds from them, which K4's row-wise route
    reads."""
    _, _, top, _ = ops[name]
    for op in (top, top.transpose_banded):
        if op is None:
            continue
        fresh = band_table(op.band, op.occupancy, op.starts)
        for a, b in ((op.narrow.val, fresh.val), (op.narrow.idx, fresh.idx),
                     (op.narrow.slice_start, fresh.slice_start)):
            assert torch.equal(a, b)
    assert (top.transpose_banded is None) == (name == "full-cloud")


def test_rolling_table_follows_with_precision(ops):
    """A bf16 band carries the fp32 table with its values rounded to
    nearest even (`with_values`: the same U rows and slices, transpose
    too), which the bf16 row-wise route reads; the upcast back to fp32
    rebuilds it from the rounded band (transpose too); the same fp32
    band keeps its own; a bf16 build lists its own band's nonzeros."""
    _, _, top, _ = ops["rolling-asym"]
    b = top.with_precision("bf16")
    for o, f in ((b, top), (b.transpose_rolling, top.transpose_rolling)):
        assert o.narrow.val.dtype == torch.bfloat16
        assert o.narrow.idx is f.narrow.idx
        assert o.narrow.slice_start is f.narrow.slice_start
        assert torch.equal(o.narrow.val, f.narrow.val.bfloat16())
    h = b.with_precision("highest")
    for o in (h, h.transpose_rolling):
        fresh = band_table(o.band, o.occupancy, pre=o.pre)
        assert torch.equal(o.narrow.val, fresh.val)
        assert torch.equal(o.narrow.idx, fresh.idx)
        assert torch.equal(o.narrow.slice_start, fresh.slice_start)
    live = h.narrow.idx >= 0
    assert torch.equal(h.narrow.val[live],
                       top.narrow.val[live].bfloat16().float())
    assert top.with_precision("high").narrow is top.narrow
    assert top.with_precision("highest").transpose_rolling.narrow is (
        top.transpose_rolling.narrow)
    bf = tsparse.RollingBanded.from_scipy(_asym800(), reorder=False,
                                          dtype=torch.bfloat16,
                                          device="cpu")[0]
    fresh = band_table(bf.band, bf.occupancy, pre=bf.pre)
    assert bf.narrow.val.dtype == torch.bfloat16
    for a, c in ((bf.narrow.val, fresh.val), (bf.narrow.idx, fresh.idx),
                 (bf.narrow.slice_start, fresh.slice_start)):
        assert torch.equal(a, c)


# The sharded paths' blocks, as their paths launch them: (tiles, window).
SHARD_SHAPES = {
    "16c block": (586, 3712), "16c transpose": (644, 3584),
    "1M core, one shard": (7813, 1024), "1M transpose": (7829, 1024),
    "multigrid level 3, 4 shards": (6, 384),
    "multigrid level 3, one shard": (21, 384)}


@pytest.mark.parametrize("k", [5, 6, 10, 19, 20, 28, 54, 60, 84, 85])
@pytest.mark.parametrize("shape", list(SHARD_SHAPES))
def test_band_grid_routes_the_shard_blocks(shape, k):
    """The sharded paths' blocks and transposes, with the tables
    `ShardedBanded.block` gives them, take the row-wise route at every
    width their paths launch (16c's training and polish at k = 20, 28
    and 84, 16b's also at 6, 18, 54 and 60, the multigrid's at 10 and
    19), as far as FULL_ROWS_K reaches (k = 6 to 84; from 33 to 64 on
    windows of 1024 columns or more, which the multigrid's 384 is not);
    a given
    col_block keeps the block routes, and without a table a block takes
    the route it took before."""
    n_tiles, window = SHARD_SHAPES[shape]
    cb = 32 if k <= 32 else 64
    got = band_grid(n_tiles, k, torch.float32, 132, rows=True,
                    window=window)
    before = band_grid(n_tiles, k, torch.float32, 132, window=window)
    rows = 6 <= k <= 84 and not (32 < k <= 64 and window < 1024)
    assert got == (("rows", cb, 8) if rows else before)
    assert before[0] == ("staged" if k <= 64 else "walk")
    assert band_grid(n_tiles, k, torch.float32, 132, col_block=cb,
                     rows=True, window=window)[0] == before[0]


ROLLING = [name for name in CASES if CASES[name][0] == "rolling"]


@pytest.mark.parametrize("k", [5, 20, 30])
@pytest.mark.parametrize("name", ROLLING)
def test_bf16_rolling_table_plain_reader_matches_plain_and_jax(ops, name,
                                                               k):
    """A bf16 rolling band's table (`with_precision("bf16")`), read by its
    plain reader (bf16 values, U rounded to bf16, fp32 sums), against
    `rolling_spmm_plain` in 'bf16' and the JAX package's Pallas kernel
    in interpret mode, which round U too, at rel 1e-5 (sums in another
    order), and against JAX's `rolling_spmm_reference` in 'bf16', which
    does not round U, at rel 4e-3 (as tests/test_torch_rolling.py
    holds the walk); the stored transpose too."""
    layout, Ap, top, jop = ops[name]
    b, jb = top.with_precision("bf16"), jop.with_precision("bf16")
    U = np.random.default_rng(k).normal(size=(b.n, k)).astype(np.float32)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    for op, t, j_op, _ in _pairs(layout, b, jb, Ap):
        assert t.val.dtype == torch.bfloat16
        W = table_spmm_plain(t, Ut, op.n).numpy()
        for other, tol in (
                (tsparse.rolling_spmm_plain(op, Ut).numpy(), 1e-5),
                (np.asarray(jsparse.rolling_spmm_pallas(j_op, Uj,
                                                        interpret=True)),
                 1e-5),
                (np.asarray(jsparse.rolling.rolling_spmm_reference(j_op,
                                                                   Uj)),
                 4e-3)):
            assert np.abs(W - other).max() <= tol * np.abs(other).max()


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("k", [3, 20])
@pytest.mark.parametrize("name", ROLLING)
def test_rows_gram_plain_matches_plain_and_pallas(ops, name, k, precision):
    """The row-wise route's Gram as its kernels sum it
    (`gram_partials_plain`: per 128-row tile partials of U^T W, rows in
    order, then the reduce's order), with W from the band's table and
    the unrounded U: each tile's partial and G against float64 sums at
    rel 1e-6; G against `rolling_spmm_gram_plain` at rel 1e-6 and
    against the JAX package's `rolling_spmm_gram_pallas(interpret=True)`
    at rel 1e-5 (sums in another order); the stored transpose too."""
    layout, Ap, top, jop = ops[name]
    top, jop = top.with_precision(precision), jop.with_precision(precision)
    U = np.random.default_rng(k).normal(size=(top.n, k)).astype(np.float32)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    for op, t, j_op, _ in _pairs(layout, top, jop, Ap):
        n_tiles = op.band.shape[0] // 128
        W = table_spmm_plain(t, Ut, op.n)
        partial, G = gram_partials_plain(Ut, W, n_tiles)
        assert partial.shape == (n_tiles, k, k) and G.shape == (k, k)
        U64 = np.zeros((n_tiles * 128, k))
        W64 = np.zeros((n_tiles * 128, k))
        U64[:op.n], W64[:op.n] = U, W.numpy()
        tiles = np.einsum("tri,trj->tij", U64.reshape(n_tiles, 128, k),
                          W64.reshape(n_tiles, 128, k))
        assert _rel_np(partial.numpy(), tiles) < 1e-6
        assert _rel_np(G.numpy(), tiles.sum(axis=0)) < 1e-6
        _, Gp = tsparse.rolling_spmm_gram_plain(op, Ut)
        assert _rel_np(G.numpy(), Gp.numpy()) < 1e-6
        _, Gj = jsparse.rolling_spmm_gram_pallas(j_op, Uj, interpret=True)
        assert _rel_np(G.numpy(), np.asarray(Gj)) < 1e-5


def _rel_np(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def split_cores():
    """The cloud's split operators (window 128) in both packages, built
    from one Hilbert permutation, in fp32 and bf16: {dtype: (torch core,
    JAX core)}, each a BandedELL; the torch core carries its table."""
    from eigenpinns_tpu.sparse import split as jsplit
    from eigenpinns_torch.sparse import split as tsplit

    X, L = _cloud_points(), _cloud()
    perm = tsplit.hilbert_order(X)
    out = {}
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        top, tperm = tsplit.SplitBanded.from_scipy(
            L, X=X, window=128, order=perm, dtype=tdt, device="cpu")
        jop, jperm = jsplit.SplitBanded.from_scipy(L, X=X, window=128,
                                                   order=perm, dtype=jdt)
        np.testing.assert_array_equal(tperm, jperm)
        out[tdt] = (top.core, jop.core)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [20, 60])
def test_full_band_table_gram_matches_plain_and_pallas(split_cores, k,
                                                       dtype):
    """K5's Gram on the row-wise route as its kernels sum it: W read from
    the split core's table (`table_spmm_plain`; a bf16 table rounds U),
    then `gram_partials_plain` (per 128-row tile partials of U^T W from
    the unrounded U, rows in order, then the reduce's order). Each tile's
    partial and G against float64 sums at rel 1e-6; G against
    `banded_spmm_gram_plain` at rel 1e-6 and against the JAX package's
    `banded_spmm_gram_pallas(interpret=True)` at rel 1e-5 (sums in
    another order); in bf16 W also against JAX's
    `banded_spmm_gram_reference`, which does not round U (F10), at rel
    4e-3."""
    core, jcore = split_cores[dtype]
    t = core.narrow
    assert t is not None and t.val.dtype == dtype
    U = np.random.default_rng(k).normal(size=(core.n, k)).astype(np.float32)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    n_tiles = core.band.shape[0] // 128
    W = table_spmm_plain(t, Ut, core.n)
    partial, G = gram_partials_plain(Ut, W, n_tiles)
    assert partial.shape == (n_tiles, k, k) and G.shape == (k, k)
    U64 = np.zeros((n_tiles * 128, k))
    W64 = np.zeros((n_tiles * 128, k))
    U64[:core.n], W64[:core.n] = U, W.numpy()
    tiles = np.einsum("tri,trj->tij", U64.reshape(n_tiles, 128, k),
                      W64.reshape(n_tiles, 128, k))
    assert _rel_np(partial.numpy(), tiles) < 1e-6
    assert _rel_np(G.numpy(), tiles.sum(axis=0)) < 1e-6
    _, Gp = tbanded.banded_spmm_gram_plain(core, Ut)
    assert _rel_np(G.numpy(), Gp.numpy()) < 1e-6
    _, Gj = jsparse.banded.banded_spmm_gram_pallas(jcore, Uj, interpret=True)
    assert _rel_np(G.numpy(), np.asarray(Gj)) < 1e-5
    if dtype == torch.bfloat16:
        Wr, _ = jsparse.banded.banded_spmm_gram_reference(jcore, Uj)
        assert _rel_np(W.numpy(), np.asarray(Wr)) < 4e-3


@pytest.fixture(scope="module")
def strips():
    """The cloud's strip-BSR K in both packages (the same RCM order), its
    bf16 copy by `with_precision` and a bf16 build."""
    from eigenpinns_tpu.sparse import bsr as jbsr

    A = _cloud()
    top, perm = tbsr.BSRTile.from_scipy(A, device="cpu")
    jop, jperm = jbsr.BSRTile.from_scipy(A)
    np.testing.assert_array_equal(perm, jperm)
    built = tbsr.BSRTile.from_scipy(A, dtype=torch.bfloat16, device="cpu")[0]
    return top, top.with_precision("bf16"), built, jop.with_precision("bf16")


def test_bf16_strip_table_is_the_fp32_table_rounded(strips):
    """`with_precision("bf16")` rounds the fp32 table's values to nearest
    even, as the strips are rounded, and shares its U rows and slices; a
    bf16 build lists its own strips' nonzeros, which here (no value
    rounds to 0) is the same table."""
    top, b, built, _ = strips
    t32, t16 = top.narrow, b.narrow
    assert t16.val.dtype == torch.bfloat16
    assert t16.idx is t32.idx and t16.slice_start is t32.slice_start
    assert torch.equal(t16.val, t32.val.bfloat16())
    live = t32.idx >= 0
    assert bool((t16.val[live] != 0).all())
    for a, c in ((built.narrow.val, t16.val), (built.narrow.idx, t16.idx),
                 (built.narrow.slice_start, t16.slice_start)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("k", [5, 20, 30])
def test_bf16_strip_table_plain_reader_matches_plain_and_pallas(strips, k):
    """A bf16 table's plain reader rounds U to bf16 and sums the exact
    products in fp32: against `bsr_spmm_plain` in 'bf16' and both JAX
    Pallas kernels in interpret mode, which round U too (ROADMAP F8), at
    rel 1e-5 (sums in another order)."""
    from eigenpinns_tpu.sparse import bsr as jbsr

    _, b, _, jb = strips
    U = np.random.default_rng(k).normal(size=(b.n, k)).astype(np.float32)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    W = table_spmm_plain(b.narrow, Ut, b.n).numpy()
    others = [tbsr.bsr_spmm_plain(b, Ut).numpy(),
              np.asarray(jbsr.bsr_spmm_pallas(jb, Uj, interpret=True))]
    if jb.gcid is not None:
        others.append(np.asarray(jbsr.bsr_spmm_pallas_grouped(
            jb, Uj, interpret=True)))
    for other in others:
        assert np.abs(W - other).max() <= 1e-5 * np.abs(other).max()


@pytest.mark.parametrize("dtype, k, col_block, want", [
    (torch.float32, 1, None, "narrow"),
    (torch.float32, 8, None, "narrow"),
    (torch.float32, 9, None, "rows"),
    (torch.float32, 28, None, "rows"),
    (torch.float32, 84, None, "rows"),
    (torch.float32, tbsr.ROWS_MAX_K, None, "rows"),
    (torch.float32, tbsr.ROWS_MAX_K + 1, None, "walk"),
    (torch.float32, 28, 32, "walk"),
    (torch.float32, 84, 64, "walk"),
    (torch.bfloat16, 28, None, "rows"),
    (torch.bfloat16, 1, None, "walk"),
    (torch.bfloat16, 7, None, "walk"),
    (torch.bfloat16, 8, None, "rows"),
    (torch.bfloat16, 20, None, "rows"),
    (torch.bfloat16, 128, None, "rows"),
    (torch.bfloat16, 129, None, "walk"),
    (torch.bfloat16, 20, 32, "walk")])
def test_strip_route_takes_the_table_on_fp32_strips(dtype, k, col_block,
                                                    want):
    """fp32 strips with col_block None read the narrow table: one lane a
    row up to NARROW_MAX_K, the row-wise route up to ROWS_MAX_K; bf16
    strips take the row-wise route over their bf16 table at BF16_ROWS_K
    (8 to 128) and the walk elsewhere; an explicit col_block takes the
    walk."""
    assert tbsr.strip_route(dtype, k, col_block) == want


def test_strip_route_refuses_what_the_kernels_cannot_take():
    f32, bf16 = torch.float32, torch.bfloat16
    assert tbsr.strip_route(f32, 200, route="rows") == "rows"
    assert tbsr.strip_route(bf16, 28, route="walk") == "walk"
    assert tbsr.strip_route(bf16, 200, route="rows") == "rows"
    for dtype, k, cb, route in ((bf16, 28, 32, "rows"),
                                (bf16, 4, None, "narrow"),
                                (f32, 28, 32, "rows"),
                                (f32, 9, None, "narrow"),
                                (f32, 257, None, "rows"),
                                (f32, 28, None, "staged")):
        with pytest.raises(ValueError):
            tbsr.strip_route(dtype, k, cb, route)


@pytest.mark.parametrize("n_tiles, k, dtype, gram, rows, want", [
    (2344, 84, torch.float32, False, True, ("rows", 64, 8)),   # K S
    (2344, BAND_ROWS_K[1], torch.float32, False, True, ("rows", 64, 8)),
    (2344, BAND_ROWS_K[1] + 1, torch.float32, False, True,
     ("walk", 64, 8)),
    (2344, 28, torch.float32, False, True, ("rows", 32, 8)),    # K X
    (2344, 20, torch.float32, False, True, ("rows", 32, 8)),
    (34, 10, torch.float32, False, True, ("rows", 32, 8)),      # K_blk
    (34, BAND_ROWS_K[0] - 1, torch.float32, False, True,
     ("staged", 32, 2)),
    (2344, 84, torch.float32, True, True, ("walk", 64, 8)),
    (2344, 28, torch.float32, True, True, ("staged", 32, 8)),
    (2344, 84, torch.float32, False, False, ("walk", 64, 8)),
    (2344, 28, torch.float32, False, False, ("staged", 32, 8)),
    (2344, 84, torch.bfloat16, False, True, ("rows", 32, 8)),
    (34, 10, torch.float32, True, True, ("rows", 32, 8)),       # K_blk, G
    (34, BAND_GRAM_ROWS_K[torch.float32][0] - 1, torch.float32, True, True,
     ("walk", 32, 8)),
    (2344, BAND_GRAM_ROWS_K[torch.float32][1] + 1, torch.float32, True,
     True, ("staged", 32, 8)),
    (34, 10, torch.float32, True, False, ("walk", 32, 8)),
    (2344, 20, torch.bfloat16, False, True, ("rows", 32, 8)),   # training
    (2344, 20, torch.bfloat16, True, True, ("rows", 32, 8)),    # with G
    (2344, BAND_BF16_ROWS_K[1], torch.bfloat16, False, True,
     ("rows", 32, 8)),
    (2344, BAND_BF16_ROWS_K[0] - 1, torch.bfloat16, False, True,
     ("walk", 32, 8)),
    (2344, BAND_BF16_ROWS_K[1] + 1, torch.bfloat16, False, True,
     ("walk", 32, 8)),
    (2344, BAND_GRAM_ROWS_K[torch.bfloat16][1] + 1, torch.bfloat16, True,
     True, ("walk", 32, 8)),
    (2344, 20, torch.bfloat16, True, False, ("walk", 32, 8))])
def test_band_grid_takes_the_rows_route(n_tiles, k, dtype, gram, rows,
                                        want):
    """A rolling band with a nonzero table takes the row-wise route in
    BAND_ROWS_K (fp32) or BAND_BF16_ROWS_K (bf16) without the Gram, and
    in BAND_GRAM_ROWS_K of its type with it; everything else (no table,
    other widths) is routed as before."""
    assert band_grid(n_tiles, k, dtype, 132, gram, rows=rows) == want


def test_band_grid_refuses_the_rows_route_where_it_cannot_run():
    """A forced row-wise route needs a band with its table, no warps and
    k <= ROWS_KERNEL_MAX_K, and takes the Gram on either band (rolling,
    or full window: K5) at k <= ROWS_GRAM_MAX_K; a given col_block or
    warps names a grid of the block routes, which the default then
    keeps."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert band_grid(34, 10, f32, 132, True, col_block=32,
                     rows=True) == ("walk", 32, 8)
    assert band_grid(2344, 20, bf16, 132, True, col_block=32,
                     rows=True) == ("walk", 32, 8)
    assert band_grid(2344, 84, f32, 132, True, route="rows",
                     rows=True) == ("rows", 64, 8)
    assert band_grid(2344, ROWS_GRAM_MAX_K, bf16, 132, True, route="rows",
                     rows=True) == ("rows", 32, 8)
    assert band_grid(2344, 28, f32, 132, col_block=32,
                     rows=True) == ("staged", 32, 8)
    assert band_grid(2344, 84, f32, 132, col_block=64,
                     rows=True) == ("walk", 64, 8)
    assert band_grid(34, 10, f32, 132, warps=4,
                     rows=True) == ("staged", 32, 4)
    assert band_grid(2344, 28, f32, 132, route="rows",
                     rows=True) == ("rows", 32, 8)
    assert band_grid(2344, 84, bf16, 132, route="rows", rows=True,
                     window=512) == ("rows", 32, 8)
    assert band_grid(2344, 84, f32, 132, True, route="rows", rows=True,
                     window=1024) == ("rows", 64, 8)
    assert band_grid(2344, 20, bf16, 132, True, route="rows", rows=True,
                     window=512) == ("rows", 32, 8)
    assert band_grid(2344, 20, bf16, 132, True, col_block=32, rows=True,
                     window=512) == ("walk", 32, 8)
    for kw in (dict(dtype=bf16, rows=False), dict(dtype=f32, rows=False),
               dict(dtype=f32, rows=True, with_gram=True, window=1024,
                    k=ROWS_GRAM_MAX_K + 1),
               dict(dtype=bf16, rows=False, with_gram=True, window=512,
                    k=20),
               dict(dtype=f32, rows=True, with_gram=True,
                    k=ROWS_GRAM_MAX_K + 1),
               dict(dtype=f32, rows=True, warps=2),
               dict(dtype=f32, rows=True, k=257)):
        kw = {"k": 84, **kw}
        with pytest.raises(ValueError, match="row-wise"):
            band_grid(2344, kw.pop("k"), kw.pop("dtype"), 132,
                      route="rows", **kw)


@pytest.mark.parametrize("k, dtype, gram, rows, window, want", [
    (20, torch.float32, False, True, 1024, ("rows", 32, 8)),   # spectral X
    (28, torch.float32, False, True, 1024, ("rows", 32, 8)),
    (60, torch.float32, False, True, 1024, ("rows", 64, 8)),   # spectral S
    (84, torch.float32, False, True, 1024, ("rows", 64, 8)),
    (6, torch.float32, False, True, 1024, ("rows", 32, 8)),
    (10, torch.float32, False, True, 384, ("rows", 32, 8)),
    (5, torch.float32, False, True, 1024, ("staged", 32, 8)),
    (85, torch.float32, False, True, 1024, ("walk", 64, 8)),
    (84, torch.float32, True, True, 1024, ("rows", 64, 8)),    # K5
    (28, torch.float32, True, True, 1024, ("rows", 32, 8)),
    (28, torch.float32, False, False, 1024, ("staged", 32, 8)),
    (20, torch.float32, False, True, 512, ("rows", 32, 8)),
    (28, torch.float32, False, True, 512, ("rows", 32, 8)),    # polish K X
    (32, torch.float32, False, True, 512, ("rows", 32, 8)),
    (33, torch.float32, False, True, 512, ("staged", 64, 8)),
    (60, torch.float32, False, True, 512, ("staged", 64, 8)),
    (64, torch.float32, False, True, 896, ("staged", 64, 8)),
    (33, torch.float32, False, True, 1024, ("rows", 64, 8)),
    (65, torch.float32, False, True, 512, ("rows", 64, 8)),
    (84, torch.float32, False, True, 512, ("rows", 64, 8)),    # polish K S
    (20, torch.bfloat16, False, True, 512, ("rows", 32, 8)),   # K4 backward
    (28, torch.bfloat16, False, True, 512, ("rows", 32, 8)),
    (19, torch.bfloat16, False, True, 512, ("walk", 32, 8)),
    (29, torch.bfloat16, False, True, 512, ("walk", 32, 8)),
    (20, torch.bfloat16, True, True, 512, ("rows", 32, 8)),    # K5
    (20, torch.bfloat16, False, False, 512, ("walk", 32, 8)),
    (60, torch.float32, True, True, 1024, ("rows", 64, 8)),    # K5 cluster
    (60, torch.float32, True, True, 512, ("rows", 64, 8)),
    (F32_GRAM[0], torch.float32, True, True, 1024, ("rows", 32, 8)),
    (F32_GRAM[0] - 1, torch.float32, True, True, 1024, ("staged", 32, 8)),
    (F32_GRAM[1], torch.float32, True, True, 512, ("rows", 64, 8)),
    (F32_GRAM[1] + 1, torch.float32, True, True, 1024, ("walk", 64, 8)),
    (60, torch.float32, True, False, 1024, ("staged", 64, 8)),
    (BF16_GRAM[0], torch.bfloat16, True, True, 512, ("rows", 32, 8)),
    (BF16_GRAM[0] - 1, torch.bfloat16, True, True, 512, ("walk", 32, 8)),
    (BF16_GRAM[1], torch.bfloat16, True, True, 512, ("rows", 32, 8)),
    (BF16_GRAM[1] + 1, torch.bfloat16, True, True, 512, ("walk", 32, 8)),
    (20, torch.bfloat16, True, False, 512, ("walk", 32, 8))])
def test_band_grid_takes_the_rows_route_on_full_bands(k, dtype, gram, rows,
                                                      window, want):
    """A full-window band with its table (`BandedELL.narrow`) takes the
    row-wise route in FULL_ROWS_K of its type, without the Gram: fp32 at
    k = 6 to 84, bf16 at k = 20 to 28; in fp32 where the staged route
    would run one block of 64 columns (32 < k <= 64) only on a window of
    FULL_ROWS_MIN_WINDOW_64 (1024) columns or more (the cluster cores,
    not the Hilbert core's 512); with the Gram (K5) in FULL_GRAM_ROWS_K
    of its type, on any window (fp32 k = 10 to 84, bf16 12 to 28: the
    fused-Gram training's k = 20 and the cluster cores' k = 60);
    elsewhere, or without a table, the routes it took before. A rolling
    band of the same type and width keeps its own widths (with the Gram
    too)."""
    assert band_grid(2344, k, dtype, 132, gram, rows=rows,
                     window=window) == want
    rolling = band_grid(2344, k, dtype, 132, gram, rows=rows)
    lo, hi = (BAND_GRAM_ROWS_K[dtype] if gram else BAND_ROWS_K
              if dtype == torch.float32 else BAND_BF16_ROWS_K)
    assert (rolling[0] == "rows") == (rows and lo <= k <= hi)
