"""The narrow path's table of strip-BSR (`BSRTile.narrow`) against the
JAX package's layout and the scipy triplets.

The narrow kernel (fp32 strips, k <= NARROW_MAX_K) reads the operator's
nonzeros as a sliced ELL, each row in the order in which the column-block
walk sums it, so that it gives the walk's bits. The kernel itself runs
only on a card (tests/test_torch_cuda.py); here the table is checked on
the CPU:

  * it lists every nonzero of the strips once, bit for bit, with its U
    row, in the walk's order (slot, sub-block column group, column),
    derived independently from the JAX package's `BSRTile.from_scipy`
    layout, and its live entries are the permuted matrix's triplets;
    padding is a zero value with index -1 after each row's entries;
  * a plain reader of the table (`narrow_spmm_plain`) equals
    `bsr_spmm_plain` and JAX's `bsr_spmm_reference` at rel 1e-6 (fp32,
    sums in another order);
  * `with_precision` gives bf16 strips the fp32 table with its values
    rounded, and an fp32 upcast the table of the rounded strips;
  * the wrappers raise on an operator without it, and the grid of the
    walk follows the card's SM count.

Cases: the RCM-ordered point-cloud Laplacian, the asymmetric n = 800
operator (and its stored transpose) of tests/test_torch_bsr.py, the same
operator with pad chunks, and a rectangular 700 x 450 matrix.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu.geometry import point_cloud_laplacian as j_pcl
from eigenpinns_tpu.sparse import bsr as jbsr
from eigenpinns_torch.sparse import bsr as tbsr

torch.set_num_threads(2)


def _cloud642():
    r = np.random.default_rng(7)
    X = r.normal(size=(642, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return j_pcl(X, n_neighbors=12)[0].tocsr()


def _asym800():
    r = np.random.default_rng(9)
    n = 800
    rows = r.integers(0, n, 4 * n)
    cols = np.clip(rows + r.integers(-90, 90, 4 * n), 0, n - 1)
    return sp.coo_matrix((r.normal(size=4 * n), (rows, cols)),
                         shape=(n, n)).tocsr()


def _rect():
    return sp.random(700, 450, density=0.02, random_state=4, format="csr")


# case -> (matrix, from_scipy keyword arguments)
CASES = {
    "cloud642": (_cloud642, {}),
    "asym800": (_asym800, {}),
    "asym800_pad_chunks": (_asym800, {"with_transpose": False,
                                      "pad_chunks_to": 40}),
    "rect700x450": (_rect, {"reorder": False, "with_transpose": False}),
}


@pytest.fixture(scope="module")
def ops():
    out = {}
    for case, (make, kw) in CASES.items():
        A = make()
        jop, perm = jbsr.BSRTile.from_scipy(A, **kw)
        top, _ = tbsr.BSRTile.from_scipy(A, device="cpu", **kw)
        out[case] = (A[perm][:, perm] if kw.get("reorder", True) else A,
                     jop, top)
    return out


def _rows_of(t):
    """Each table entry's row, and its rank within the row."""
    width = np.diff(t.slice_start.numpy()) // 32
    e = np.arange(t.val.numel())
    slice_of = np.repeat(np.arange(t.n_slices), width * 32)
    offset = e - t.slice_start.numpy()[slice_of]
    return slice_of * 32 + offset % 32, offset // 32


def _walk_lists(jop):
    """Per row, (values, U rows) in the walk's order, from the JAX
    package's layout: a row tile's chunks in order, in each the slots in
    order and in each slot the columns in order, zeros skipped."""
    data = np.asarray(jop.data, np.float32)
    cid, rowid = np.asarray(jop.cid), np.asarray(jop.rowid)
    T, C = jop.tile, cid.shape[1]
    S = cid.shape[0]
    strips = data.reshape(S, T, C * T)
    urow = (cid[:, :, None] * T + np.arange(T)).reshape(S, C * T)
    out = {}
    for r in np.unique(rowid):
        chunks = np.where(rowid == r)[0]
        vals = strips[chunks].transpose(1, 0, 2).reshape(T, -1)
        rows_u = urow[chunks].reshape(-1)
        for rr in range(T):
            nz = np.nonzero(vals[rr])[0]
            if nz.size:
                out[r * T + rr] = (vals[rr, nz], rows_u[nz])
    return out


def _check_table(top, jop, Ap):
    t = top.narrow
    assert t is not None
    val, idx = t.val.numpy(), t.idx.numpy()
    assert t.n_slices * 32 >= top.n and t.slice_start[0] == 0
    assert np.all(np.diff(t.slice_start.numpy()) % 32 == 0)
    row, rank = _rows_of(t)
    live = idx >= 0
    assert np.all(val[~live] == 0)
    # The live entries of each row come first, then its padding.
    counts = np.bincount(row[live], minlength=t.n_slices * 32)
    assert np.array_equal(live, rank < counts[row])
    # Every nonzero once, in the walk's order, bit for bit.
    walk = _walk_lists(jop)
    assert int(live.sum()) == sum(v.size for v, _ in walk.values())
    order = np.lexsort((rank, row))
    order = order[live[order]]
    starts = np.concatenate(([0], np.cumsum(counts)))
    for r, (v, u) in walk.items():
        sel = order[starts[r]:starts[r + 1]]
        assert np.array_equal(val[sel].view(np.int32), v.view(np.int32)), r
        assert np.array_equal(idx[sel], u), r
    # The live entries are the (permuted) matrix's triplets.
    coo = sp.coo_matrix(Ap)
    want = sorted(zip(coo.row.tolist(), coo.col.tolist(),
                      coo.data.astype(np.float32).tolist()))
    got = sorted(zip(row[live].tolist(), idx[live].tolist(),
                     val[live].tolist()))
    assert got == want


@pytest.mark.parametrize("case", list(CASES))
def test_narrow_table_lists_every_nonzero_in_walk_order(ops, case):
    Ap, jop, top = ops[case]
    _check_table(top, jop, Ap)
    if case == "asym800":
        assert jop.transpose_bsr is not None
        _check_table(top.transpose_bsr, jop.transpose_bsr, Ap.T)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("case", list(CASES))
def test_narrow_plain_reader_matches_plain_and_jax(ops, case, k):
    _, jop, top = ops[case]
    U = np.random.default_rng(k).normal(
        size=(top.n_cols, k)).astype(np.float32)
    W = tbsr.narrow_spmm_plain(top, torch.from_numpy(U)).numpy()
    Wp = tbsr.bsr_spmm_plain(top, torch.from_numpy(U)).numpy()
    ref = np.asarray(jbsr.bsr_spmm_reference(jop, jnp.asarray(U)))
    for other in (Wp, ref):
        assert np.abs(W - other).max() <= 1e-6 * np.abs(other).max()


def test_narrow_table_follows_with_precision(ops):
    """bf16 strips carry the fp32 table with its values rounded to bf16,
    sharing its U rows and slices; the upcast back to fp32 gives the
    table a fresh build of the rounded strips gives (transpose too); the
    same fp32 strips keep theirs."""
    _, _, top = ops["asym800"]
    b = top.with_precision("bf16")
    for o, f in ((b, top), (b.transpose_bsr, top.transpose_bsr)):
        assert o.narrow.idx is f.narrow.idx
        assert o.narrow.slice_start is f.narrow.slice_start
        assert torch.equal(o.narrow.val, f.narrow.val.bfloat16())
    h = b.with_precision("highest")
    for o in (h, h.transpose_bsr):
        fresh = tbsr.narrow_table(o.data, o.occupancy, o.rowid, o.cid,
                                  o.n_row_tiles)
        assert torch.equal(o.narrow.val, fresh.val)
        assert torch.equal(o.narrow.idx, fresh.idx)
        assert torch.equal(o.narrow.slice_start, fresh.slice_start)
    live = h.narrow.idx >= 0
    assert torch.equal(h.narrow.val[live],
                       top.narrow.val[live].bfloat16().float())
    assert top.with_precision("high").narrow is top.narrow
    assert top.with_precision("highest").transpose_bsr.narrow is (
        top.transpose_bsr.narrow)


def test_narrow_path_raises_without_its_table(ops):
    """No fallback: the narrow path and the row-wise route (fp32 strips,
    k <= ROWS_MAX_K, bf16 strips at BF16_ROWS_K, col_block None) refuse
    an operator without the table; the walk (an explicit col_block, a
    wider k, bf16 strips past BF16_ROWS_K) does not need it."""
    _, _, top = ops["cloud642"]
    bare = dataclasses.replace(top, narrow=None)
    bare16 = dataclasses.replace(top.with_precision("bf16"), narrow=None)
    for launch in (tbsr.bsr_spmm_grouped_cuda, tbsr.bsr_spmm_burst_cuda):
        for op, k in [(bare, k) for k in (
                1, tbsr.NARROW_MAX_K, tbsr.NARROW_MAX_K + 1, 84,
                tbsr.ROWS_MAX_K)] + [(bare16, k) for k in tbsr.BF16_ROWS_K]:
            with pytest.raises(ValueError, match="narrow table"):
                launch(op, torch.zeros(top.n, k))
        for op, k, cb in ((bare, 1, 32), (bare, tbsr.ROWS_MAX_K + 1, None),
                          (top.with_precision("bf16"), 1, None)):
            with pytest.raises(ValueError, match="CUDA"):
                launch(op, torch.zeros(top.n, k), col_block=cb)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tbsr.narrow_table(top.data.half(), top.occupancy, top.rowid,
                          top.cid, top.n_row_tiles)


@pytest.mark.parametrize("n_rt, k, dtype, cb, want", [
    (2000, 20, torch.bfloat16, None, (32, 8)),
    (2000, 60, torch.float32, None, (64, 8)),
    (264, 64, torch.float32, None, (64, 8)),
    (157, 60, torch.float32, None, (32, 8)),
    (157, 20, torch.float32, None, (32, 4)),
    (35, 64, torch.float32, None, (32, 2)),
    (35, 64, torch.bfloat16, None, (32, 2)),
    (35, 64, torch.float32, 64, (64, 2)),
    (132, 64, torch.float32, 64, (64, 4)),
    (5, 128, torch.float32, None, (32, 2))])
def test_walk_grid_fills_the_card(monkeypatch, n_rt, k, dtype, cb, want):
    """The default column block and 8 stripes a block, unless row tiles x
    column blocks give fewer than two blocks an SM (132 SMs, as an H100
    has): then 32 columns, and 4 or 2 stripes a block; an explicit
    column block is kept."""
    monkeypatch.setattr(tbsr, "_sm_count", lambda device: 132)
    A = types.SimpleNamespace(
        n_row_tiles=n_rt,
        data=types.SimpleNamespace(device="cuda:0", dtype=dtype))
    assert tbsr.walk_grid(A, k, cb) == want
