"""The occupancy tables the port's CUDA kernels walk (which 16 x 16
sub-blocks of the dense strip-BSR tiles and of the band hold a nonzero).

The tables are derived on the device from the dense tensors; here they
are held, on the CPU, to the occupancy computed independently from the
scipy matrix's nonzero triplets and the layout tables:

  * equal, bit for bit, for `BSRTile.from_scipy` (with and without group
    tables, with `pad_rows_to` / `pad_chunks_to`, a nonsymmetric matrix's
    stored transpose), `BandedELL.from_scipy` (and its transpose) and
    both `SplitBanded` orders (no matrix here stores an explicit zero);
  * a "masked plain" product (the dense data zeroed wherever the table's
    bit is clear, then the plain version) equals the plain product
    exactly, in fp32 and bf16: a clear bit never hides a nonzero;
  * `with_precision` round trips keep a table that covers the copy's
    nonzeros; pad slots and pad chunks have word 0;
  * the kernel wrappers refuse an operator without its table.

No JAX here: the layout itself is held to the JAX package byte for byte
by tests/test_torch_bsr.py, test_torch_banded.py and test_torch_split.py.
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
from eigenpinns_torch.sparse.occupancy import occupancy_mask, occupied_blocks

torch.set_num_threads(2)


def _sym700():
    n = 700
    A = sp.random(n, n, density=0.01, random_state=1, format="csr")
    return (A + A.T + sp.diags(np.ones(n) * 2.0)).tocsr()


def _asym800():
    r = np.random.default_rng(9)
    n = 800
    rows = r.integers(0, n, 4 * n)
    cols = np.clip(rows + r.integers(-90, 90, 4 * n), 0, n - 1)
    A = sp.coo_matrix((r.normal(size=4 * n), (rows, cols)),
                      shape=(n, n)).tocsr()
    return (A + sp.diags(np.full(n, 4.0))).tocsr()


def _cloud(n=900, seed=20240818):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X, point_cloud_laplacian(X, n_neighbors=12)[0].tocsr()


def _bits(rows, cols):
    """Bit 8 i + j of the sub-block holding local (row, col) of a piece."""
    return (np.uint64(1) << (8 * ((rows % 128) // 16)
                             + (cols % 128) // 16).astype(np.uint64))


def _as_u64(mask: torch.Tensor) -> np.ndarray:
    return mask.numpy().view(np.uint64)


def _expand(mask: torch.Tensor) -> torch.Tensor:
    """The table as a dense bool tensor (R*128, Q*128)."""
    m = _as_u64(mask)
    R, Q = m.shape
    bits = (m[:, :, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    sub = bits.reshape(R, Q, 8, 8).transpose(0, 2, 1, 3).astype(bool)
    dense = np.repeat(np.repeat(sub.reshape(R * 8, Q * 8), 16, 0), 16, 1)
    return torch.from_numpy(dense)


def _bsr_expected(op, Ap):
    """Occupancy of a strip-BSR operator from the triplets of the matrix
    it stores (`Ap`, in the operator's own order)."""
    rowid, cid, nv = op.rowid.numpy(), op.cid.numpy(), op.nv.numpy()
    slot_of = {}
    for s in range(op.n_chunks):
        for j in range(int(nv[s])):          # real slots only
            slot_of[int(rowid[s]), int(cid[s, j])] = (s, j)
    coo = Ap.tocoo()
    want = np.zeros(cid.shape, np.uint64)
    for r, c, b in zip(coo.row, coo.col, _bits(coo.row, coo.col)):
        want[slot_of[r // 128, c // 128]] |= b
    return want


BSR_CASES = {
    "grouped": (_sym700, {}),
    "no_group_tables": (_sym700, {"group": 0}),
    "pad_rows": (_sym700, {"pad_rows_to": 1024, "static_layout": False}),
    "pad_chunks": (_sym700, {"pad_chunks_to": 60, "with_transpose": False}),
    "nonsymmetric": (_asym800, {}),
    "cloud": (lambda: _cloud(642, 7)[1], {}),
}


@pytest.fixture(scope="module")
def bsr_ops():
    out = {}
    for case, (make, kw) in BSR_CASES.items():
        A = make()
        op, perm = tbsr.BSRTile.from_scipy(A, device="cpu", **kw)
        Ap = A[perm][:, perm].tocsr()
        Ap.resize(op.n, op.n_cols)
        out[case] = (op, Ap)
    return out


@pytest.mark.parametrize("case", list(BSR_CASES))
def test_bsr_occupancy_matches_triplets(bsr_ops, case):
    op, Ap = bsr_ops[case]
    assert op.occupancy.dtype == torch.int64
    assert op.occupancy.shape == op.cid.shape
    np.testing.assert_array_equal(_as_u64(op.occupancy), _bsr_expected(op, Ap))
    # Pad slots (and whole pad chunks) hold word 0.
    pad = (torch.arange(op.chunk)[None, :] >= op.nv[:, None])
    assert int(op.occupancy[pad].abs().sum()) == 0
    if case == "pad_chunks":
        assert op.n_chunks == 60 and int(op.nv[-1]) == 0
        assert int(op.occupancy[-1].abs().sum()) == 0
    if case == "no_group_tables":
        assert op.gcid is None
    if case == "nonsymmetric":
        t = op.transpose_bsr
        assert t is not None
        np.testing.assert_array_equal(_as_u64(t.occupancy),
                                      _bsr_expected(t, Ap.T.tocsr()))


def _band_expected(op, rows, local):
    want = np.zeros((op.band.shape[0] // 128, op.bandwidth // 128), np.uint64)
    np.bitwise_or.at(want, (rows // 128, local // 128), _bits(rows, local))
    return want


def _band_triplets(op, Ap):
    coo = Ap.tocoo()
    return coo.row, coo.col - op.starts.numpy()[coo.row // 128]


@pytest.mark.parametrize("case", ["cloud", "nonsymmetric"])
def test_banded_occupancy_matches_triplets(case):
    if case == "cloud":
        A, kw = _cloud(642, 7)[1], {}
    else:
        A, kw = _asym800(), {"reorder": False}
    op, perm = tbanded.BandedELL.from_scipy(A, device="cpu", **kw)
    Ap = A[perm][:, perm].tocsr()
    assert op.occupancy.shape == (op.band.shape[0] // 128,
                                  op.bandwidth // 128)
    np.testing.assert_array_equal(
        _as_u64(op.occupancy), _band_expected(op, *_band_triplets(op, Ap)))
    if case == "nonsymmetric":
        t = op.transpose_banded
        np.testing.assert_array_equal(
            _as_u64(t.occupancy),
            _band_expected(t, *_band_triplets(t, Ap.T.tocsr())))


@pytest.mark.parametrize("order", ["cluster", "hilbert"])
def test_split_core_occupancy_matches_triplets(order):
    X, L = _cloud()
    op, perm = tsparse.SplitBanded.from_scipy(L, X=X, window=256, order=order,
                                              n_clusters=6, device="cpu")
    core = op.core
    rows, local = _band_triplets(core, L[perm][:, perm].tocsr())
    # The core keeps an entry when it and its mirror fit their windows.
    coo = L[perm][:, perm].tocoo()
    mirror = coo.row - core.starts.numpy()[coo.col // 128]
    B = core.bandwidth
    keep = (local >= 0) & (local < B) & (mirror >= 0) & (mirror < B)
    assert op.remainder is not None and 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(
        _as_u64(core.occupancy), _band_expected(core, rows[keep], local[keep]))
    assert occupied_blocks(core.occupancy) == int(
        sum(bin(int(w)).count("1") for w in _as_u64(core.occupancy).ravel()))


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("case", ["grouped", "pad_chunks", "nonsymmetric"])
def test_bsr_masked_plain_equals_plain(bsr_ops, case, precision):
    """Zeroing the strips wherever the table's bit is clear changes
    nothing: no clear bit lies over a nonzero."""
    op = bsr_ops[case][0].with_precision(precision)
    keep = _expand(op.occupancy)
    masked = dataclasses.replace(
        op, data=torch.where(keep, op.data, torch.zeros_like(op.data)))
    assert torch.equal(masked.data, op.data)
    U = torch.from_numpy(np.random.default_rng(3).normal(
        size=(op.n_cols, 7)).astype(np.float32))
    assert torch.equal(tbsr.bsr_spmm_plain(masked, U),
                       tbsr.bsr_spmm_plain(op, U))
    # and the table is not trivially full
    assert occupied_blocks(op.occupancy) < 64 * op.n_slots


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_masked_plain_equals_plain(dtype):
    X, L = _cloud()
    core = tsparse.SplitBanded.from_scipy(L, X=X, window=256, order="hilbert",
                                          dtype=dtype, device="cpu")[0].core
    keep = _expand(core.occupancy)
    masked = dataclasses.replace(
        core, band=torch.where(keep, core.band, torch.zeros_like(core.band)))
    assert torch.equal(masked.band, core.band)
    U = torch.from_numpy(np.random.default_rng(4).normal(
        size=(core.n, 6)).astype(np.float32))
    for a, b in zip(tbanded.banded_spmm_gram_plain(masked, U),
                    tbanded.banded_spmm_gram_plain(core, U)):
        assert torch.equal(a, b)
    assert occupied_blocks(core.occupancy) < 64 * core.occupancy.numel()


def test_with_precision_keeps_a_covering_table(bsr_ops):
    """fp32 -> bf16 -> fp32: every copy's nonzeros lie under set bits of
    the table it carries (rounding to bf16 adds no nonzero), and the
    transpose's table travels with it."""
    op = bsr_ops["nonsymmetric"][0]
    b = op.with_precision("bf16")
    h = b.with_precision("highest")
    for o in (b, h, b.transpose_bsr, h.transpose_bsr):
        assert o.occupancy is not None
        keep = _expand(o.occupancy)
        assert int((o.data.float().ne(0) & ~keep).sum()) == 0
    assert b.occupancy is op.occupancy
    # A bf16 build takes its table from the bf16 strips: the same here.
    A = _asym800()
    direct, _ = tbsr.BSRTile.from_scipy(A, dtype=torch.bfloat16, device="cpu")
    assert torch.equal(direct.occupancy, op.occupancy)


def test_occupancy_mask_bit_order_and_shape_check():
    d = torch.zeros(256, 384)
    d[16, 0] = 1.0        # piece (0, 0): stripe 1, group 0 -> bit 8
    d[127, 127] = 2.0     # piece (0, 0): last sub-block -> bit 63
    d[128, 383] = -1.0    # piece (1, 2): stripe 0, group 7 -> bit 7
    d[200, 130] = float("nan")   # piece (1, 1): stripe 4, group 0 -> bit 32
    m = _as_u64(occupancy_mask(d))
    want = np.zeros((2, 3), np.uint64)
    want[0, 0] = (1 << 8) | (1 << 63)
    want[1, 2] = 1 << 7
    want[1, 1] = 1 << 32
    np.testing.assert_array_equal(m, want)
    assert occupied_blocks(occupancy_mask(d)) == 4
    with pytest.raises(ValueError, match="multiples of 128"):
        occupancy_mask(torch.zeros(100, 128))


def test_cuda_wrappers_refuse_an_operator_without_its_table(bsr_ops):
    """No dense fallback: without the table the wrappers raise."""
    op = dataclasses.replace(bsr_ops["grouped"][0], occupancy=None)
    U = torch.zeros(op.n_cols, 3)
    for launch in (tbsr.bsr_spmm_grouped_cuda, tbsr.bsr_spmm_burst_cuda):
        with pytest.raises(ValueError, match="occupancy"):
            launch(op, U)
    band = dataclasses.replace(
        tbanded.BandedELL.from_scipy(_sym700(), device="cpu")[0],
        occupancy=None)
    for with_gram in (False, True):
        with pytest.raises(ValueError, match="occupancy"):
            tbanded.banded_spmm_cuda(band, torch.zeros(band.n, 3),
                                     with_gram=with_gram)


@pytest.mark.parametrize("k, want", [(1, 32), (20, 32), (28, 32), (32, 32),
                                     (33, 64), (60, 64), (128, 64)])
def test_default_col_block(k, want):
    """fp32 data: 32 columns per block up to k = 32, then 64; bf16: 32."""
    for mod in (tbsr, tbanded):
        assert mod.default_col_block(k, torch.float32) == want
        assert mod.default_col_block(k, torch.bfloat16) == 32
