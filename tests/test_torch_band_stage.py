"""The host side of the band kernels' staged route (csrc/banded_spmm.cu),
against the JAX package's layouts.

On an fp32 band whose product fits one column block, a block of the band
kernel owns 8, 4 or 2 of a tile's stripes and stages, for each 128-column
piece of the tile's window, the 16-row U groups that any of its stripes
needs (the OR of their occupancy bytes) once, by asynchronous copies: a
whole group at a 16-byte aligned start by one bulk copy, any other by
the lanes, with the rows outside U zero-filled. The kernel runs only on
a card (tests/test_torch_cuda.py); here, on the CPU:

  * `band_grid`: the route, column block and stripes a block for the
    multigrid K_blk (2-warp blocks on 132 SMs) and the 300k and 1M
    cluster cores (8), and the choices it refuses;
  * `stage_unions` equals the OR of the stripe bytes of an occupancy
    table derived from the JAX package's dense band, block by block in
    piece order, for every grid;
  * `stage_group_rows` puts every nonzero of the JAX band at its column
    of the matrix (the triplets), for the full-window and the rolling
    layouts (windows above row 0 and past n included);
  * `stage_group_classes` against an independent count of whole and
    aligned groups, at odd and even k;
  * `band_u_bytes` of both routes, and a numpy emulation of the staged
    product (slots filled from the classes' rows, zero-filled outside
    U) against the port's plain version and the JAX references.
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
from eigenpinns_torch.sparse.occupancy import band_grid, occupancy_mask
from eigenpinns_torch.utils.fixtures import adversarial_rolling_matrix

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _cloud():
    X = np.random.default_rng(20240818).normal(size=(900, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return point_cloud_laplacian(X, n_neighbors=12)[0].tocsr()


def _asym800():
    r = np.random.default_rng(9)
    n = 800
    rows = r.integers(0, n, 4 * n)
    cols = np.clip(rows + r.integers(-90, 90, 4 * n), 0, n - 1)
    A = sp.coo_matrix((r.normal(size=4 * n), (rows, cols)),
                      shape=(n, n)).tocsr()
    return (A + sp.diags(np.full(n, 4.0))).tocsr()


# (layout, matrix, reorder): the cloud Laplacian in both layouts (RCM),
# the nonsymmetric band in both, and the adversarial rolling operator
# (windows before row 0 and past n, a word with only bit 63 set).
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
        out[name] = (layout, A[perm][:, perm].tocoo(), top, jop)
    return out


def _stripe_bytes(band: np.ndarray) -> np.ndarray:
    """(T, P, 8) uint8 from a dense (T*128, P*128) band: byte i of piece
    (t, p) has bit j set when its sub-block (i, j) holds a nonzero."""
    T, P = band.shape[0] // 128, band.shape[1] // 128
    nz = (band != 0).reshape(T, 8, 16, P, 8, 16).any(axis=(2, 5))
    weights = (1 << np.arange(8)).astype(np.uint8)
    return (nz.transpose(0, 2, 1, 3) * weights).sum(-1).astype(np.uint8)


def _group_rows(layout, top):
    n_tiles = top.band.shape[0] // 128
    if layout == "rolling":
        return tbanded.stage_group_rows(n_tiles, top.band.shape[1],
                                        pre=top.pre)
    return tbanded.stage_group_rows(n_tiles, top.band.shape[1], top.starts)


@pytest.mark.parametrize("n_tiles, k, dtype, gram, cb, want", [
    (34, 10, torch.float32, False, None, ("staged", 32, 2)),    # K_blk
    (34, 10, torch.float32, True, None, ("walk", 32, 8)),
    (21, 39, torch.float32, True, None, ("staged", 64, 8)),     # K_finest
    (2344, 60, torch.float32, False, None, ("staged", 64, 8)),  # 300k
    (7813, 60, torch.float32, False, None, ("staged", 64, 8)),  # 1M
    (7813, 60, torch.float32, True, None, ("staged", 64, 8)),
    (2344, 20, torch.float32, False, None, ("staged", 32, 8)),
    (132, 20, torch.float32, False, None, ("staged", 32, 4)),
    (131, 20, torch.float32, False, None, ("staged", 32, 2)),
    (34, 60, torch.float32, False, 32, ("walk", 32, 8)),
    (2344, 84, torch.float32, False, None, ("walk", 64, 8)),
    (2344, 20, torch.bfloat16, False, None, ("walk", 32, 8)),
    (34, 10, torch.bfloat16, False, None, ("walk", 32, 8))])
def test_band_grid_routes_and_fills_the_card(n_tiles, k, dtype, gram, cb,
                                             want):
    """The staged route for an fp32 band whose product fits one column
    block, on 8 stripes a block unless the tiles give fewer than two
    blocks an SM (132 SMs, as an H100 has): then 4 or 2; with the Gram
    8, and on such a small operator at 32 columns the walk. The walk
    otherwise, 8 stripes a block."""
    assert band_grid(n_tiles, k, dtype, 132, gram, cb) == want


def test_band_grid_refuses_what_the_kernels_cannot_take():
    """Forced choices are kept when the kernels take them and raise
    otherwise."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert band_grid(2344, 60, f32, 132, warps=2) == ("staged", 64, 2)
    assert band_grid(34, 10, f32, 132, route="walk") == ("walk", 32, 8)
    assert band_grid(34, 10, f32, 132, col_block=64) == ("staged", 64, 2)
    assert band_grid(34, 10, f32, 132, True, route="staged") == (
        "staged", 32, 8)
    for kw in (dict(k=20, dtype=bf16, route="staged"),
               dict(k=60, dtype=f32, col_block=32, route="staged"),
               dict(k=10, dtype=f32, route="walk", warps=2),
               dict(k=10, dtype=f32, with_gram=True, warps=4),
               dict(k=10, dtype=f32, warps=3),
               dict(k=10, dtype=f32, col_block=48),
               dict(k=10, dtype=f32, route="tiles")):
        k, dtype = kw.pop("k"), kw.pop("dtype")
        with pytest.raises(ValueError):
            band_grid(34, k, dtype, 132, **kw)


@pytest.mark.parametrize("warps", [8, 4, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_stage_unions_are_the_or_of_the_stripe_bytes(ops, name, warps):
    """Block b of a launch (tile b // (8 / warps), stripes warps * (b %
    (8 / warps)) onward) stages, for piece p, the groups of the OR of its
    stripes' bytes; the bytes come from the JAX package's dense band."""
    _, _, top, jop = ops[name]
    jband = np.array(jop.band, dtype=np.float32)
    table = occupancy_mask(torch.from_numpy(jband))
    assert torch.equal(table, top.occupancy)
    b = _stripe_bytes(jband)                          # (T, P, 8)
    T, P, _ = b.shape
    parts = 8 // warps
    want = np.zeros((T * parts, P), np.uint8)
    for t in range(T):
        for part in range(parts):
            for i in range(warps):
                want[t * parts + part] |= b[t, :, part * warps + i]
    got = tbanded.stage_unions(top.occupancy, warps)
    assert got.dtype == torch.uint8 and got.shape == (T * parts, P)
    np.testing.assert_array_equal(got.numpy(), want)
    # A piece is staged exactly when some stripe of the block lists it.
    assert int((got != 0).sum()) == int(
        (want.reshape(T, parts, P) != 0).sum())


@pytest.mark.parametrize("name", list(CASES))
def test_stage_group_rows_place_every_nonzero(ops, name):
    """Group j of piece p of tile t starts at U row rows[t, p, j]: every
    nonzero of the matrix (the triplets, row i, column c) sits in the
    JAX band at a column b of its tile whose group row plus b mod 16 is
    c, in both layouts."""
    layout, Ap, top, jop = ops[name]
    rows = _group_rows(layout, top).numpy()
    jband = np.asarray(jop.band, dtype=np.float32)
    t = Ap.row // 128
    if layout == "rolling":
        b = (Ap.col + jop.pre) % jband.shape[1]
    else:
        b = Ap.col - np.asarray(jop.starts)[t]
    np.testing.assert_array_equal(jband[Ap.row, b],
                                  Ap.data.astype(np.float32))
    got = rows[t, b // 128, (b % 128) // 16] + b % 16
    np.testing.assert_array_equal(got, Ap.col)


@pytest.mark.parametrize("k", [1, 7, 10, 20, 60, 67])
@pytest.mark.parametrize("name", list(CASES))
def test_stage_group_classes(ops, name, k):
    """A group is copied by one bulk copy when its 16 rows lie in U and
    its first float's offset row * k is a multiple of 4 (16 bytes); by
    the lanes otherwise, zero-filling rows outside U. A rolling window
    starts at a multiple of 128, so its groups are aligned at any k; a
    full window starts anywhere, so odd k gives unaligned groups."""
    layout, _, top, _ = ops[name]
    rows = _group_rows(layout, top)
    got = tbanded.stage_group_classes(rows, top.n, k).numpy()
    r = rows.numpy()
    whole = (r >= 0) & (r + 16 <= top.n)
    aligned = (r * k) % 4 == 0
    np.testing.assert_array_equal(got == tbanded.STAGE_BULK,
                                  whole & aligned)
    np.testing.assert_array_equal(got == tbanded.STAGE_UNALIGNED,
                                  whole & ~aligned)
    np.testing.assert_array_equal(got == tbanded.STAGE_EDGE, ~whole)
    if layout == "rolling" or k % 4 == 0:
        assert not (got == tbanded.STAGE_UNALIGNED).any()
    if layout == "rolling" and top.pre:
        assert (got[0] == tbanded.STAGE_EDGE).any()   # above row 0
    # A U offset of one float moves every whole group's class at k = 1.
    if k == 1:
        shifted = tbanded.stage_group_classes(rows, top.n, k, u_offset=1)
        assert torch.equal(shifted == tbanded.STAGE_EDGE,
                           torch.from_numpy(~whole))


@pytest.mark.parametrize("name", list(CASES))
def test_band_u_bytes(ops, name):
    """The walk reads a group of 16 U rows for every occupied sub-block,
    the staged route one for every set bit of the unions: never more,
    and fewer when the stripes of a block share groups."""
    _, _, top, _ = ops[name]
    k = 60
    walk = tbanded.band_u_bytes(top.occupancy, k, "walk")
    assert walk == tsparse.occupied_blocks(top.occupancy) * 16 * k * 4
    staged = {}
    for warps in (8, 4, 2):
        u = tbanded.stage_unions(top.occupancy, warps).numpy()
        staged[warps] = tbanded.band_u_bytes(top.occupancy, k, "staged",
                                             warps)
        assert staged[warps] == int(np.unpackbits(u).sum()) * 16 * k * 4
    assert staged[8] <= staged[4] <= staged[2] <= walk
    if name == "full-cloud":
        assert staged[8] < 0.8 * walk


def _emulate_staged(layout, top, U, warps):
    """W = A U summed as the staged route sums it, in float64: for every
    block and staged piece, the slot's groups filled from U (rows outside
    U zero), then each stripe's listed sub-blocks times their group."""
    band = top.band.double().numpy()
    n_pad, B = band.shape
    T, P = n_pad // 128, B // 128
    unions = tbanded.stage_unions(top.occupancy, warps).numpy()
    rows = _group_rows(layout, top).numpy()
    own = top.occupancy.contiguous().view(torch.uint8).view(T, P, 8).numpy()
    n_u, k = U.shape
    W = np.zeros((n_pad, k))
    parts = 8 // warps
    for blk in range(T * parts):
        t, s0 = blk // parts, (blk % parts) * warps
        for p in np.flatnonzero(unions[blk]):
            slot = np.zeros((8, 16, k))
            for j in range(8):
                if unions[blk, p] >> j & 1:
                    r = rows[t, p, j] + np.arange(16)
                    live = (r >= 0) & (r < n_u)
                    slot[j, live] = U[r[live]]
            for s in range(s0, s0 + warps):
                for j in range(8):
                    if own[t, p, s] >> j & 1:
                        i0, c0 = 128 * t + 16 * s, 128 * p + 16 * j
                        W[i0:i0 + 16] += band[i0:i0 + 16, c0:c0 + 16] @ slot[j]
    return W[: top.n]


@pytest.mark.parametrize("name", list(CASES))
def test_staged_emulation_matches_plain_and_jax(ops, name):
    """The staged route's product, emulated on the host from the unions,
    the group rows and the zero-filled slots, equals the port's plain
    version and the JAX reference (rel 1e-5: fp32 against float64), on
    every grid; a rolling window above row 0 and past n included."""
    layout, _, top, jop = ops[name]
    U = np.random.default_rng(3).normal(size=(top.n, 7)).astype(np.float32)
    if layout == "rolling":
        plain = tsparse.rolling_spmm_plain(top, torch.from_numpy(U))
        ref = jsparse.rolling.rolling_spmm_reference(jop, jnp.asarray(U))
    else:
        plain = tbanded.banded_spmm_plain(top, torch.from_numpy(U))
        ref = jsparse.banded.banded_spmm_reference(jop, jnp.asarray(U))
    for warps in (8, 4, 2):
        W = _emulate_staged(layout, top, U.astype(np.float64), warps)
        assert _rel(W, plain.numpy()) < 1e-5
        assert _rel(W, np.asarray(ref)) < 1e-5
