#!/usr/bin/env python3
"""The fp32 products of the polishes on the card, route by route.

Every LOBPCG polish of the direct and rolling-band slices applies its
fp32 operator twice an iteration: K X at k = 28 (20 modes + 8 guard
columns) and K S at k = 84 (S = [X W P]). This script times those
products, and the widths around them, on each route of the kernel
against the route the kernel took before the row-wise route existed and
against torch.sparse.mm of the same operator (`chip_smoke.route_row`:
`device_ms`, launches queued behind a busy-wait, beside the least-bytes
bound), and holds W to the same bits on every route:

  K2  the 300k and 1M strip-BSR K (RCM, C = 8) at k = 12, 20, 28, 60,
      84 and 128: the default route (`bsr.strip_route`), the walk on
      `walk_grid`'s grid (the parent's route), the row-wise route
      forced; CLI run B's fused K_blk (the smoke's step 14 build) at
      k = 20, 28, 64, 67, 84 and 128;
  K1  the 300k rolling band (max_bandwidth 8192) at k = 20, 28, 60, 84
      and 128: the default route (`band_grid`), the staged route or the
      walk it took before, the row-wise route forced;
  K4  the fp32 Hilbert core (window 512) of the fused-Gram path at k =
      28 and 84: its route (staged, walk) and the row-wise route over a
      table of its band (`nonzeros.band_table`), which no path routes.

With --tables it times instead the routes over the nonzero table that
the bf16 strip-BSR product and K4 on a full-window band take, at the
widths behind `bsr.BF16_ROWS_K` and `occupancy.FULL_ROWS_K`, each
against the route it took before (the tensor-core walk; the staged route
or the walk) by the same `route_row` rows:

  K2  'bf16' on the 300k strip-BSR K at k = 8, 12, 20, 28, 60, 84 and
      128 and the 1M K at k = 20, 28 and 84; K3 'bf16' at k = 20 on
      both, the row-wise route forced against the walk (W within
      BSR_TOL['bf16'] of the plain version at k = 20);
  K4  the fp32 Hilbert core (window 512) at k = 20, 28, 60 and 84 over
      its own table (`BandedELL.narrow`), the bf16 one at k = 20 and 28.

The cluster cores' K4 rows at k = 20 and 60 are chip_smoke.py's.

With --shards it times instead K4 on the sharded paths' blocks
(`ShardedBanded.block`, each with its nonzero table since PR 16) and
their transposes by `chip_smoke.shard_route_rows`: the default route
against the route the block took before it carried a table (the staged
route, the walk past 64 columns), the row-wise route forced, the library
and the bound, W the same bits on all three:

  the 300k cloud's 4-shard operator (step 16c), shard 1's block and
      transpose at k = 6, 10, 20, 28, 60 and 84;
  the multigrid hierarchy's level operators and graph operators (16c's
      ranks and the CLI under torchrun, 17c), on 4 shards (shard 1) and
      on one, at the widths the sharded multigrid launches them
      (`chip_smoke.multigrid_shard_rows`);
  the unsharded full-window bands at k = 6, 10 and 20 (the Hilbert core,
      window 512; the 300k cluster core, window 1024), which the same
      rule routes;
  the 1M split core at one shard (16b) and its transpose at k = 6, 10,
      18, 20, 28, 54, 60 and 84 (every width 16b's launch record shows);
      it prints the tables' build time and bytes.

With --gram it times instead K1's products on the row-wise route that
PR 16 added, by `chip_smoke.gram_route_row` and `band_route_rows`: with
the Gram (the partials in the product's blocks) against the route it
replaced (the walk; the staged route at the 300k band's fp32 widths up
to 32), on the multigrid K_blk ('high', k = 10), the transfer path's
level operators (k = 10), the 300k rolling band in fp32 at k = 10, 20,
28 and 39 and in 'bf16' at k = 20 and 28; without the Gram, the 300k
band in 'bf16' at k = 12, 20, 28, 60 and 84 on the bf16 row-wise route
against the tensor-core walk; and K5 with the Gram on the row-wise
route (`chip_smoke.gram_route_row`) against the route it replaced (the
staged route up to 64 columns, the walk past them and in bf16) on the
300k cluster core (fp32, window 1024) at k = 10, 20, 28, 39, 60 and 84,
the Hilbert core (window 512) in fp32 at k = 20, 28, 60 and 84 and in
bf16 at k = 12, 20 and 28. Every width is put on the row-wise route for
it (`occupancy.BAND_GRAM_ROWS_K`, `BAND_BF16_ROWS_K` and
`FULL_GRAM_ROWS_K` widened in the process).

With --eigh it runs instead `chip_smoke.small_eigh_rows`: E1, the
small symmetric eigensolver (`solvers/small_eigh.py`,
`csrc/small_eigh.cu`), held to torch.linalg.eigh and timed against it on
the three eigensolves of one iteration of the benchmark's 1M polish
(`tests/data/polish1m_grams.npz`: the fp64 Rayleigh-Ritz Gram at n = 84
and the two fp32 whitening Grams at n = 28) and on a random symmetric
matrix of each shape, with the bound. It needs no operator and no host
stage.

With --polish it also times the guarded LOBPCG polish an iteration (k =
28 columns, tol 0, so every iteration runs) on the 300k and 1M strip-BSR
K and the 300k rolling band, on the routes before this route existed
(`bsr.ROWS_MAX_K` set to the narrow path's limit, `BAND_ROWS_K` empty:
the walk and the staged route) and on the default ones, in turns:
before, after, after, before.

Run on a machine with one NVIDIA GPU from the root of a checkout:

    python3 polish_products.py [--skip-1m] [--polish | --tables |
                                            --shards | --gram | --eigh]

Exits non-zero without a card. The 1M host stage (cloud and native
Laplacian) takes 1-2 minutes of it.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch


POLISH_ITERS = 100


def polish_turns(label, K, M, seed) -> None:
    """The guarded polish's ms an iteration (k = 28, POLISH_ITERS
    iterations, tol 0) on K before the row-wise route (the narrow path's
    limit for strip-BSR, no band widths) and after it, in turns: before,
    after, after, before. Prints each and the launches a turn made on
    the row-wise route."""
    import numpy as np

    from eigenpinns_torch.solvers import lobpcg
    from eigenpinns_torch.sparse import bsr, occupancy, rolling

    X0 = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(K.n, 28)).astype(np.float32), device=M.diagonal().device)
    limits = {"before": (bsr.NARROW_MAX_K, (1, 0)),
              "after": (bsr.ROWS_MAX_K, occupancy.BAND_ROWS_K)}
    lobpcg(K, M, X0, max_iter=5, tol=0.0)
    out = []
    try:
        for turn in ("before", "after", "after", "before"):
            bsr.ROWS_MAX_K, occupancy.BAND_ROWS_K = limits[turn]
            rows0 = (bsr.bsr_kernel_launches["rows"]
                     + rolling.rolling_rows_launches)
            torch.cuda.synchronize()
            t0 = time.time()
            pol = lobpcg(K, M, X0, max_iter=POLISH_ITERS, tol=0.0)
            torch.cuda.synchronize()
            ms = (time.time() - t0) / POLISH_ITERS * 1e3
            rows = (bsr.bsr_kernel_launches["rows"]
                    + rolling.rolling_rows_launches - rows0)
            out.append(f"{turn} {ms:.3f} ms ({rows} row-wise launches, "
                       f"{int(pol.iterations)} iterations)")
    finally:
        bsr.ROWS_MAX_K, occupancy.BAND_ROWS_K = limits["after"]
    print(f"[polish] {label}: an iteration " + ", ".join(out), flush=True)


def ptxas_report(source: str = "bsr_spmm",
                 kernels=("rows_kernel", "round_kernel")) -> None:
    """The registers and spills of the kernels of `source` whose names
    hold one of `kernels`, from the nvcc -Xptxas -v log of the build
    (printed when this process builds the library, not when it finds it
    built)."""
    from eigenpinns_torch.utils import cuda_build

    lines = cuda_build.build_logs.get(source, "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in kernels):
            print("[ptxas] " + " | ".join(x.strip() for x in lines[i:i + 4]
                                          if "Compile time" not in x),
                  flush=True)


def table_routes(L, X, device, skip_1m: bool) -> None:
    """The --tables rows (see the module's docstring)."""
    import chip_smoke as cs
    from eigenpinns_torch.geometry import point_cloud_laplacian
    from eigenpinns_torch.sparse import BSRTile, SplitBanded, banded, bsr
    from eigenpinns_torch.utils.fixtures import make_cloud

    def k2_rows(tag, L, ks, seed):
        K, perm = BSRTile.from_scipy(L, device=device)
        Lp = L[perm][:, perm].tocsr()
        cs.k2_route_rows(bsr, tag, K, Lp, ks, seed=seed, plain_ks=(20,),
                         precision="bf16")
        cs.k2_route_rows(bsr, tag, K, Lp, (20,), seed=seed,
                         plain_ks=(20,), precision="bf16", burst=True)
        del K
        torch.cuda.empty_cache()

    k2_rows("300k", L, (8, 12, 20, 28, 60, 84, 128), seed=1)
    for dtype, ks in ((torch.float32, (20, 28, 60, 84)),
                      (torch.bfloat16, (20, 28))):
        K_h, _ = SplitBanded.from_scipy(L, X=X, window=cs.HILBERT_WINDOW,
                                        order="hilbert", dtype=dtype,
                                        device=device)
        core = K_h.core
        csr = cs.band_csr(core)
        cs.band_route_rows(
            f"K4 Hilbert core {'fp32' if dtype == torch.float32 else 'bf16'}",
            lambda U, **grid: banded.banded_spmm_cuda(core, U, **grid),
            core.band, core.starts, 0, core.occupancy, core.narrow, core.n,
            csr, int(csr.values().numel()), ks, seed=2)
        del K_h, core, csr
        torch.cuda.empty_cache()
    if not skip_1m:
        t0 = time.time()
        L1, _ = point_cloud_laplacian(make_cloud(cs.XL_N), n_neighbors=15,
                                      use_native=True)
        print(f"[host] 1M Laplacian in {time.time() - t0:.2f} s, nnz "
              f"{L1.nnz}", flush=True)
        k2_rows("1M", L1, (20, 28, 84), seed=5)


def shard_routes(L, X, device, skip_1m: bool) -> None:
    """The --shards rows (see the module's docstring)."""
    import chip_smoke as cs
    from eigenpinns_torch.geometry import point_cloud_laplacian
    from eigenpinns_torch.parallel import build_sharded_operator
    from eigenpinns_torch.sparse import SplitBanded, banded
    from eigenpinns_torch.utils.fixtures import make_cloud

    def blocks(tag, core, shard, ks, seed):
        torch.cuda.synchronize()
        t0 = time.time()
        A = core.block(shard, device)
        torch.cuda.synchronize()
        if A.narrow.nnz == 0:   # a shard past the operator's rows
            print(f"[shard] {tag}: no nonzeros", flush=True)
            return
        mb = sum(t.val.nbytes + t.idx.nbytes + t.slice_start.nbytes
                 for t in (A.narrow, A.transpose_banded.narrow)) / 1e6
        print(f"[shard] {tag}: block {A.n} x {A.n_cols} and its transpose "
              f"with their tables in {time.time() - t0:.3f} s; the two "
              f"tables {mb:.1f} MB (nnz {A.narrow.nnz} and "
              f"{A.transpose_banded.narrow.nnz})", flush=True)
        for name, op in (("block", A), ("transpose", A.transpose_banded)):
            cs.shard_route_rows(banded, f"{tag} {name}", op, ks, seed,
                                plain_ks=ks[:1])
        del A
        torch.cuda.empty_cache()

    _, (core, _), _ = build_sharded_operator(L, cs.SHARD_DEV, X=X,
                                             shards=(1,), device=device)
    blocks("300k, 4 shards, shard 1", core, 1, (6, 10, 20, 28, 60, 84), 11)
    del core
    cs.multigrid_shard_rows(banded, device)
    for name, order, window in (("Hilbert", "hilbert", cs.HILBERT_WINDOW),
                                ("cluster", "cluster", 1024)):
        K_s, _ = SplitBanded.from_scipy(L, X=X, window=window, order=order,
                                        device=device)
        core = K_s.core
        csr = cs.band_csr(core)
        cs.band_route_rows(
            f"K4 300k {name} core (unsharded)",
            lambda U, **grid: banded.banded_spmm_cuda(core, U, **grid),
            core.band, core.starts, 0, core.occupancy, core.narrow, core.n,
            csr, int(csr.values().numel()), (6, 10, 20), seed=13)
        del K_s, core, csr
        torch.cuda.empty_cache()
    if not skip_1m:
        t0 = time.time()
        X1 = make_cloud(cs.XL_N)
        L1, _ = point_cloud_laplacian(X1, n_neighbors=15, use_native=True)
        print(f"[host] 1M Laplacian in {time.time() - t0:.2f} s, nnz "
              f"{L1.nnz}", flush=True)
        _, (core, _), _ = build_sharded_operator(L1, 1, X=X1, device=device)
        blocks("1M split core, one shard", core, 0,
               (6, 10, 18, 20, 28, 54, 60, 84), 14)


def gram_routes(L, X, device) -> None:
    """The --gram rows (see the module's docstring)."""
    import chip_smoke as cs
    import scipy.sparse as sp
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.sparse import (
        RollingBanded,
        SplitBanded,
        banded,
        occupancy,
        rolling,
    )
    from eigenpinns_torch.utils.fixtures import perturbed_icosphere

    h = build_hierarchy(perturbed_icosphere(4), cs.LEVELS,
                        n_modes=cs.N_MODES, operator_format="auto",
                        device="cpu")
    K_blk_sp = sp.block_diag([K.tocsr() for K in h.K_scipy], format="csr")
    K_blk = RollingBanded.from_scipy(K_blk_sp, device=device,
                                     reorder=False)[0]
    Kr, perm = RollingBanded.from_scipy(L, max_bandwidth=8192,
                                        device=device)
    Lr = L[perm][:, perm].tocsr()
    cases = [("K_blk high", K_blk.with_precision("high"), K_blk_sp,
              (cs.N_MODES,))]
    # The transfer path's level operators, as the hierarchy builds them
    # on the card.
    h_dev = build_hierarchy(perturbed_icosphere(4), cs.LEVELS,
                            n_modes=cs.N_MODES, operator_format="auto",
                            device=device)
    for lv, (K_op, K_sp) in enumerate(zip(h_dev.K_ops, h_dev.K_scipy)):
        if isinstance(K_op, RollingBanded):   # K_sp in the band's order
            cases.append((f"level {lv} K {K_op.mxu_precision}", K_op, K_sp,
                          (cs.N_MODES,)))
    cases += [("K_300k highest", Kr, Lr, (10, 20, 28, 39)),
              ("K_300k bf16", Kr.with_precision("bf16"), Lr, (20, 28))]
    # Every width on the row-wise route, to time it where the default
    # does not take it.
    occupancy.BAND_GRAM_ROWS_K = {torch.float32: (1, 128),
                                  torch.bfloat16: (1, 128)}
    occupancy.BAND_BF16_ROWS_K = (1, 256)
    for label, A, A_sp, ks in cases:
        for k in ks:
            cs.gram_route_row(rolling, label, A, A_sp, k, seed=k)
    Kb = Kr.with_precision("bf16")
    cs.band_route_rows(
        "K1 300k rolling band bf16",
        lambda U, **grid: rolling.rolling_spmm_cuda(Kb, U, **grid), Kb.band,
        None, Kb.pre, Kb.occupancy, Kb.narrow, Kb.n,
        cs.torch_csr(Lr, device), Lr.nnz, (12, 20, 28, 60, 84), seed=15,
        plain=lambda V: rolling.rolling_spmm_plain(Kb, V))
    del Kr, Kb
    # K5 on the split cores, every width on the row-wise route with the
    # Gram.
    occupancy.FULL_GRAM_ROWS_K = {torch.float32: (1, 128),
                                  torch.bfloat16: (1, 128)}
    cores = (
        ("cluster core", dict(window=1024), (10, 20, 28, 39, 60, 84)),
        ("Hilbert core", dict(window=cs.HILBERT_WINDOW, order="hilbert"),
         (20, 28, 60, 84)),
        ("Hilbert core", dict(window=cs.HILBERT_WINDOW, order="hilbert",
                              dtype=torch.bfloat16), (12, 20, 28)))
    for label, kw, ks in cores:
        core = SplitBanded.from_scipy(L, X=X, device=device, **kw)[0].core
        for k in ks:
            cs.gram_route_row(banded, label, core, None, k, seed=k)
        del core
        torch.cuda.empty_cache()


def eigh_rows(device) -> None:
    """The --eigh rows (see the module's docstring)."""
    import chip_smoke as cs
    from eigenpinns_torch.solvers import small_eigh

    small_eigh.build_kernel()
    ptxas_report("small_eigh", ("small_eigh_kernel",))
    cs.small_eigh_rows(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-1m", action="store_true",
                    help="leave out the 1M strip-BSR K")
    ap.add_argument("--polish", action="store_true",
                    help="time the polish an iteration on both routes")
    ap.add_argument("--tables", action="store_true",
                    help="time the bf16 strip-BSR and full-band K4 routes "
                         "over the nonzero table instead")
    ap.add_argument("--shards", action="store_true",
                    help="time K4 on the sharded paths' blocks instead")
    ap.add_argument("--gram", action="store_true",
                    help="time K1's row-wise Gram and bf16 routes instead")
    ap.add_argument("--eigh", action="store_true",
                    help="time the small symmetric eigensolver instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("polish_products: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    import scipy.sparse as sp

    import chip_smoke as cs
    from eigenpinns_torch.geometry import (
        load_mesh,
        native,
        point_cloud_laplacian,
    )
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.sparse import (
        BSRTile,
        Diagonal,
        RollingBanded,
        SplitBanded,
        banded,
        bsr,
        rolling,
    )
    from eigenpinns_torch.sparse.nonzeros import band_table
    from eigenpinns_torch.utils.fixtures import make_cloud

    device = torch.device("cuda:0")
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)} ({smi})", flush=True)
    if args.eigh:
        eigh_rows(device)
        print(smi, flush=True)
        return 0
    t0 = time.time()
    for build in (bsr.build_kernel, banded.build_kernel, native.require):
        build()
    print(f"[build] {time.time() - t0:.2f} s", flush=True)

    t0 = time.time()
    X = make_cloud(cs.DIRECT_N)
    L, M_sp = point_cloud_laplacian(X, n_neighbors=15, use_native=True)
    m_diag = np.asarray(M_sp.diagonal())
    print(f"[host] 300k Laplacian in {time.time() - t0:.2f} s, nnz {L.nnz}",
          flush=True)
    if args.tables:
        ptxas_report()
        table_routes(L, X, device, args.skip_1m)
        print(smi, flush=True)
        return 0
    if args.shards or args.gram:
        if args.gram:
            ptxas_report("banded_spmm", ("rows_gram_kernel",))
            gram_routes(L, X, device)
        if args.shards:
            shard_routes(L, X, device, args.skip_1m)
        print(smi, flush=True)
        return 0

    K, perm = BSRTile.from_scipy(L, device=device)
    Lp = L[perm][:, perm].tocsr()
    cs.k2_route_rows(bsr, "300k", K, Lp, (12, 20, 28, 60, 84, 128), seed=1,
                     plain_ks=(28, 84))
    if args.polish:
        polish_turns("300k strip-BSR K", K, Diagonal(torch.as_tensor(
            m_diag[perm], dtype=torch.float32, device=device)), seed=6)
    del K
    torch.cuda.empty_cache()

    Kr, perm_r = RollingBanded.from_scipy(L, max_bandwidth=8192,
                                          device=device)
    cs.describe_band("K_300k", Kr)
    Lr = L[perm_r][:, perm_r].tocsr()
    cs.band_route_rows(
        "K1 300k rolling band",
        lambda U, **grid: rolling.rolling_spmm_cuda(Kr, U, **grid),
        Kr.band, None, Kr.pre, Kr.occupancy, Kr.narrow, Kr.n,
        cs.torch_csr(Lr, device), Lr.nnz, (20, 28, 60, 84, 128), seed=2)
    if args.polish:
        polish_turns("300k rolling band", Kr, Diagonal(torch.as_tensor(
            m_diag[perm_r], dtype=torch.float32, device=device)), seed=7)
    del Kr
    torch.cuda.empty_cache()

    K_h, _ = SplitBanded.from_scipy(L, X=X, window=cs.HILBERT_WINDOW,
                                    order="hilbert", device=device)
    core = K_h.core
    csr = cs.band_csr(core)
    cs.band_route_rows(
        "K4 Hilbert core fp32",
        lambda U, **grid: banded.banded_spmm_cuda(core, U, **grid),
        core.band, core.starts, 0, core.occupancy,
        band_table(core.band, core.occupancy, core.starts), core.n, csr,
        int(csr.values().numel()), (28, 84), seed=3)
    del K_h, core, csr
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        mesh = load_mesh(cs.cli_inputs(work)["obj"], normalize=True)
        h_b = build_hierarchy(mesh, [256, 512, 1024],
                              n_modes=cs.CLI_RUNS_K["B"],
                              operator_format="auto", device="cpu")
    K_sp = sp.block_diag([A.tocsr() for A in h_b.K_scipy], format="csr")
    K_blk = BSRTile.from_scipy(K_sp, device=device, reorder=False)[0]
    cs.k2_route_rows(bsr, "CLI K_blk", K_blk, K_sp,
                     (20, 28, 64, 67, 84, 128), seed=4, plain_ks=(64, 67))
    del K_blk

    if not args.skip_1m:
        t0 = time.time()
        X = make_cloud(cs.XL_N)
        L, M_sp = point_cloud_laplacian(X, n_neighbors=15, use_native=True)
        print(f"[host] 1M Laplacian in {time.time() - t0:.2f} s, nnz "
              f"{L.nnz}", flush=True)
        K, perm = BSRTile.from_scipy(L, device=device)
        cs.k2_route_rows(bsr, "1M", K, L[perm][:, perm].tocsr(),
                         (20, 28, 60, 84, 128), seed=5, plain_ks=(84,))
        if args.polish:
            polish_turns("1M strip-BSR K", K, Diagonal(torch.as_tensor(
                np.asarray(M_sp.diagonal())[perm], dtype=torch.float32,
                device=device)), seed=8)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
