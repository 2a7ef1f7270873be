#!/usr/bin/env python3
"""Where the row-wise route's Gram epilogue spends its time, on the card.

Builds eigenpinns_torch/csrc/banded_spmm.cu as it stands and in variants
(and, with --parent ROOT, the same source of another checkout, such as
the commit before a change to the epilogue, unpacked by `git archive`
into a directory that .gitignore lists), then times the row-wise route
with the Gram (`nz::rows_gram_kernel`, then `gram_reduce_kernel`) on the
card (`chip_smoke.device_ms`: launches queued behind a busy-wait) beside
the product alone (the row-wise route without the Gram), the route the
Gram took before the row-wise route existed (the walk, or the staged
route) and U^T torch.sparse.mm of the same operator:

  gram           the source as it stands;
  ti1, ti2, ti4  a thread of the epilogue owns 1 (2, 4) Gram rows
                 whatever k (`gram_thread_rows`);
  u4             the epilogue's loop over the rows unrolled 4 times for
                 every kTI (8 times at kTI = 1 as it stands);
  lb3            the kernel's launch bounds ask for 3 blocks of 512
                 threads an SM (42 registers a thread, not 64);
  no_fma         the epilogue's loop over the tile's rows taken out (the
                 U copies, W in shared memory, the partials' stores and
                 the reduce stay);
  no_partials    the partials' stores taken out and the reduce given no
                 tiles (the epilogue's arithmetic stays);
  parent         (--parent) the other checkout's source;
  parent_no_fma  (--parent) the same with its epilogue's loop taken out.

The exact variants (gram, ti1, ti2, ti4, u4, lb3, parent) must give the
same W and G bits (on an fp32 band, the walk's too); the others are
timed only.
Operators: the multigrid path's K_blk ('high', k = 10: K1's Gram in the
multigrid and transfer losses), the 300k rolling band in 'bf16' (k = 20:
the rolling training's K1), the 300k Hilbert core in bf16 (k = 20: the
fused-Gram training's K5), the 300k and 1M cluster cores in fp32 (k =
60, and 20 at 300k). Run on a machine with one NVIDIA GPU:

    python3 gram_epilogue_variants.py [--skip-1m] [--parent ROOT]

Builds go to build/eigenpinns_torch/gram_variants/ (one nvcc each, in
parallel), and print the -Xptxas -v lines of rows_gram_kernel and
rows_kernel. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("banded_spmm.cu", "occupancy_spmm.cuh", "nonzero_spmm.cuh")

# The rule for the epilogue's Gram rows a thread, and its body.
RULE_TI = ("inline int gram_thread_rows(int k) { return k > 32 ? 4 : "
           "k > 16 ? 2 : 1; }")
BODY_TI = "return k > 32 ? 4 : k > 16 ? 2 : 1; }"

# (variant, {file: {text: its replacement}}), for this checkout's source
VARIANTS = {
    "gram": {},
    "ti1": {"nonzero_spmm.cuh": {RULE_TI: RULE_TI.replace(BODY_TI,
                                                          "return 1; }")}},
    "ti2": {"nonzero_spmm.cuh": {RULE_TI: RULE_TI.replace(BODY_TI,
                                                          "return 2; }")}},
    "ti4": {"nonzero_spmm.cuh": {RULE_TI: RULE_TI.replace(BODY_TI,
                                                          "return 4; }")}},
    "u4": {"nonzero_spmm.cuh": {"#pragma unroll(kTI == 1 ? 8 : 4)":
                                "#pragma unroll 4"}},
    "lb3": {"nonzero_spmm.cuh": {
        "__launch_bounds__(kRowsThreads, 2)\nrows_gram_kernel":
        "__launch_bounds__(kRowsThreads, 3)\nrows_gram_kernel"}},
    "no_fma": {"nonzero_spmm.cuh": {
        "    for (int r = 0; r < kGramTile; ++r) {\n      float u[kTI];":
        "    for (int r = 0; r < 0; ++r) {\n      float u[kTI];"}},
    "no_partials": {
        "nonzero_spmm.cuh": {
            "      if (i >= k) continue;":
            "      if (i >= k || g[a][0] != 1.5e-38f) continue;"},
        "banded_spmm.cu": {"      partial, G, n_tiles, kk);":
                           "      partial, G, 0, kk);"}},
}
# The same for the source of the checkout given by --parent.
PARENT_VARIANTS = {
    "parent": {},
    "parent_no_fma": {"nonzero_spmm.cuh": {
        "    for (int r = 0; r < kGramTile; ++r) {\n"
        "      const float4 u = *reinterpret_cast<const float4*>(us + r * "
        "ldu + i0);":
        "    for (int r = 0; r < 0; ++r) {\n"
        "      const float4 u = *reinterpret_cast<const float4*>(us + r * "
        "ldu + i0);"}},
}
EXACT = ("gram", "ti1", "ti2", "ti4", "u4", "lb3", "parent")


def build_variants(parent: str | None) -> dict:
    """One ctypes library per variant, compiled in parallel; prints the
    ptxas lines of rows_gram_kernel for the unchanged sources."""
    from eigenpinns_torch.utils import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "gram_variants")
    jobs = [(name, subs, cuda_build.CSRC_DIR)
            for name, subs in VARIANTS.items()]
    if parent is not None:
        csrc = os.path.join(os.path.abspath(parent), "eigenpinns_torch",
                            "csrc")
        jobs += [(name, subs, csrc) for name, subs in PARENT_VARIANTS.items()]
    procs = {}
    for name, subs, csrc in jobs:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f in SOURCES:
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            for a, b in subs.get(f, {}).items():
                if a not in text:
                    raise SystemExit(f"{name}: '{a}' is not in {f}")
                text = text.replace(a, b)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        # Each library keeps its own function-local statics (the
        # kernels' granted shared memory): GCC would otherwise make them
        # one object across the process (STB_GNU_UNIQUE), and a variant
        # would skip the attribute another library's kernel was given.
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xcompiler",
             "-fno-gnu-unique", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "banded_spmm.cu")],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit(f"the build of variant {name} failed:\n"
                             f"{log[-4000:]}")
        if name in ("gram", "parent"):
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry" in line and (
                        "rows_gram_kernel" in line or "rows_kernel" in line):
                    print(f"[ptxas {name}] " + " | ".join(
                        x.strip() for x in lines[i:i + 4]
                        if "Compile time" not in x), flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.epk_banded_spmm.restype = i
        lib.epk_banded_spmm.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i,
                                        i, i, i, i, i, p]
        lib.epk_banded_spmm_rows.restype = i
        lib.epk_banded_spmm_rows.argtypes = [p, i, p, p, p, p, p, i, i, i,
                                             i, p]
        lib.epk_banded_spmm_rows_gram.restype = i
        lib.epk_banded_spmm_rows_gram.argtypes = [p, i, p, p, p, p, p, p, p,
                                                  i, i, i, i, p]
        lib.epk_banded_error_string.restype = ctypes.c_char_p
        lib.epk_banded_error_string.argtypes = [i]
        libs[name] = lib
    return libs


def measure(cs, banded, libs, label, launch, op, k, csr, parent) -> None:
    """Every variant's time on the card for one operator at width k (the
    row-wise route with the Gram forced), beside the product alone, the
    `parent` route with the Gram and the library; the exact variants'
    W and G bits against each other (and the parent route's in fp32)."""
    gen = torch.Generator("cuda").manual_seed(k)
    U = torch.randn((op.n, k), generator=gen, device="cuda")
    real = banded.build_kernel
    Wp, Gp = launch(op, U, with_gram=True, route=parent)
    ref = None
    times = {}
    try:
        for name, lib in libs.items():
            banded.build_kernel = lambda lib=lib: lib
            try:
                W, G = launch(op, U, with_gram=True, route="rows")
            except RuntimeError as e:
                print(f"[variants] {label} k={k}: {name} failed: {e}",
                      flush=True)
                continue
            torch.cuda.synchronize()
            if name in EXACT:
                if ref is None:
                    ref = (W, G)
                    if op.band.dtype == torch.float32 and not (
                            torch.equal(W, Wp) and torch.equal(G, Gp)):
                        raise SystemExit(f"{label} k={k}: {name} differs "
                                         f"from the {parent} route")
                elif not (torch.equal(W, ref[0]) and torch.equal(G, ref[1])):
                    raise SystemExit(f"{label} k={k}: variant {name} differs"
                                     " from the first exact variant")
            times[name] = cs.device_ms(
                lambda: launch(op, U, with_gram=True, route="rows"))
    finally:
        banded.build_kernel = real
    times["product"] = cs.device_ms(lambda: launch(op, U, route="rows"))
    times[f"{parent} with the Gram"] = cs.device_ms(
        lambda: launch(op, U, with_gram=True, route=parent))
    times["U^T torch.sparse.mm"] = cs.device_ms(
        lambda: U.T @ torch.sparse.mm(csr, U))
    print(f"[variants] {label} {tuple(op.band.shape)} "
          f"{str(op.band.dtype).split('.')[-1]} k={k} ms on the card: "
          + ", ".join(f"{name} {t:.4f}" for name, t in times.items()),
          flush=True)
    del U, Wp, Gp, ref
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--skip-1m", action="store_true",
                        help="leave out the 1M cluster core")
    parser.add_argument("--parent", default=None,
                        help="root of another checkout whose source is "
                             "timed beside this one's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gram_epilogue_variants.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import scipy.sparse as sp

    import chip_smoke as cs
    from eigenpinns_torch.geometry import point_cloud_laplacian
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.sparse import (
        RollingBanded,
        SplitBanded,
        banded,
        rolling,
    )
    from eigenpinns_torch.utils.fixtures import make_cloud, perturbed_icosphere

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)} ({smi})", flush=True)
    t0 = time.time()
    libs = build_variants(args.parent)
    print(f"built {len(libs)} variants in {time.time() - t0:.2f} s",
          flush=True)

    h = build_hierarchy(perturbed_icosphere(4), cs.LEVELS,
                        n_modes=cs.N_MODES, operator_format="auto",
                        device="cpu")
    K_blk_sp = sp.block_diag([K.tocsr() for K in h.K_scipy], format="csr")
    K_blk = RollingBanded.from_scipy(K_blk_sp, device="cuda",
                                     reorder=False)[0].with_precision("high")
    measure(cs, banded, libs, "K1 K_blk", rolling.rolling_spmm_cuda, K_blk,
            cs.N_MODES, cs.torch_csr(K_blk_sp, "cuda"), "walk")
    del K_blk
    for n in (300_000,) if args.skip_1m else (300_000, 1_000_000):
        t0 = time.time()
        X = make_cloud(n)
        L, _ = point_cloud_laplacian(X, n_neighbors=15, use_native=True)
        print(f"[host] {n}-point Laplacian in {time.time() - t0:.2f} s",
              flush=True)
        if n == 300_000:
            Kr, perm = RollingBanded.from_scipy(L, max_bandwidth=8192,
                                                device="cuda")
            measure(cs, banded, libs, "K1 300k rolling band",
                    rolling.rolling_spmm_cuda, Kr.with_precision("bf16"),
                    cs.DIRECT_K, cs.torch_csr(L[perm][:, perm], "cuda"),
                    "walk")
            del Kr
            core = SplitBanded.from_scipy(
                L, X=X, window=cs.HILBERT_WINDOW, order="hilbert",
                dtype=torch.bfloat16, device="cuda")[0].core
            measure(cs, banded, libs, "K5 300k Hilbert core",
                    banded.banded_spmm_cuda, core, cs.DIRECT_K,
                    cs.band_csr(core), "walk")
            del core
        core = SplitBanded.from_scipy(L, X=X, window=1024,
                                      device="cuda")[0].core
        csr = cs.band_csr(core)
        for k in (cs.SPEC_K + 10,) if n > 300_000 else (cs.DIRECT_K,
                                                        cs.SPEC_K + 10):
            measure(cs, banded, libs, f"K5 {n} cluster core",
                    banded.banded_spmm_cuda, core, k, csr, "staged")
        del core, csr, L, X
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
