#!/usr/bin/env python3
"""Where the band kernels' staged route spends its time, on the card.

Builds eigenpinns_torch/csrc/banded_spmm.cu as it stands and in variants
that each take one part of the staged route out, then times K4 (and K1 on
the multigrid K_blk) on the card (`chip_smoke.device_ms`: launches queued
behind a busy-wait) beside the column-block walk and torch.sparse.mm of
the same operator:

  staged      the source as it stands (the default route);
  one_unit    one block a unit (tile and stripes), no resident grid;
  no_fma      the stripes' multiply-adds taken out (loads, votes, copies
              and barriers stay);
  no_copy     the U copies taken out (the copy warp only arrives);
  bare        both taken out: the sub-block loads and the barriers.

The exact variants (staged, one_unit) must give the walk's W bit for
bit; the others compute garbage and are timed only. Operators: the
multigrid path's K_blk (k = 10) and the cluster cores of the 300k and
1M-point clouds (k = 20 and 60). Run on a machine with one NVIDIA GPU:

    python3 band_stage_variants.py [--skip-1m]

Builds go to build/eigenpinns_torch/variants/ (one nvcc each, in
parallel). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# (variant, {text in banded_spmm.cu: its replacement})
VARIANTS = {
    "staged": {},
    "one_unit": {"grid = n_units < resident ? n_units : resident;":
                 "grid = n_units;"},
    "no_fma": {"if (!row_nz) continue;": "continue;"},
    "no_copy": {"const unsigned groups = __shfl_sync(occ::kFull, u, pl);":
                "const unsigned groups = 0u;"},
    "bare": {"if (!row_nz) continue;": "continue;",
             "const unsigned groups = __shfl_sync(occ::kFull, u, pl);":
             "const unsigned groups = 0u;"},
}
EXACT = ("staged", "one_unit")


def build_variants() -> dict:
    """One ctypes library per variant, compiled in parallel."""
    from eigenpinns_torch.utils import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f in ("banded_spmm.cu", "occupancy_spmm.cuh"):
            with open(os.path.join(cuda_build.CSRC_DIR, f)) as fh:
                text = fh.read()
            if f == "banded_spmm.cu":
                for a, b in subs.items():
                    if a not in text:
                        raise SystemExit(f"{name}: '{a}' is not in {f}")
                    text = text.replace(a, b)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        flags = [x for x in cuda_build.NVCC_FLAGS if x not in ("-Xptxas",
                                                               "-v")]
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *flags, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "banded_spmm.cu")])
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"the build of variant {name} failed")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.epk_banded_spmm.restype = i
        lib.epk_banded_spmm.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i,
                                        i, i, i, i, i, p]
        lib.epk_banded_error_string.restype = ctypes.c_char_p
        lib.epk_banded_error_string.argtypes = [i]
        libs[name] = lib
    return libs


def measure(cs, banded, libs, label, launch, op, k, csr) -> None:
    """Every variant's, the walk's and the library's time on the card for
    one operator at width k; the exact variants' bits against the walk."""
    U = torch.randn((op.n, k), device="cuda")
    real = banded.build_kernel
    W_walk = launch(op, U, route="walk")
    times = {}
    for name, lib in libs.items():
        banded.build_kernel = lambda lib=lib: lib
        W = launch(op, U)
        torch.cuda.synchronize()
        if name in EXACT and not torch.equal(W, W_walk):
            raise SystemExit(f"{label} k={k}: variant {name} differs from "
                             "the walk")
        times[name] = cs.device_ms(lambda: launch(op, U))
    banded.build_kernel = real
    times["walk"] = cs.device_ms(lambda: launch(op, U, route="walk"))
    times["torch.sparse.mm"] = cs.device_ms(lambda: torch.sparse.mm(csr, U))
    print(f"[variants] {label} k={k} ms on the card: " + ", ".join(
        f"{name} {t:.4f}" for name, t in times.items()), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--skip-1m", action="store_true",
                        help="time the 300k core and K_blk only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("band_stage_variants.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import scipy.sparse as sp

    import chip_smoke as cs
    from eigenpinns_torch.geometry import point_cloud_laplacian
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.sparse import RollingBanded, SplitBanded, banded
    from eigenpinns_torch.sparse import rolling
    from eigenpinns_torch.utils.fixtures import make_cloud, perturbed_icosphere

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)} ({smi})", flush=True)
    t0 = time.time()
    libs = build_variants()
    print(f"built {len(libs)} variants in {time.time() - t0:.2f} s",
          flush=True)

    h = build_hierarchy(perturbed_icosphere(4), cs.LEVELS,
                        n_modes=cs.N_MODES, operator_format="auto",
                        device="cpu")
    K_blk_sp = sp.block_diag([K.tocsr() for K in h.K_scipy], format="csr")
    K_blk = RollingBanded.from_scipy(K_blk_sp, device="cuda",
                                     reorder=False)[0].with_precision("high")
    measure(cs, banded, libs, "K_blk", rolling.rolling_spmm_cuda, K_blk,
            cs.N_MODES, cs.torch_csr(K_blk_sp, "cuda"))
    for n in (300_000,) if args.skip_1m else (300_000, 1_000_000):
        t0 = time.time()
        X = make_cloud(n)
        L, _ = point_cloud_laplacian(X, n_neighbors=15, use_native=True)
        core = SplitBanded.from_scipy(L, X=X, window=1024,
                                      device="cuda")[0].core
        print(f"{n}-point cluster core {tuple(core.band.shape)} in "
              f"{time.time() - t0:.2f} s", flush=True)
        csr = cs.band_csr(core)
        for k in (20, 60):
            measure(cs, banded, libs, f"cluster {n}",
                    banded.banded_spmm_cuda, core, k, csr)
        del core, csr, L, X
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
