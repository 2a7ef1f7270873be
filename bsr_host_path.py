#!/usr/bin/env python3
"""The host's time to launch the strip-BSR kernel, on one NVIDIA GPU.

    python3 bsr_host_path.py [ROOT]

Imports `eigenpinns_torch` and `chip_smoke` from ROOT (default: this
checkout; a `git archive` of another commit unpacked anywhere compares
that commit), builds CLI run B's fused K_blk as `chip_smoke.py`'s CLI
phase does (strip-BSR of the four point-cloud levels of the bunny
stand-in), and prints, at k = 64 in 'high' and at k = 1 in 'highest',
the host's time to enqueue one call, in microseconds, of
`bsr_spmm_grouped_cuda` (the wrapper alone), `bsr_spmm` (the autograd
entry, as the solvers call it, with and without grad mode) and
`torch.sparse.mm` of the same matrix as fp32 CSR, each the median over
15 samples of 200 calls enqueued while a busy-wait kernel holds the
card, so that the loop times the host alone; and each call's time on
the card (`device_ms`). Run several roots in turn in one call to
compare them: the host's speed drifts between processes.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time


def host_us(torch, np, fn, reps: int = 200, n: int = 15) -> float:
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(n):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        samples.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return float(np.median(samples))


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import scipy.sparse as sp
    import torch

    if not torch.cuda.is_available():
        print("bsr_host_path: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from eigenpinns_torch.geometry import load_mesh
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.sparse import BSRTile, bsr

    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as work:
        mesh = load_mesh(cs.cli_inputs(work)["obj"], normalize=True)
        h = build_hierarchy(mesh, [256, 512, 1024], n_modes=64,
                            operator_format="auto", device="cpu")
    K_sp = sp.block_diag([K.tocsr() for K in h.K_scipy], format="csr")
    K_blk = BSRTile.from_scipy(K_sp, device=dev, reorder=False)[0]
    csr = cs.torch_csr(K_sp, dev)
    for k, prec in ((64, "high"), (1, "highest")):
        A = K_blk.with_precision(prec)
        U = torch.randn(K_blk.n, k, device=dev)
        calls = {"bsr_spmm_grouped_cuda":
                 lambda: bsr.bsr_spmm_grouped_cuda(A, U),
                 "bsr_spmm": lambda: bsr.bsr_spmm(A, U),
                 "torch.sparse.mm": lambda: torch.sparse.mm(csr, U)}
        out = {name: (host_us(torch, np, fn), cs.device_ms(fn))
               for name, fn in calls.items()}
        with torch.no_grad():
            fn = calls["bsr_spmm"]
            out["bsr_spmm under no_grad"] = (host_us(torch, np, fn),
                                             cs.device_ms(fn))
        print(f"[{os.path.basename(root)}] K_blk {tuple(A.data.shape)} "
              f"k={k} {prec}, host us a call (ms on the card): "
              + ", ".join(f"{name} {h:.2f} ({d:.4f})"
                          for name, (h, d) in out.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
