#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (`eigenpinns_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It exits non-zero, before printing any result, when no CUDA device is
present or the package is not beside it. On the card it:

  1. prints the card (torch's name; nvidia-smi's name and power limit)
     and builds the rolling-band SpMM kernel from
     eigenpinns_torch/csrc/rolling_spmm.cu with nvcc;
  2. holds the kernel against its plain torch version on the card, at
     the shapes the training path gives it: the fused block-diagonal
     K_blk at k = 10 and the finest level's K at k = 39 (the LOBPCG
     block), for W, the fused Gram G and the gradient through
     `rolling_spmm_gram` in 'highest' and 'high' (rel 1e-5 for W and
     G, 1e-4 for the gradient), and in 'bf16' against the plain product
     of the same bf16-rounded operator (rel 2e-3); it times both
     (median of 50 synced launches);
  3. runs the main path at the bench's full width: build_hierarchy on
     a 2562-vertex perturbed icosphere (levels [128, 512, 1024] + the
     full cloud, k = 10, operator_format='auto'), then
     MultigridTrainer with the bench configuration (6x256 MLP, 2000
     epochs in chunks of 500, 100-iteration guarded LOBPCG polish),
     counting the kernel's launches from zero; it checks the polished
     eigenvalues against scipy's eigsh on the finest level (max rel
     err of modes 1+ <= 1e-3);
  4. prints a JSON line describing the kernel, then, as the last line,
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

LEVELS = [128, 512, 1024]
N_MODES = 10
TOL = {"highest": 1e-5, "high": 1e-5, "bf16": 2e-3}
GRAD_TOL = 1e-4
MAX_REL_ERR = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def median_ms(fn, n: int = 50) -> float:
    """Median of n launches, each timed by CUDA events and synced."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernel(rolling, name, op, k, seed):
    """Kernel vs plain version on one operator; returns the 'high'
    (training-loss mode) row of measurements."""
    gen = torch.Generator("cuda").manual_seed(seed)
    U = torch.randn((op.n, k), generator=gen, device="cuda")
    RW = torch.randn((op.n, k), generator=gen, device="cuda")
    RG = torch.randn((k, k), generator=gen, device="cuda")
    row = None
    for prec in ("highest", "high", "bf16"):
        A = op.with_precision(prec)
        W, G = rolling.rolling_spmm_cuda(A, U, with_gram=True)
        Wp, Gp = rolling.rolling_spmm_gram_plain(A, U)
        torch.cuda.synchronize()
        errs = {"W": rel_err(W, Wp), "G": rel_err(G, Gp)}
        if prec != "bf16":
            # Gradient through the fused Gram: kernel autograd vs torch
            # autograd through the plain version.
            Uk = U.clone().requires_grad_(True)
            Wk, Gk = rolling.rolling_spmm_gram(A, Uk)
            ((Wk * RW).sum() + (Gk * RG).sum()).backward()
            Up = U.clone().requires_grad_(True)
            Wq, Gq = rolling.rolling_spmm_gram_plain(A, Up)
            ((Wq * RW).sum() + (Gq * RG).sum()).backward()
            torch.cuda.synchronize()
            errs["dU"] = rel_err(Uk.grad, Up.grad)
        ms = median_ms(lambda: rolling.rolling_spmm_cuda(A, U))
        plain_ms = median_ms(lambda: rolling.rolling_spmm_plain(A, U))
        print(f"[kernel] {name} {tuple(A.band.shape)} k={k} {prec}: "
              + " ".join(f"rel_err_{key}={v:.3e}" for key, v in errs.items())
              + f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        for key, v in errs.items():
            tol = GRAD_TOL if key == "dU" else TOL[prec]
            check(v <= tol, f"{name} {prec} {key}: rel err {v:.3e} > {tol}")
        if prec == "high":
            row = {"max_abs_err": float((W - Wp).abs().max()), "ms": ms,
                   "plain_ms": plain_ms}
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    import scipy.sparse as sp

    from eigenpinns_torch.configs import Config
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.solvers import MultigridTrainer, eigsh_smallest
    from eigenpinns_torch.sparse import RollingBanded
    from eigenpinns_torch.sparse import rolling
    from eigenpinns_torch.utils.cuda_build import build_logs
    from eigenpinns_torch.utils.fixtures import perturbed_icosphere

    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)

    # 1. Build the kernel from the checkout's sources.
    t0 = time.time()
    rolling.build_kernel()
    print(f"[build] rolling_spmm.cu built in {time.time() - t0:.2f} s",
          flush=True)
    print(build_logs.get("rolling_spmm", "").strip(), flush=True)

    # 2. Kernel vs plain at the training path's shapes. The operators
    # come from a host-side (CPU) build of the same hierarchy, which
    # launches no kernel.
    mesh = perturbed_icosphere(4)
    h_cpu = build_hierarchy(mesh, LEVELS, n_modes=N_MODES,
                            operator_format="auto", device="cpu")
    K_blk = RollingBanded.from_scipy(
        sp.block_diag([K.tocsr() for K in h_cpu.K_scipy], format="csr"),
        device=device, reorder=False)[0]
    K_fine = RollingBanded.from_scipy(h_cpu.K_scipy[-1], device=device,
                                      reorder=False)[0]
    row = check_kernel(rolling, "K_blk", K_blk, N_MODES, seed=0)
    check_kernel(rolling, "K_finest", K_fine, 3 * (N_MODES + 3), seed=1)
    torch.cuda.synchronize()

    # 3. The main path, counting kernel launches from zero.
    cfg = Config(
        n_modes=N_MODES, hierarchy=LEVELS, hidden_layers=[256] * 6,
        epochs=2000, scan_chunk=500, corrector_scale=10.0,
        weight_residual=1000.0, weight_orthogonal=10.0, log_every=0,
        early_stop_patience=10**9, plateau_patience=2000, polish_iters=100)
    torch.cuda.reset_peak_memory_stats(device)
    rolling.rolling_kernel_launches = 0
    t0 = time.time()
    h = build_hierarchy(mesh, LEVELS, n_modes=N_MODES,
                        operator_format="auto", device=device)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    t0 = time.time()
    result = MultigridTrainer(cfg).train(h)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = rolling.rolling_kernel_launches
    peak_mb = torch.cuda.max_memory_allocated(device) / 2**20

    steady = result.chunk_times[1:] or result.chunk_times
    rates = sorted(n / t for n, t in steady)
    steps_per_s = rates[len(rates) // 2]
    loss = result.history["loss"]
    vals, _ = eigsh_smallest(h.K_scipy[-1], h.M_scipy[-1], N_MODES)
    rel = np.abs(result.eigenvalues[1:] - vals[1:]) / np.abs(vals[1:])
    u_dev = max(rel_err(a.cpu(), b) for a, b in zip(h.U_list, h_cpu.U_list))
    print(f"[slice] hierarchy {h.actual_hierarchy}, K ops "
          f"{[type(o).__name__ for o in h.K_ops]}, build {build_s:.3f} s, "
          f"U_init vs CPU build rel err {u_dev:.3e}", flush=True)
    print(f"[slice] {result.epochs_run} epochs: train {result.wall_time:.3f}"
          f" s, per-chunk median {steps_per_s:.2f} steps/s, chunk times "
          f"{[round(t, 4) for _, t in result.chunk_times]}, polish "
          f"{result.polish_iterations} iterations + extraction "
          f"{result.polish_time:.3f} s, train() total {total_s:.3f} s",
          flush=True)
    print(f"[slice] loss {loss[0]:.6g} -> {loss[-1]:.6g}; kernel launches "
          f"{launches}; peak device memory {peak_mb:.1f} MiB", flush=True)
    print(f"[slice] finest-level Rayleigh-Ritz before the polish "
          f"{np.array2string(result.level_eigenvalues[-1], precision=6)}",
          flush=True)
    print(f"[slice] eigenvalues {np.array2string(result.eigenvalues, precision=6)}"
          f"\n[slice] eigsh       {np.array2string(vals, precision=6)}"
          f"\n[slice] max rel err (modes 1+) {rel.max():.3e}", flush=True)
    check(launches > 0, "the main path launched the rolling kernel 0 times")
    check(result.eigenvalues.shape == (N_MODES,)
          and result.eigenvectors.shape == (h.actual_hierarchy[-1], N_MODES),
          "unexpected result shapes")
    check(bool(np.isfinite(result.eigenvalues).all()
               and np.isfinite(result.eigenvectors).all()
               and np.isfinite(loss).all()), "non-finite results")
    check(u_dev <= 1e-4, f"device hierarchy build differs from the CPU "
          f"build: {u_dev:.3e}")
    check(rel.max() <= MAX_REL_ERR,
          f"max rel err {rel.max():.3e} > {MAX_REL_ERR}")

    print(json.dumps({"kernels": [{
        "name": "rolling_spmm", "route": "cuda",
        "source": "eigenpinns_torch/csrc/rolling_spmm.cu",
        "replaces": "eigenpinns_tpu/sparse/rolling.py:344",
        "launches": launches, **row}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
