#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (`eigenpinns_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It exits non-zero, before printing any result, when no CUDA device is
present or the package is not beside it. On the card it:

  1. prints the card (torch's name; nvidia-smi's name and power limit)
     and builds both kernel sources with nvcc, in parallel:
     eigenpinns_torch/csrc/rolling_spmm.cu (K1, the rolling-band SpMM)
     and eigenpinns_torch/csrc/bsr_spmm.cu (K2 and K3, the grouped and
     burst strip-BSR SpMMs), printing the -Xptxas -v reports;
  2. holds K1 against its plain torch version on the card, at the
     shapes the multigrid path gives it: the fused block-diagonal K_blk
     at k = 10 and the finest level's K at k = 39 (the LOBPCG block),
     for W, the fused Gram G and the gradient through
     `rolling_spmm_gram` in 'highest' and 'high' (rel 1e-5 for W and
     G, 1e-4 for the gradient), and in 'bf16' against the plain product
     of the same bf16-rounded operator (rel 2e-3); it times both
     (median of 50 synced launches);
  3. runs the multigrid path at the bench's full width: build_hierarchy
     on a 2562-vertex perturbed icosphere (levels [128, 512, 1024] + the
     full cloud, k = 10, operator_format='auto'), then MultigridTrainer
     with the bench configuration (6x256 MLP, 2000 epochs in chunks of
     500, 100-iteration guarded LOBPCG polish), counting K1's launches
     from zero; it checks the polished eigenvalues against scipy's eigsh
     on the finest level (max rel err of modes 1+ <= 1e-3);
  4. builds the host stage of the direct-training slice: the bench's
     300k-point cloud (`make_cloud`), its point-cloud Laplacian
     (15 neighbors), the strip-BSR K (RCM, C = 8, G = 32) on the card
     and the lumped M; the eigsh oracle (20 modes) runs in a worker
     process meanwhile;
  5. holds K2 (the 300k K) and K3 (the same K without its group tables,
     sharing the strips) against the plain version at k = 20 (training),
     28 (the polish block) and 128 (the SpMM probe) in 'highest', 'high'
     and 'bf16': W to rel 1e-5 (1e-4 in 'bf16', where the plain version
     rounds U the same way), the gradient through `bsr_spmm` to rel
     1e-4; times both, and `bsr_spmm_gram` at k = 128 in 'highest' and
     'bf16' with the bytes the kernel moves;
  6. runs the slice: `train_joint` on the strip-BSR K with the bench's
     configuration (20 modes, 3x256 MLP in bf16, bf16 loss operator,
     300 epochs in chunks of 50), then the k + 8 guarded LOBPCG polish
     (800 iterations, tol 1e-6) on the 'highest' operator, counting K2's
     launches from zero; it checks the polished eigenvalues against the
     oracle (max rel err of modes 1..19 <= 1e-3); then the same training
     on K3 (no group tables), counting K3's launches from zero, which
     must repeat K2's loss history;
  7. prints a JSON line describing the three kernels, then, as the last
     line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

LEVELS = [128, 512, 1024]
N_MODES = 10
TOL = {"highest": 1e-5, "high": 1e-5, "bf16": 2e-3}
GRAD_TOL = 1e-4
MAX_REL_ERR = 1e-3

DIRECT_N = 300_000
DIRECT_K = 20
BSR_TOL = {"highest": 1e-5, "high": 1e-5, "bf16": 1e-4}
DIRECT_CFG = dict(n_modes=DIRECT_K, hidden=(256, 256, 256), mode="penalty",
                  epochs=300, scan_chunk=50, w_res=1.0, w_orth=1000.0,
                  w_trace=0.05, lr_start=2e-3, lr_end=2e-4, seed=0,
                  rayleigh_ritz_finish=False, loss_mxu_precision="bf16",
                  mlp_compute_dtype="bfloat16")
POLISH_GUARD, POLISH_ITERS, POLISH_TOL = 8, 800, 1e-6


def eigsh_values(L, M, k: int) -> np.ndarray:
    """The host oracle's k smallest eigenvalues (runs in a worker)."""
    from eigenpinns_torch.solvers import eigsh_smallest

    return eigsh_smallest(L, M, k)[0]


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
    """K1 vs plain version on one operator; returns the 'high'
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


def check_bsr_kernels(bsr, K, seed):
    """K2 (K's group tables) and K3 (the same strips without them) vs
    the plain version at the slice's widths and modes; returns the
    k = 20 'bf16' (training-loss) row of each kernel."""
    K3 = dataclasses.replace(K, gcid=None, lcid=None, gid=None)
    kernels = {"bsr_spmm_grouped": (K, bsr.bsr_spmm_grouped_cuda),
               "bsr_spmm": (K3, bsr.bsr_spmm_burst_cuda)}
    gen = torch.Generator("cuda").manual_seed(seed)
    rows = {}
    for k in (DIRECT_K, DIRECT_K + POLISH_GUARD, 128):
        U = torch.randn((K.n, k), generator=gen, device="cuda")
        G = torch.randn((K.n, k), generator=gen, device="cuda")
        for prec in ("highest", "high", "bf16"):
            for name, (op, launch) in kernels.items():
                A = op.with_precision(prec)
                W = launch(A, U)
                Wp = bsr.bsr_spmm_plain(A, U)
                # Gradient through the dispatcher (A is symmetric, so
                # A^T = A): against torch autograd through the plain
                # version in fp32; in 'bf16', where the kernel rounds the
                # cotangent to bf16, against the plain product A g.
                Uk = U.clone().requires_grad_(True)
                (bsr.bsr_spmm(A, Uk) * G).sum().backward()
                if prec == "bf16":
                    g_ref = bsr.bsr_spmm_plain(A, G)
                else:
                    Up = U.clone().requires_grad_(True)
                    (bsr.bsr_spmm_plain(A, Up) * G).sum().backward()
                    g_ref = Up.grad
                torch.cuda.synchronize()
                errs = {"W": rel_err(W, Wp), "dU": rel_err(Uk.grad, g_ref)}
                del Uk, g_ref
                ms = median_ms(lambda: launch(A, U))
                plain_ms = median_ms(lambda: bsr.bsr_spmm_plain(A, U))
                print(f"[kernel] {name} {tuple(A.data.shape)} k={k} {prec}: "
                      f"rel_err_W={errs['W']:.3e} rel_err_dU={errs['dU']:.3e}"
                      f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}",
                      flush=True)
                check(errs["W"] <= BSR_TOL[prec],
                      f"{name} k={k} {prec} W: rel err {errs['W']:.3e}")
                check(errs["dU"] <= GRAD_TOL,
                      f"{name} k={k} {prec} dU: rel err {errs['dU']:.3e}")
                if k == DIRECT_K and prec == "bf16":
                    rows[name] = {"max_abs_err": float((W - Wp).abs().max()),
                                  "ms": ms, "plain_ms": plain_ms}
            torch.cuda.empty_cache()
    # The SpMM + Gram probe of the bench's 300k phase (k = 128).
    U = torch.randn((K.n, 128), generator=gen, device="cuda")
    for prec in ("highest", "bf16"):
        A = K.with_precision(prec)
        ms = median_ms(lambda: bsr.bsr_spmm_gram(A, U))
        moved = bsr.bsr_spmm_hbm_bytes(A, 128)
        print(f"[kernel] bsr_spmm_gram k=128 {prec}: {ms:.4f} ms, "
              f"{moved / 1e9:.3f} GB moved by the kernel + W, "
              f"{moved / ms / 1e6:.1f} GB/s", flush=True)
    return rows


def direct_slice(bsr, K, M, X, oracle):
    """train_joint on the strip-BSR K, then the guarded LOBPCG polish;
    returns (K2 launches, the loss history)."""
    from eigenpinns_torch.solvers import lobpcg, train_joint

    device = K.data.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for key in bsr.bsr_kernel_launches:
        bsr.bsr_kernel_launches[key] = 0
    t0 = time.time()
    res = train_joint(K, M, X, device=device, **DIRECT_CFG)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    train_launches = dict(bsr.bsr_kernel_launches)
    rates = sorted(n / t for n, t in res.chunk_times[1:])
    t0 = time.time()
    guards = torch.as_tensor(np.random.default_rng(3).normal(
        size=(K.n, POLISH_GUARD)).astype(np.float32), device=device)
    X0 = torch.cat([torch.as_tensor(res.eigenvectors, device=device),
                    guards], dim=1)
    pol = lobpcg(K, M, X0, max_iter=POLISH_ITERS, tol=POLISH_TOL)
    torch.cuda.synchronize()
    polish_s = time.time() - t0
    launches = dict(bsr.bsr_kernel_launches)
    peak_mb = torch.cuda.max_memory_allocated(device) / 2**20

    vals = oracle.result()
    lam_raw = np.sort(res.eigenvalues)[:DIRECT_K]
    lam_pol = np.sort(pol.eigenvalues.cpu().numpy())[:DIRECT_K]
    raw = np.abs(lam_raw[1:] - vals[1:]) / np.abs(vals[1:])
    polished = np.abs(lam_pol[1:] - vals[1:]) / np.abs(vals[1:])
    loss = res.history["loss"]
    print(f"[direct] train_joint {res.epochs_run} epochs: train "
          f"{train_s:.3f} s, per-chunk median {rates[len(rates) // 2]:.2f} "
          f"steps/s, chunk times "
          f"{[round(t, 4) for _, t in res.chunk_times]}", flush=True)
    print(f"[direct] loss {loss[0]:.6g} -> {loss[-1]:.6g}; polish "
          f"{int(pol.iterations)} iterations in {polish_s:.3f} s; peak "
          f"device memory {peak_mb:.1f} MiB; kernel launches {launches} "
          f"(training {train_launches})", flush=True)
    print(f"[direct] polished {np.array2string(lam_pol, precision=6)}\n"
          f"[direct] eigsh    {np.array2string(vals, precision=6)}\n"
          f"[direct] max rel err of modes 1..19 vs eigsh: raw "
          f"{raw.max():.3e}, polished {polished.max():.3e} (bars the port "
          f"inherits: 8.0e-5 at 300k, 1.71e-3 at 1M)", flush=True)
    check(launches["grouped"] > 0, "train_joint launched K2 0 times")
    check(bool(np.isfinite(loss).all() and np.isfinite(res.eigenvectors).all()
               and np.isfinite(lam_pol).all()), "non-finite direct results")
    check(polished.max() <= MAX_REL_ERR,
          f"direct polished max rel err {polished.max():.3e} > "
          f"{MAX_REL_ERR}")
    return launches["grouped"], loss


def burst_slice(bsr, K, M, X, ref_loss):
    """The same training on K3 (the K without its group tables, sharing
    the strips); returns K3's launches. Both kernels sum a row tile's
    real slots in the same order and K3's pad slots add exact zeros, so
    the loss history must repeat K2's."""
    from eigenpinns_torch.solvers import train_joint

    K3 = dataclasses.replace(K, gcid=None, lcid=None, gid=None)
    for key in bsr.bsr_kernel_launches:
        bsr.bsr_kernel_launches[key] = 0
    t0 = time.time()
    res = train_joint(K3, M, X, device=K.data.device, **DIRECT_CFG)
    torch.cuda.synchronize()
    launches = dict(bsr.bsr_kernel_launches)
    dev = float(np.abs(res.history["loss"] - ref_loss).max()
                / np.abs(ref_loss).max())
    print(f"[burst] train_joint on K3 {res.epochs_run} epochs in "
          f"{time.time() - t0:.3f} s; kernel launches {launches}; loss "
          f"history vs the K2 run: max rel diff {dev:.3e}", flush=True)
    check(launches["burst"] > 0, "the ungrouped run launched K3 0 times")
    check(dev <= 1e-6, f"K3 training differs from K2's: {dev:.3e}")
    return launches["burst"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    import scipy.sparse as sp

    from eigenpinns_torch.configs import Config
    from eigenpinns_torch.geometry import point_cloud_laplacian
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.solvers import MultigridTrainer, eigsh_smallest
    from eigenpinns_torch.sparse import BSRTile, Diagonal, RollingBanded
    from eigenpinns_torch.sparse import bsr, rolling
    from eigenpinns_torch.utils.cuda_build import build_logs
    from eigenpinns_torch.utils.fixtures import make_cloud, perturbed_icosphere

    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} ({smi})", flush=True)

    # 1. Build both kernel sources from the checkout, one nvcc each, in
    # parallel.
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(rolling.build_kernel),
                  pool.submit(bsr.build_kernel)]:
            f.result()
    print(f"[build] rolling_spmm.cu and bsr_spmm.cu built in "
          f"{time.time() - t0:.2f} s", flush=True)
    for name in ("rolling_spmm", "bsr_spmm"):
        print(build_logs.get(name, "").strip(), flush=True)

    # 2. K1 vs plain at the multigrid path's shapes. The operators
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
    del K_blk, K_fine
    torch.cuda.synchronize()

    # 3. The multigrid path, counting K1's launches from zero.
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
    del h, result
    torch.cuda.empty_cache()

    # 4. The direct slice's host stage; the eigsh oracle runs in a worker
    # process while the card works.
    t0 = time.time()
    X = make_cloud(DIRECT_N)
    L, M_sp = point_cloud_laplacian(X, n_neighbors=15)
    print(f"[host] {DIRECT_N} points: Laplacian in {time.time() - t0:.2f} s,"
          f" nnz {L.nnz}", flush=True)
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        t_oracle = time.time()
        oracle = pool.submit(eigsh_values, L, M_sp, DIRECT_K)
        oracle.add_done_callback(lambda f: print(
            f"[host] eigsh oracle ({DIRECT_K} modes) in "
            f"{time.time() - t_oracle:.2f} s", flush=True))
        t0 = time.time()
        K, perm = BSRTile.from_scipy(L, device=device)
        M = Diagonal(torch.as_tensor(np.asarray(M_sp.diagonal())[perm],
                                     dtype=torch.float32, device=device))
        torch.cuda.synchronize()
        print(f"[host] strip-BSR K in {time.time() - t0:.2f} s: "
              f"{tuple(K.data.shape)} ({K.data.nbytes / 1e9:.2f} GB), "
              f"{K.n_chunks} chunks, {K.n_slots} real tiles, max "
              f"{K.strip_w} per row tile, groups {tuple(K.gcid.shape)}",
              flush=True)

        # 5. K2 and K3 vs plain at the slice's shapes.
        bsr_rows = check_bsr_kernels(bsr, K, seed=2)
        torch.cuda.empty_cache()

        # 6. The slice, counting launches from zero.
        Xp = X[perm]
        k2_launches, ref_loss = direct_slice(bsr, K, M, Xp, oracle)
    k3_launches = burst_slice(bsr, K, M, Xp, ref_loss)

    print(json.dumps({"kernels": [
        {"name": "rolling_spmm", "route": "cuda",
         "source": "eigenpinns_torch/csrc/rolling_spmm.cu",
         "replaces": "eigenpinns_tpu/sparse/rolling.py:344",
         "launches": launches, **row},
        {"name": "bsr_spmm_grouped", "route": "cuda",
         "source": "eigenpinns_torch/csrc/bsr_spmm.cu",
         "replaces": "eigenpinns_tpu/sparse/bsr.py:549",
         "launches": k2_launches, **bsr_rows["bsr_spmm_grouped"]},
        {"name": "bsr_spmm", "route": "cuda",
         "source": "eigenpinns_torch/csrc/bsr_spmm.cu",
         "replaces": "eigenpinns_tpu/sparse/bsr.py:672",
         "launches": k3_launches, **bsr_rows["bsr_spmm"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
