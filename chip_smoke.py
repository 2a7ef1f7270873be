#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (`eigenpinns_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It exits non-zero, before printing any result, when no CUDA device is
present or the package is not beside it. On the card it:

  1. prints the card (torch's name; nvidia-smi's name and power limit)
     and builds the two kernel sources with nvcc, one process each, in
     parallel: eigenpinns_torch/csrc/bsr_spmm.cu (K2 and K3, the grouped
     and burst strip-BSR SpMMs) and banded_spmm.cu (K4 and K5, the
     full-window band SpMM and its fused Gram, and K1, the rolling-band
     SpMM with and without the Gram: the same kernel with implicit,
     wrapping window starts), printing the -Xptxas -v reports;
  2. holds K1 against its plain torch version on the card, at the
     shapes the multigrid path gives it: the fused block-diagonal K_blk
     at k = 10 and the finest level's K at k = 39 (the LOBPCG block),
     for W, the fused Gram G and the gradient through
     `rolling_spmm_gram` in 'highest' and 'high' (rel 1e-5 for W and
     G, 1e-4 for the gradient), and in 'bf16' against the plain product
     of the same bf16-rounded operator (rel 2e-3); W must be the same
     bit for bit from a second launch, from the other column block and
     with the Gram, G from a second launch; it prints each band's
     occupied 16 x 16 sub-blocks, times the kernel and its plain version
     (median of 20 samples of 5 back-to-back launches) and
     torch.sparse.mm of the same operator as a CSR tensor (the library
     yardstick);
  3. runs the multigrid path at the bench's full width: build_hierarchy
     on a 2562-vertex perturbed icosphere (levels [128, 512, 1024] + the
     full cloud, k = 10, operator_format='auto'), then MultigridTrainer
     with the bench configuration (6x256 MLP, 2000 epochs in chunks of
     500, 100-iteration guarded LOBPCG polish), counting K1's launches
     from zero; it checks the polished eigenvalues against scipy's eigsh
     on the finest level (max rel err of modes 1+ <= 1e-3);
  4. builds the host stage of the 300k slices: the bench's 300k-point
     cloud (`make_cloud`), its point-cloud Laplacian (15 neighbors), the
     strip-BSR K (RCM, C = 8, G = 32) on the card and the lumped M; the
     eigsh oracle (50 modes) runs in a worker process meanwhile;
  5. holds the occupancy-driven K2 (the 300k K) and K3 (the same K
     without its group tables, sharing the strips and the occupancy
     table) against the plain version at k = 20 (training), 28 (the
     polish block), 60 and 128 (the SpMM probe) in 'highest', 'high'
     and 'bf16': W to rel 1e-5 (1e-4 in 'bf16', where the plain version
     rounds U the same way), the gradient through `bsr_spmm` to rel
     1e-4, W the same bit for bit from a second launch and from the
     other column block (32 or 64 output columns per block); prints the
     occupied share of the tiles' 16 x 16 sub-blocks; times both
     kernels (both column blocks at k = 60 and 128), torch.sparse.mm,
     and `bsr_spmm_gram` at k = 128 in 'highest' and 'bf16' with the
     bytes the kernel moves; then one adversarial operator per format
     (strip-BSR, band and rolling band, n = 1000: a single nonzero in
     the last sub-block of a tile, entries in the last row and column, a
     column tile and a window that reach past n, for the rolling band
     also a window that starts before row 0 and the stored transpose)
     against the plain version and the dense product;
  6. builds the split operators of the 300k cloud: the cluster-ordered
     SplitBanded of the spectral-basis driver (window 1024, fp32) and the
     Hilbert-ordered training operator (window 512) in bf16 and, from
     the same permutation, in fp32; holds K4 and K5 against the plain
     version on the cluster core at k = 20 and 60, on the Hilbert core in
     fp32 at k = 20 and 28 (the polish block) and in bf16 at k = 20 (W rel
     1e-5, G rel 2e-5, the gradient
     through `banded_spmm_gram` rel 1e-4; W the same bit for bit from a
     second launch, from the other column block and from K5), prints each
     core's occupied share of 16 x 16 sub-blocks, times them (K4 with
     both column blocks), their plain
     version and torch.sparse.mm of the core (+ U^T W for K5), and K2
     at k = 20 and 60 beside them;
  7. runs the direct-training slice: `train_joint` on the strip-BSR K
     with the bench's configuration (20 modes, 3x256 MLP in bf16, bf16
     loss operator, 300 epochs in chunks of 50), then the k + 8 guarded
     LOBPCG polish (800 iterations, tol 1e-6) on the 'highest' operator,
     counting K2's launches from zero; it checks the polished eigenvalues
     against the oracle's first 20 (max rel err of modes 1..19 <= 1e-3);
     then the same training on K3 (no group tables), counting K3's
     launches from zero, which must repeat K2's loss history; then the
     rolling-band slice, the bench's 300k training phase at its own
     size: the RCM-ordered rolling band of the same Laplacian
     (max_bandwidth 8192; its pre, B, size and occupied share are
     printed), K1 against its plain version on it at k = 20 (training),
     28 and 84 (the polish's K X and K S) in all three modes, with
     torch.sparse.mm of the same matrix beside it; `train_joint` with
     the same configuration (K1 with the fused Gram on a bf16 copy of
     the band; timed, then once more under torch.profiler, which must
     repeat the loss history), then the guarded polish on the
     fp32 band, counting K1's launches from zero for each; the polished
     modes 1..19 must be within 1e-3 of the oracle;
  8. runs the spectral-basis slice: `spectral_basis` on the 300k cloud
     with the configuration of scripts/run_1m_50modes_split.py (k = 50,
     SplitBanded window 1024, blocks of 16 + 4 guard, 120 iterations, tol
     2e-4, 65536-point coarse warm start) counting K4's launches from
     zero; it checks modes 1..49 against the 50-mode oracle (max rel err
     <= 1e-3), the M-orthonormality of the basis (<= 1e-3) and that the
     vectors come back in the original point order (their Rayleigh
     quotients on L match the eigenvalues);
  9. runs the fused-Gram path: `train_joint` with the direct slice's
     configuration on the Hilbert SplitBanded K (bf16 core), then the
     guarded polish on its fp32 twin, counting K5's and K4's launches
     from zero; the polished modes 1..19 must be within 1e-3 of the
     oracle;
 10. holds K3 against the plain version on each member's padded
     operator of the family of three 20k-point clouds (zero pad rows and
     pad chunks, no group tables) at the widths its solve gives it (W rel
     1e-5, the gradient through `bsr_spmm` rel 1e-4), then runs
     `spectral_basis_family` on them (k = 16, 4096-point coarse warm
     start), counting K3's launches from zero, and checks each member
     against its own eigsh (<= 1e-3);
 11. prints a JSON line describing the five kernels (launches on their
     path, max abs err, kernel, plain and library times; K1 with its
     300k row beside the multigrid one; and the bound:
     the larger of the bytes the product must move -- each nonzero's
     value and column index, the row pointers, U and W, the Gram for K5
     -- over 3.35 TB/s and its operations, 2 nnz k (+ 2 n k^2 for the
     Gram), over the peak rate for their type), the card's name and
     power limit, then, as the last line, {"ok": true, "device": {...}}.
     Each phase prints its wall time.

Steps 8 and 9 and the rolling-band training run under torch.profiler
(CPU and CUDA activities) and print, over the spectral solve (the
`spectral_basis.solve` span) and over each training, the card's kernel
time, its copy time and its idle share, and the kernels with the most
device time; those phases' wall times include the profiler's own cost
(mostly the parsing of the trace after each).
"""

from __future__ import annotations

import collections
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

# The spectral-basis slice: scripts/run_1m_50modes_split.py's settings on
# the 300k cloud (the one cut: 1M -> 300k points).
SPEC_K = 50
SPEC_CFG = dict(k=SPEC_K, n_neighbors=15, coarse_n=65536,
                prolongation_neighbors=8, window=1024, block=16, guard=4,
                max_iter=120, tol=2e-4, operator_format="split")
HILBERT_WINDOW = 512
BANDED_TOL = {"W": 1e-5, "G": 2e-5, "dU": 1e-4}
FAMILY_N, FAMILY_K, FAMILY_COARSE = 20_000, 16, 4096
# K3's widths in the family's solves: the block + guard columns of a
# sweep (K X, the closing Rayleigh-Ritz) and the [X, W, P] basis (K S).
FAMILY_WIDTHS = (FAMILY_K + 4, 3 * (FAMILY_K + 4))

# Published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and
# FLOP/s of fp32 FFMA and of bf16 tensor-core products.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


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


def median_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Time of one launch: the median over n samples, each the mean of
    `reps` back-to-back launches between two CUDA events, synced after.
    The launches of a sample queue up behind the first, so the host's
    launch latency (tens of microseconds a call) is not counted as the
    card's time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def device_ms(fn, n: int = 5, reps: int = 20) -> float:
    """One call's time on the card when the host is not in its way: the
    median over n samples of `reps` calls queued behind a busy-wait
    kernel, which holds the stream while the host enqueues them, so that
    they run back to back between the two events. For a small operator
    the host's launch path (tens of microseconds a call) is longer than
    the kernel, and `median_ms` then times the host. The wait is doubled
    until the host's enqueue loop fits inside it."""
    fn()
    cycles = 4_000_000
    while True:
        torch.cuda.synchronize()
        times, fits = [], True
        for _ in range(n):
            wait, start, end = (torch.cuda.Event(enable_timing=True)
                                for _ in range(3))
            wait.record()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            torch.cuda.synchronize()
            fits = fits and host_ms < wait.elapsed_time(start)
            times.append(start.elapsed_time(end) / reps)
        if fits:
            return float(np.median(times))
        check(cycles < 10**9, "device_ms: the host never fits in the wait")
        cycles *= 2


def bound(n_bytes: float, flops: dict) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the HBM rate and its operations ({type:
    count}) over the peak rate of their type; and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[kind] for kind, n in flops.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def least_bytes(nnz: int, value_bytes: int, n: int, k: int,
                gram: bool = False) -> int:
    """Least bytes of W = A U (n x n A with nnz nonzeros, U and W fp32 of
    width k): each nonzero's value and 4-byte column index and the row
    pointers read once, U read once, W (and the k x k fp32 Gram) written
    once. Zeros that a kernel's tiles hold are not counted."""
    return (nnz * (value_bytes + 4) + (n + 1) * 4 + 2 * n * k * 4
            + (k * k * 4 if gram else 0))


def torch_csr(A, device) -> torch.Tensor:
    """A scipy matrix as an fp32 torch CSR tensor on `device` (for the
    library yardstick torch.sparse.mm only)."""
    A = A.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int64),
        torch.as_tensor(A.indices, dtype=torch.int64),
        torch.as_tensor(A.data, dtype=torch.float32), A.shape,
        device=device)


def band_csr(core) -> torch.Tensor:
    """A BandedELL's entries (as stored, in fp32) as a torch CSR tensor
    on its device, for the library yardstick."""
    band = core.band.float()
    r, j = torch.nonzero(band, as_tuple=True)
    c = core.starts.long()[r // core.tile] + j
    coo = torch.sparse_coo_tensor(torch.stack([r, c]), band[r, j],
                                  (core.n, core.n_cols))
    return coo.coalesce().to_sparse_csr()


def occupied_share(table: torch.Tensor, n_words: int | None = None) -> str:
    """The occupied 16 x 16 sub-blocks of an occupancy table, as a count
    and as a share of the sub-blocks of `n_words` 128 x 128 pieces (the
    whole table when not given)."""
    from eigenpinns_torch.sparse import occupied_blocks

    n = occupied_blocks(table)
    total = 64 * (table.numel() if n_words is None else n_words)
    return f"{n} of {total} ({n / total:.4f})"


def stripe_counts(table: torch.Tensor, n: int) -> str:
    """Occupied sub-blocks per 16-row stripe of a band with `n` real rows:
    the mean and the largest count, and the mean over the tiles of (the
    busiest stripe / the tile's mean stripe). Byte i of a table word is
    stripe i's column-group mask."""
    masks = table.contiguous().view(torch.uint8).view(*table.shape, 8)
    bits = (masks.unsqueeze(-1) >> torch.arange(8, device=table.device)) & 1
    per_stripe = bits.sum(dim=(1, 3)).double()          # (tiles, 8)
    real = per_stripe.flatten()[: -(-n // 16)]
    tile_mean = per_stripe.mean(dim=1).clamp(min=1e-30)
    skew = (per_stripe.max(dim=1).values / tile_mean)[tile_mean >= 1 / 8]
    return (f"{float(real.mean()):.2f} sub-blocks per stripe (at most "
            f"{int(real.max())}; busiest stripe of a tile / its mean "
            f"{float(skew.mean()):.2f})")


class Phases:
    """Wall time of each phase, printed as it ends."""

    def __init__(self):
        self.t0 = time.time()

    def done(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.time()
        print(f"[time] {name}: {now - self.t0:.2f} s", flush=True)
        self.t0 = now


def traced():
    """A torch.profiler run of CPU and CUDA activities."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_report(label: str, prof, span: str, steps: int = 1,
                  top: int = 10, pick: str | None = None) -> None:
    """What the card did inside the record_function `span` of a profiler
    run: the span's CPU interval is the window (it ends on a sync, so the
    work launched in it ends in it), a device event belongs to it when it
    starts inside. Kernels are summed by name, memory copies and sets on
    their own; one stream, so none overlap. The idle share is the part of
    the window in which neither ran. `pick`: also print the sum over the
    kernels whose name contains it."""
    from torch.autograd import DeviceType

    events = prof.events()
    spans = [e for e in events
             if e.name == span and e.device_type == DeviceType.CPU]
    check(len(spans) == 1, f"{label}: {len(spans)} profiler spans {span}")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    window = (hi - lo) / 1e6
    kernels = collections.defaultdict(lambda: [0, 0.0])
    copies = [0, 0.0]
    n_run = 0   # device events of the whole run, the span's included
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == span
                or getattr(e, "is_user_annotation", False)):
            continue
        n_run += 1
        if not lo <= e.time_range.start <= hi:
            continue
        slot = (copies if e.name.startswith(("Memcpy", "Memset"))
                else kernels[e.name])
        slot[0] += 1
        slot[1] += e.time_range.elapsed_us() / 1e6
    check(bool(kernels), f"{label}: the profiler saw no kernel in {span}")
    busy = sum(t for _, t in kernels.values())
    print(f"[profile {label}] window ({span}) {window:.3f} s: kernels "
          f"{busy:.3f} s ({sum(n for n, _ in kernels.values())} launches),"
          f" copies and sets {copies[1]:.3f} s ({copies[0]}; {n_run} device"
          f" events in the whole run), idle share "
          f"{1 - (busy + copies[1]) / window:.3f}; per step ({steps}): "
          f"{busy / steps * 1e3:.3f} ms kernels, {window / steps * 1e3:.3f}"
          f" ms wall", flush=True)
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[
            :top]:
        print(f"[profile {label}]   {t * 1e3:10.3f} ms {100 * t / busy:5.1f}%"
              f" {n:7d}x  {name[:100]}", flush=True)
    if pick is not None:
        n, t = (sum(v[i] for name, v in kernels.items() if pick in name)
                for i in (0, 1))
        print(f"[profile {label}] kernels named *{pick}*: {t * 1e3:.3f} ms "
              f"({100 * t / busy:.1f}% of the kernel time), {n} launches, "
              f"{t / steps * 1e3:.4f} ms per step", flush=True)


def describe_band(name: str, op) -> None:
    """A rolling band's layout and occupancy counts."""
    print(f"[kernel] {name} {tuple(op.band.shape)} {op.band.dtype} "
          f"({op.band.nbytes / 1e9:.3f} GB) pre={op.pre} B={op.win}: occupied"
          f" 16 x 16 sub-blocks {occupied_share(op.occupancy)}, "
          f"{stripe_counts(op.occupancy, op.n)}", flush=True)


def check_kernel(rolling, name, op, A_sp, k, seed, row_prec="high",
                 plain_samples=(20, 5)):
    """K1 vs plain version on one operator (`A_sp`, its scipy matrix, is
    the library yardstick's input) in the three modes; returns the
    `row_prec` row of measurements ('high' is the multigrid loss's mode,
    'bf16' the direct training's). `plain_samples`: (n, reps) of the
    plain version's timing, fewer on a large operator."""
    gen = torch.Generator("cuda").manual_seed(seed)
    U = torch.randn((op.n, k), generator=gen, device="cuda")
    RW = torch.randn((op.n, k), generator=gen, device="cuda")
    RG = torch.randn((k, k), generator=gen, device="cuda")
    row = None
    for prec in ("highest", "high", "bf16"):
        A = op.with_precision(prec)
        other = 96 - rolling.default_col_block(k, A.band.dtype)
        W, G = rolling.rolling_spmm_cuda(A, U, with_gram=True)
        Wp, Gp = rolling.rolling_spmm_gram_plain(A, U)
        torch.cuda.synchronize()
        errs = {"W": rel_err(W, Wp), "G": rel_err(G, Gp)}
        # No atomics, one summation order: without the Gram, from the
        # other column block and from a second launch W is the same bit
        # for bit, and G from a second launch.
        W2, G2 = rolling.rolling_spmm_cuda(A, U, with_gram=True,
                                           col_block=other)
        check(torch.equal(rolling.rolling_spmm_cuda(A, U), W)
              and torch.equal(
                  rolling.rolling_spmm_cuda(A, U, col_block=other), W)
              and torch.equal(W2, W), f"{name} k={k} {prec}: W differs "
              "between launches, column blocks or with the Gram")
        check(torch.equal(
            rolling.rolling_spmm_cuda(A, U, with_gram=True)[1], G),
            f"{name} k={k} {prec}: G differs between two launches")
        errs["G_other"] = rel_err(G2, Gp)
        del W2, G2
        # Gradient through the fused Gram: kernel autograd vs torch
        # autograd through the plain version; in 'bf16', where the kernel
        # rounds the cotangent to bf16, vs dU = A^T (gW + U gG) + W gG^T
        # from the plain version (which rounds it the same way).
        Uk = U.clone().requires_grad_(True)
        Wk, Gk = rolling.rolling_spmm_gram(A, Uk)
        ((Wk * RW).sum() + (Gk * RG).sum()).backward()
        if prec == "bf16":
            At = A.transpose_rolling if A.transpose_rolling is not None else A
            dU_ref = rolling.rolling_spmm_plain(At, RW + U @ RG) + Wp @ RG.T
        else:
            Up = U.clone().requires_grad_(True)
            Wq, Gq = rolling.rolling_spmm_gram_plain(A, Up)
            ((Wq * RW).sum() + (Gq * RG).sum()).backward()
            dU_ref = Up.grad
            del Up, Wq, Gq
        torch.cuda.synchronize()
        errs["dU"] = rel_err(Uk.grad, dU_ref)
        del Uk, Wk, Gk, dU_ref
        torch.cuda.empty_cache()
        ms = median_ms(lambda: rolling.rolling_spmm_cuda(A, U))
        other_ms = median_ms(
            lambda: rolling.rolling_spmm_cuda(A, U, col_block=other))
        gram_ms = median_ms(
            lambda: rolling.rolling_spmm_cuda(A, U, with_gram=True))
        plain_ms = median_ms(lambda: rolling.rolling_spmm_plain(A, U),
                             *plain_samples)
        print(f"[kernel] {name} {tuple(A.band.shape)} k={k} {prec}: "
              + " ".join(f"rel_err_{key}={v:.3e}" for key, v in errs.items())
              + f" kernel_ms={ms:.4f} (col_block {96 - other}; "
              f"{other_ms:.4f} with {other}) with_gram_ms={gram_ms:.4f} "
              f"plain_ms={plain_ms:.4f}", flush=True)
        for key, v in errs.items():
            tol = GRAD_TOL if key == "dU" else TOL[prec]
            check(v <= tol, f"{name} {prec} {key}: rel err {v:.3e} > {tol}")
        if prec == row_prec:
            csr = torch_csr(A_sp, U.device)
            library_ms = median_ms(lambda: torch.sparse.mm(csr, U))
            gram_library_ms = median_ms(
                lambda: U.T @ torch.sparse.mm(csr, U))
            on_card = {
                "device_ms": device_ms(
                    lambda: rolling.rolling_spmm_cuda(A, U)),
                "with_gram_device_ms": device_ms(
                    lambda: rolling.rolling_spmm_cuda(A, U, with_gram=True)),
                "library_device_ms": device_ms(
                    lambda: torch.sparse.mm(csr, U))}
            del csr
            nnz = int(torch.count_nonzero(A.band))
            vb = A.band.element_size()
            kind = "bf16" if prec == "bf16" else "fp32"
            b_gram = bound(least_bytes(nnz, vb, A.n, k, gram=True),
                           {kind: 2 * nnz * k, "fp32": 2 * A.n * k * k})
            row = {"max_abs_err": float((W - Wp).abs().max()), "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   **bound(least_bytes(nnz, vb, A.n, k),
                           {kind: 2 * nnz * k}),
                   "with_gram_ms": gram_ms,
                   "with_gram_library_ms": gram_library_ms,
                   "with_gram_bound_ms": b_gram["bound_ms"], **on_card}
            print(f"[kernel] {name} k={k} {prec}: torch.sparse.mm "
                  f"{library_ms:.4f} ms (+ U^T W {gram_library_ms:.4f}), "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; with "
                  f"the Gram {b_gram['bound_ms']:.4f}), nnz {nnz}; queued "
                  f"behind a busy-wait (no host in the way): kernel "
                  f"{on_card['device_ms']:.4f} ms, with the Gram "
                  f"{on_card['with_gram_device_ms']:.4f}, torch.sparse.mm "
                  f"{on_card['library_device_ms']:.4f}", flush=True)
        del W, G, Wp, Gp
        torch.cuda.empty_cache()
    return row


def check_bsr_kernels(bsr, K, K_sp, seed):
    """K2 (K's group tables) and K3 (the same strips without them) vs
    the plain version at the slice's widths and modes (`K_sp`, K's scipy
    matrix in its own order, is the library yardstick's input); returns
    the k = 20 'bf16' (training-loss) row of each kernel."""
    K3 = dataclasses.replace(K, gcid=None, lcid=None, gid=None)
    kernels = {"bsr_spmm_grouped": (K, bsr.bsr_spmm_grouped_cuda),
               "bsr_spmm": (K3, bsr.bsr_spmm_burst_cuda)}
    gen = torch.Generator("cuda").manual_seed(seed)
    print(f"[kernel] strip-BSR K: occupied 16 x 16 sub-blocks of the real "
          f"tiles {occupied_share(K.occupancy, K.n_slots)}; of every slot, "
          f"pad slots included, {occupied_share(K.occupancy)}", flush=True)
    rows = {}
    for k in (DIRECT_K, DIRECT_K + POLISH_GUARD, SPEC_K + 10, 128):
        U = torch.randn((K.n, k), generator=gen, device="cuda")
        G = torch.randn((K.n, k), generator=gen, device="cuda")
        for prec in ("highest", "high", "bf16"):
            for name, (op, launch) in kernels.items():
                A = op.with_precision(prec)
                W = launch(A, U)
                Wp = bsr.bsr_spmm_plain(A, U)
                # No atomics, one summation order: a second launch and
                # the other column block give the same bits.
                check(torch.equal(launch(A, U), W),
                      f"{name} k={k} {prec}: two launches differ")
                other = 96 - bsr.default_col_block(k, A.data.dtype)
                check(torch.equal(launch(A, U, col_block=other), W),
                      f"{name} k={k} {prec}: col_block {other} differs")
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
                both = ""
                if k > 32 and prec != "high":
                    other_ms = median_ms(
                        lambda: launch(A, U, col_block=other))
                    both = (f" (col_block {96 - other}; {other_ms:.4f} ms "
                            f"with {other})")
                print(f"[kernel] {name} {tuple(A.data.shape)} k={k} {prec}: "
                      f"rel_err_W={errs['W']:.3e} rel_err_dU={errs['dU']:.3e}"
                      f" kernel_ms={ms:.4f}{both} plain_ms={plain_ms:.4f}",
                      flush=True)
                check(errs["W"] <= BSR_TOL[prec],
                      f"{name} k={k} {prec} W: rel err {errs['W']:.3e}")
                check(errs["dU"] <= GRAD_TOL,
                      f"{name} k={k} {prec} dU: rel err {errs['dU']:.3e}")
                if k == DIRECT_K and prec == "bf16":
                    moved = least_bytes(K_sp.nnz, 2, K.n, k)
                    rows[name] = {"max_abs_err": float((W - Wp).abs().max()),
                                  "ms": ms, "plain_ms": plain_ms,
                                  **bound(moved, {"bf16": 2 * K_sp.nnz * k})}
            torch.cuda.empty_cache()
    csr = torch_csr(K_sp, K.data.device)
    U = torch.randn((K.n, DIRECT_K), generator=gen, device="cuda")
    library_ms = median_ms(lambda: torch.sparse.mm(csr, U))
    print(f"[kernel] strip-BSR K k={DIRECT_K}: torch.sparse.mm "
          f"{library_ms:.4f} ms", flush=True)
    for row in rows.values():
        row["library_ms"] = library_ms
    del csr
    # The SpMM + Gram probe of the bench's 300k phase (k = 128).
    U = torch.randn((K.n, 128), generator=gen, device="cuda")
    for prec in ("highest", "bf16"):
        A = K.with_precision(prec)
        ms = median_ms(lambda: bsr.bsr_spmm_gram(A, U))
        moved = bsr.bsr_spmm_hbm_bytes(A, 128)
        print(f"[kernel] bsr_spmm_gram k=128 {prec}: {ms:.4f} ms, "
              f"{moved / 1e9:.3f} GB moved by the kernel (occupied "
              f"sub-blocks, their U rows, tables, W), "
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

    vals = oracle.result()[:DIRECT_K]
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


def rolling_slice(rolling, L, m_diag, X, oracle, device):
    """The bench's 300k training phase on the card: the RCM-ordered
    rolling band of L, K1 against its plain version on it, train_joint
    (K1 with the fused Gram on a bf16 copy of the band; its backward pass
    applies the band again without the Gram; run once timed and once
    more under the profiler), then the guarded LOBPCG polish on the fp32
    band (K1 without the Gram). Returns K1's launches in the timed
    training and in the polish and the k = 20 'bf16' row of
    measurements."""
    from eigenpinns_torch.solvers import lobpcg, train_joint
    from eigenpinns_torch.sparse import Diagonal, RollingBanded

    torch.cuda.synchronize()
    t0 = time.time()
    K, perm = RollingBanded.from_scipy(L, max_bandwidth=8192, device=device)
    torch.cuda.synchronize()
    print(f"[host] rolling band K in {time.time() - t0:.2f} s", flush=True)
    describe_band("K_300k", K)
    M = Diagonal(torch.as_tensor(m_diag[perm], dtype=torch.float32,
                                 device=device))
    Lp = L[perm][:, perm]
    polish_k = DIRECT_K + POLISH_GUARD
    for k in (DIRECT_K, polish_k, 3 * polish_k):   # training, K X, K S
        r = check_kernel(rolling, "K_300k", K, Lp, k, seed=7 + k,
                         row_prec="bf16", plain_samples=(5, 2))
        if k == DIRECT_K:
            row = r

    def counts():
        return {"all": rolling.rolling_kernel_launches,
                "with_gram": rolling.rolling_gram_launches}

    # Training twice: timed on its own, then under the profiler (whose
    # cost on a slow host halves the rate); the second run must repeat
    # the first one's loss history.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    rolling.rolling_kernel_launches = rolling.rolling_gram_launches = 0
    t0 = time.time()
    res = train_joint(K, M, X[perm], device=device, **DIRECT_CFG)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    train_launches = counts()
    with traced() as prof:
        with torch.profiler.record_function("smoke.train_rolling"):
            again = train_joint(K, M, X[perm], device=device, **DIRECT_CFG)
            torch.cuda.synchronize()
    dev = float(np.abs(again.history["loss"] - res.history["loss"]).max()
                / np.abs(res.history["loss"]).max())
    check(dev <= 1e-6, "the profiled rolling-band training differs from "
          f"the timed one: {dev:.3e}")
    del again
    rates = sorted(n / t for n, t in res.chunk_times[1:])
    rolling.rolling_kernel_launches = rolling.rolling_gram_launches = 0
    t0 = time.time()
    guards = torch.as_tensor(np.random.default_rng(3).normal(
        size=(K.n, POLISH_GUARD)).astype(np.float32), device=device)
    X0 = torch.cat([torch.as_tensor(res.eigenvectors, device=device),
                    guards], dim=1)
    pol = lobpcg(K.with_precision("highest"), M, X0, max_iter=POLISH_ITERS,
                 tol=POLISH_TOL)
    torch.cuda.synchronize()
    polish_s = time.time() - t0
    polish_launches = counts()
    peak_mb = torch.cuda.max_memory_allocated(device) / 2**20

    vals = oracle.result()[:DIRECT_K]
    lam_raw = np.sort(res.eigenvalues)[:DIRECT_K]
    lam_pol = np.sort(pol.eigenvalues.cpu().numpy())[:DIRECT_K]
    raw = np.abs(lam_raw[1:] - vals[1:]) / np.abs(vals[1:])
    polished = np.abs(lam_pol[1:] - vals[1:]) / np.abs(vals[1:])
    loss = res.history["loss"]
    print(f"[rolling] train_joint on the rolling band {res.epochs_run} "
          f"epochs: train {train_s:.3f} s, per-chunk median "
          f"{rates[len(rates) // 2]:.2f} steps/s, chunk times "
          f"{[round(t, 4) for _, t in res.chunk_times]}; loss {loss[0]:.6g} "
          f"-> {loss[-1]:.6g}", flush=True)
    print(f"[rolling] kernel launches in training {train_launches}, in the "
          f"polish {polish_launches} ({int(pol.iterations)} iterations in "
          f"{polish_s:.3f} s); peak device memory of training and polish "
          f"{peak_mb:.1f} MiB", flush=True)
    print(f"[rolling] max rel err of modes 1..19 vs eigsh: raw "
          f"{raw.max():.3e}, polished {polished.max():.3e}", flush=True)
    device_report("rolling", prof, "smoke.train_rolling",
                  steps=res.epochs_run, pick="band_spmm_kernel")
    check(train_launches["with_gram"] > 0,
          "train_joint launched K1 with the Gram 0 times")
    check(train_launches["all"] > train_launches["with_gram"],
          "train_joint's backward pass launched K1 0 times")
    check(polish_launches["all"] > 0 and polish_launches["with_gram"] == 0,
          f"the polish's K1 launches: {polish_launches}")
    check(bool(np.isfinite(loss).all() and np.isfinite(lam_pol).all()),
          "non-finite rolling-band results")
    check(polished.max() <= MAX_REL_ERR,
          f"rolling polished max rel err {polished.max():.3e} > "
          f"{MAX_REL_ERR}")
    return train_launches["all"], polish_launches["all"], row


def check_adversarial(bsr, banded, rolling, device, seed):
    """One small operator per format whose nonzeros sit where a walk over
    the occupancy bits is easiest to get wrong, against the plain version
    and the dense product: n = 1000 (the last row tile is ragged: U rows
    and W rows 1000..1023 do not exist), a single nonzero in the last
    16 x 16 sub-block of a tile (bit 63 of its word, the sign bit), an
    entry in the last row and column, and a column tile (strip-BSR) or a
    window (band, rolling band) that reaches past n; the rolling band's
    first window also starts before row 0, and its matrix is
    nonsymmetric, so the stored transpose is walked too."""
    import scipy.sparse as sp

    from eigenpinns_torch.sparse import (
        BandedELL,
        BSRTile,
        RollingBanded,
        occupancy_mask,
    )
    from eigenpinns_torch.utils.fixtures import adversarial_rolling_matrix

    n = 1000
    gen = torch.Generator("cuda").manual_seed(seed)
    # Strip-BSR: tile (0, 0) holds only (127, 127); the last row tile's
    # column tile 7 covers U rows 896..1023.
    ij = np.array([[127, 127], [999, 999], [900, 5], [640, 998], [300, 300]])
    vals = np.array([1.5, -2.25, 0.75, 3.0, -1.0])
    A_sp = sp.csr_matrix((vals, (ij[:, 0], ij[:, 1])), shape=(n, n))
    A, _ = BSRTile.from_scipy(A_sp, device=device, reorder=False,
                              with_transpose=False)
    check(int(A.occupancy[0, 0]) == -2**63,
          "adversarial strip-BSR: tile (0, 0) is not the single last "
          "sub-block")
    dense = torch.as_tensor(A_sp.toarray(), dtype=torch.float32,
                            device=device)
    worst = 0.0
    for prec in ("highest", "bf16"):
        Ap = A.with_precision(prec)
        burst = dataclasses.replace(Ap, gcid=None, lcid=None, gid=None)
        for k in (DIRECT_K, SPEC_K + 10):
            U = torch.randn((n, k), generator=gen, device=device)
            Ur = U.bfloat16().float() if prec == "bf16" else U
            refs = (bsr.bsr_spmm_plain(Ap, U),
                    dense.to(Ap.data.dtype).float() @ Ur)
            for cb in (32, 64):
                for op, launch in ((Ap, bsr.bsr_spmm_grouped_cuda),
                                   (burst, bsr.bsr_spmm_burst_cuda)):
                    W = launch(op, U, col_block=cb)
                    torch.cuda.synchronize()
                    err = max(rel_err(W, ref) for ref in refs)
                    worst = max(worst, err)
                    check(err <= BSR_TOL[prec], f"adversarial strip-BSR "
                          f"{prec} k={k} col_block={cb}: rel err {err:.3e}")
    words = [hex(w & (2**64 - 1)) for w in A.occupancy.flatten().tolist()
             if w]
    print(f"[kernel] adversarial strip-BSR (n = {n}, {A_sp.nnz} nonzeros, "
          f"occupancy words {words}): K2 and K3 (both column blocks) vs "
          f"plain and dense, max rel err {worst:.3e}", flush=True)

    # Band: n_pad = 1024, B = 256; tile 0 holds only its last sub-block
    # (row 127, local column 255); the last tile's window [768, 1024)
    # reaches past n, with an entry on column 999 (the last U row, in a
    # sub-block whose U rows 992..1007 straddle n), one on column 1023
    # (no such U row: it multiplies zero) and one in pad row 1010 (no
    # such W row).
    B, n_pad = 256, 1024
    starts = torch.tensor([0, 64, 192, 320, 448, 576, 704, 768],
                          dtype=torch.int32, device=device)
    band = torch.zeros((n_pad, B), device=device)
    for i, j, v in ((127, 255, 1.5), (999, 231, -2.25), (998, 255, 4.0),
                    (1010, 3, 5.0), (500, 0, 0.75), (640, 130, -1.0)):
        band[i, j] = v
    dense = torch.zeros((n_pad, n_pad + B), device=device)
    rows = torch.arange(n_pad, device=device)
    cols = starts.long()[rows // 128, None] + torch.arange(B, device=device)
    dense[rows[:, None], cols] = band
    dense = dense[:n, :n]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        b = band.to(dtype)
        core = BandedELL(b, starts, n, n, 128, occupancy=occupancy_mask(b))
        check(core.occupancy[0].tolist() == [0, -2**63],
              "adversarial band: tile 0 is not the single last sub-block")
        for k in (DIRECT_K, SPEC_K + 10):
            U = torch.randn((n, k), generator=gen, device=device)
            Ur = U.bfloat16().float() if dtype == torch.bfloat16 else U
            Wp, Gp = banded.banded_spmm_gram_plain(core, U)
            Wd = dense @ Ur
            W5, G = banded.banded_spmm_cuda(core, U, with_gram=True)
            outs = [W5] + [banded.banded_spmm_cuda(core, U, col_block=cb)
                           for cb in (32, 64)]
            torch.cuda.synchronize()
            err = max(max(rel_err(W, Wp), rel_err(W, Wd)) for W in outs)
            err_g = max(rel_err(G, Gp), rel_err(G, U.T @ Wd))
            worst = max(worst, err, err_g)
            check(err <= BANDED_TOL["W"] and err_g <= BANDED_TOL["G"],
                  f"adversarial band {dtype} k={k}: rel err W {err:.3e} "
                  f"G {err_g:.3e}")
    print(f"[kernel] adversarial band (n = {n}, n_pad = {n_pad}, B = {B}): "
          f"K4 (both column blocks) and K5 vs plain and dense, max rel err "
          f"{worst:.3e}", flush=True)

    # Rolling band (utils/fixtures.py::adversarial_rolling_matrix): pre =
    # 256, B' = 768; tile 1 holds only the last sub-block of a piece; tile
    # 0's window starts at U row -256, the last tile's ends at row 1280.
    A_sp = adversarial_rolling_matrix()
    op, _ = RollingBanded.from_scipy(A_sp, device=device, reorder=False)
    check(sorted(op.occupancy[1].tolist()) == [-2**63] + [0] * 5
          and op.pre == 256 and op.transpose_rolling is not None,
          "adversarial rolling band: not the layout the check is for")
    worst = 0.0
    for prec in ("highest", "bf16"):
        Ap = op.with_precision(prec)
        for A, dense_sp in ((Ap, A_sp), (Ap.transpose_rolling, A_sp.T)):
            dense = torch.as_tensor(dense_sp.toarray(), dtype=torch.float32,
                                    device=device).to(A.band.dtype).float()
            for k in (DIRECT_K, SPEC_K + 10):
                U = torch.randn((n, k), generator=gen, device=device)
                Ur = U.bfloat16().float() if prec == "bf16" else U
                Wp, Gp = rolling.rolling_spmm_gram_plain(A, U)
                Wd = dense @ Ur
                for cb in (32, 64):
                    W = rolling.rolling_spmm_cuda(A, U, col_block=cb)
                    W5, G = rolling.rolling_spmm_cuda(A, U, with_gram=True,
                                                      col_block=cb)
                    torch.cuda.synchronize()
                    err = max(rel_err(W, Wp), rel_err(W, Wd),
                              rel_err(W5, Wp))
                    err_g = max(rel_err(G, Gp), rel_err(G, U.T @ Wd))
                    worst = max(worst, err, err_g)
                    check(err <= BANDED_TOL["W"] and err_g <= BANDED_TOL["G"],
                          f"adversarial rolling band {prec} k={k} col_block="
                          f"{cb}: rel err W {err:.3e} G {err_g:.3e}")
    print(f"[kernel] adversarial rolling band (n = {n}, band "
          f"{tuple(op.band.shape)}, pre = {op.pre}) and its transpose: K1 "
          f"with and without the Gram (both column blocks) vs plain and "
          f"dense, max rel err {worst:.3e}", flush=True)


def check_banded_kernels(banded, bsr, cores, K, seed):
    """K4 and K5 vs the plain version on the split cores at the widths
    their paths give them, with torch.sparse.mm of the same core as the
    library yardstick, and K2 on the strip-BSR K at the same k beside
    them; returns the rows of K4 (cluster core, k = 60: the Rayleigh-Ritz
    basis of the spectral solve) and K5 (Hilbert bf16 core, k = 20: the
    training loss). The bound counts the core's nonzeros (`least_bytes`);
    the kernels read the band's occupied 16 x 16 sub-blocks."""
    from eigenpinns_torch.sparse import occupied_blocks

    gen = torch.Generator("cuda").manual_seed(seed)
    rows = {}
    for name, core, k in cores:
        other = 96 - banded.default_col_block(k, core.band.dtype)
        U = torch.randn((core.n, k), generator=gen, device="cuda")
        gW = torch.randn((core.n, k), generator=gen, device="cuda")
        gG = torch.randn((k, k), generator=gen, device="cuda")
        W = banded.banded_spmm_cuda(core, U)
        W2, G = banded.banded_spmm_cuda(core, U, with_gram=True)
        W3, G3 = banded.banded_spmm_cuda(core, U, with_gram=True,
                                         col_block=other)
        Wp, Gp = banded.banded_spmm_gram_plain(core, U)
        # The gradient through the fused Gram (kernel autograd, A^T = A
        # by the core's symmetry) vs dU = A^T (gW + U gG) + W gG^T from
        # the plain version, which rounds the cotangent as the kernel does.
        Uk = U.clone().requires_grad_(True)
        Wk, Gk = banded.banded_spmm_gram(core, Uk)
        ((Wk * gW).sum() + (Gk * gG).sum()).backward()
        dU_ref = banded.banded_spmm_plain(core, gW + U @ gG) + Wp @ gG.T
        torch.cuda.synchronize()
        errs = {"W": max(rel_err(W, Wp), rel_err(W2, Wp)),
                "G": max(rel_err(G, Gp), rel_err(G3, Gp)),
                "dU": rel_err(Uk.grad, dU_ref)}
        del Uk, Wk, Gk, dU_ref
        # No atomics, one summation order: K4 again, K4 with the other
        # column block and K5 give the same W bit for bit, K5 again the
        # same G.
        check(torch.equal(banded.banded_spmm_cuda(core, U), W)
              and torch.equal(
                  banded.banded_spmm_cuda(core, U, col_block=other), W)
              and torch.equal(W2, W) and torch.equal(W3, W),
              f"{name} k={k}: W differs between launches, column blocks or "
              "K4 and K5")
        del W3, G3
        check(torch.equal(
            banded.banded_spmm_cuda(core, U, with_gram=True)[1], G),
            f"{name} k={k}: G differs between two launches")
        csr = band_csr(core)
        t = {"spmm": median_ms(lambda: banded.banded_spmm_cuda(core, U)),
             "spmm_other": median_ms(
                 lambda: banded.banded_spmm_cuda(core, U, col_block=other)),
             "spmm_plain": median_ms(
                 lambda: banded.banded_spmm_plain(core, U)),
             "spmm_library": median_ms(lambda: torch.sparse.mm(csr, U)),
             "gram": median_ms(
                 lambda: banded.banded_spmm_cuda(core, U, with_gram=True)),
             "gram_other": median_ms(
                 lambda: banded.banded_spmm_cuda(core, U, with_gram=True,
                                                 col_block=other)),
             "gram_plain": median_ms(
                 lambda: banded.banded_spmm_gram_plain(core, U)),
             "gram_library": median_ms(
                 lambda: U.T @ torch.sparse.mm(csr, U))}
        nnz = int(csr.values().numel())
        del csr
        kind = "bf16" if core.band.dtype == torch.bfloat16 else "fp32"
        vb = core.band.element_size()
        b4 = bound(least_bytes(nnz, vb, core.n, k), {kind: 2 * nnz * k})
        b5 = bound(least_bytes(nnz, vb, core.n, k, gram=True),
                   {kind: 2 * nnz * k, "fp32": 2 * core.n * k * k})
        moved_gb = banded.banded_spmm_hbm_bytes(core, k) / 1e9
        print(f"[kernel] {name} {tuple(core.band.shape)} {kind} k={k}: "
              f"occupied 16 x 16 sub-blocks {occupied_share(core.occupancy)};"
              " "
              + " ".join(f"rel_err_{key}={v:.3e}" for key, v in errs.items())
              + f"; K4 {t['spmm']:.4f} ms (col_block {96 - other}; "
              f"{t['spmm_other']:.4f} with {other}; plain "
              f"{t['spmm_plain']:.4f}, "
              f"torch.sparse.mm {t['spmm_library']:.4f}, bound "
              f"{b4['bound_ms']:.4f} {b4['bound_by']}); K5 {t['gram']:.4f}"
              f" ms ({t['gram_other']:.4f} with {other}; plain "
              f"{t['gram_plain']:.4f}, library "
              f"{t['gram_library']:.4f}, bound {b5['bound_ms']:.4f}); nnz "
              f"{nnz}, executed FLOP "
              f"{2 * 256 * occupied_blocks(core.occupancy) * k / 1e9:.2f} G;"
              f" K4 moves (occupied sub-blocks, their U rows, tables, W) "
              f"{moved_gb:.3f} GB, {moved_gb / t['spmm'] * 1e3:.1f} GB/s",
              flush=True)
        for key, v in errs.items():
            check(v <= BANDED_TOL[key],
                  f"{name} k={k} {kind} {key}: rel err {v:.3e}")
        if name == "cluster" and k == SPEC_K + 10:
            rows["banded_spmm"] = {
                "max_abs_err": float((W - Wp).abs().max()), "ms": t["spmm"],
                "plain_ms": t["spmm_plain"],
                "library_ms": t["spmm_library"], **b4}
        if name == "hilbert" and kind == "bf16":
            rows["banded_spmm_gram"] = {
                "max_abs_err": max(float((W2 - Wp).abs().max()),
                                   float((G - Gp).abs().max())),
                "ms": t["gram"], "plain_ms": t["gram_plain"],
                "library_ms": t["gram_library"], **b5}
        del U, gW, W, W2, G, Wp, Gp
        torch.cuda.empty_cache()
    # K2 on the strip-BSR K beside K4 at the same k, fp32.
    for k in (DIRECT_K, SPEC_K + 10):
        U = torch.randn((K.n, k), generator=gen, device="cuda")
        ms = median_ms(lambda: bsr.bsr_spmm_grouped_cuda(K, U))
        print(f"[kernel] bsr_spmm_grouped on the strip-BSR K, fp32, k={k}: "
              f"{ms:.4f} ms", flush=True)
    return rows


def spectral_slice(banded, X, L, m_diag, oracle, device):
    """`spectral_basis` on the cluster SplitBanded at the configuration's
    full width; returns K4's launches."""
    from eigenpinns_torch.solvers import spectral_basis

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for key in banded.banded_kernel_launches:
        banded.banded_kernel_launches[key] = 0
    with traced() as prof:
        t0 = time.time()
        res = spectral_basis(X, operators=(L, m_diag), device=device,
                             **SPEC_CFG)
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = dict(banded.banded_kernel_launches)
    peak_mb = torch.cuda.max_memory_allocated(device) / 2**20

    vals = oracle.result()
    lam = res.eigenvalues
    rel = np.abs(lam[1:] - vals[1:]) / np.abs(vals[1:])
    V = res.eigenvectors.astype(np.float64)
    MV = m_diag[:, None] * V
    orth = float(np.abs(V.T @ MV - np.eye(SPEC_K)).max())
    rq = np.sum(V * (L @ V), axis=0) / np.sum(V * MV, axis=0)
    rq_dev = float(np.abs(rq - lam).max())
    print(f"[spectral] spectral_basis k={SPEC_K} in {wall:.3f} s, timings "
          f"{ {key: round(v, 3) for key, v in res.timings.items()} }; peak "
          f"device memory {peak_mb:.1f} MiB; kernel launches {launches}",
          flush=True)
    print(f"[spectral] eigenvalues {np.array2string(lam, precision=6)}\n"
          f"[spectral] eigsh       {np.array2string(vals, precision=6)}\n"
          f"[spectral] max rel err of modes 1..{SPEC_K - 1} vs eigsh "
          f"{rel.max():.3e} (mean {rel.mean():.3e}; the JAX package's 1M "
          f"figure: 3.1e-4), max scaled residual "
          f"{float(res.residual_norms.max()):.3e}, |V^T M V - I| {orth:.3e},"
          f" max |rayleigh quotient - eigenvalue| {rq_dev:.3e}", flush=True)
    device_report("spectral", prof, "spectral_basis.solve")
    check(launches["spmm"] > 0, "spectral_basis launched K4 0 times")
    check(lam.shape == (SPEC_K,) and V.shape == (X.shape[0], SPEC_K),
          "unexpected spectral_basis result shapes")
    check(bool(np.isfinite(lam).all() and np.isfinite(V).all()),
          "non-finite spectral_basis results")
    check(rel.max() <= MAX_REL_ERR,
          f"spectral_basis max rel err {rel.max():.3e} > {MAX_REL_ERR}")
    check(orth <= 1e-3, f"spectral_basis basis not M-orthonormal: {orth:.3e}")
    check(bool(np.allclose(rq, lam, rtol=1e-3, atol=1e-4)),
          "spectral_basis eigenvectors are not in the original point order")
    return launches["spmm"]


def gram_slice(banded, K_h, K_f, M, X, oracle):
    """train_joint on the Hilbert SplitBanded K (bf16 core: K5 in the
    loss, K4 in its backward pass), then the guarded polish on the fp32
    twin (K4); returns K5's launches in training."""
    from eigenpinns_torch.solvers import lobpcg, train_joint

    device = K_h.core.band.device
    for key in banded.banded_kernel_launches:
        banded.banded_kernel_launches[key] = 0
    with traced() as prof:
        t0 = time.time()
        with torch.profiler.record_function("smoke.train_joint"):
            res = train_joint(K_h, M, X, device=device, **DIRECT_CFG)
            torch.cuda.synchronize()
        train_s = time.time() - t0
    train_launches = dict(banded.banded_kernel_launches)
    rates = sorted(n / t for n, t in res.chunk_times[1:])
    for key in banded.banded_kernel_launches:
        banded.banded_kernel_launches[key] = 0
    t0 = time.time()
    guards = torch.as_tensor(np.random.default_rng(3).normal(
        size=(K_f.n, POLISH_GUARD)).astype(np.float32), device=device)
    X0 = torch.cat([torch.as_tensor(res.eigenvectors, device=device),
                    guards], dim=1)
    pol = lobpcg(K_f, M, X0, max_iter=POLISH_ITERS, tol=POLISH_TOL)
    torch.cuda.synchronize()
    polish_s = time.time() - t0
    polish_launches = dict(banded.banded_kernel_launches)

    vals = oracle.result()[:DIRECT_K]
    lam_raw = np.sort(res.eigenvalues)[:DIRECT_K]
    lam_pol = np.sort(pol.eigenvalues.cpu().numpy())[:DIRECT_K]
    raw = np.abs(lam_raw[1:] - vals[1:]) / np.abs(vals[1:])
    polished = np.abs(lam_pol[1:] - vals[1:]) / np.abs(vals[1:])
    loss = res.history["loss"]
    print(f"[gram] train_joint on the Hilbert split K {res.epochs_run} "
          f"epochs: train {train_s:.3f} s, per-chunk median "
          f"{rates[len(rates) // 2]:.2f} steps/s; loss {loss[0]:.6g} -> "
          f"{loss[-1]:.6g}; kernel launches in training {train_launches}, "
          f"in the polish {polish_launches} ({int(pol.iterations)} "
          f"iterations in {polish_s:.3f} s)", flush=True)
    print(f"[gram] max rel err of modes 1..19 vs eigsh: raw {raw.max():.3e},"
          f" polished {polished.max():.3e}", flush=True)
    device_report("gram", prof, "smoke.train_joint", steps=res.epochs_run)
    check(train_launches["spmm_gram"] > 0, "train_joint launched K5 0 times")
    check(train_launches["spmm"] > 0,
          "train_joint's backward pass launched K4 0 times")
    check(polish_launches["spmm"] > 0, "the polish launched K4 0 times")
    check(bool(np.isfinite(loss).all() and np.isfinite(lam_pol).all()),
          "non-finite fused-Gram results")
    check(polished.max() <= MAX_REL_ERR,
          f"split polished max rel err {polished.max():.3e} > {MAX_REL_ERR}")
    return train_launches["spmm_gram"]


def check_family_kernel(bsr, ops, seed):
    """K3 vs the plain version on each member's operator of a family
    (padded to the family's shape: zero pad rows and pad chunks, no group
    tables) at the widths its solve gives it: W to rel 1e-5 and the
    gradient through `bsr_spmm` (A^T = A) to rel 1e-4, both against the
    plain version in fp32."""
    gen = torch.Generator("cuda").manual_seed(seed)
    worst = {"W": 0.0, "dU": 0.0}
    for i, (op, _) in enumerate(ops):
        for k in FAMILY_WIDTHS:
            U = torch.randn((op.n, k), generator=gen, device="cuda")
            G = torch.randn((op.n, k), generator=gen, device="cuda")
            W = bsr.bsr_spmm_burst_cuda(op, U)
            Wp = bsr.bsr_spmm_plain(op, U)
            Uk = U.clone().requires_grad_(True)
            (bsr.bsr_spmm(op, Uk) * G).sum().backward()
            Up = U.clone().requires_grad_(True)
            (bsr.bsr_spmm_plain(op, Up) * G).sum().backward()
            torch.cuda.synchronize()
            errs = {"W": rel_err(W, Wp), "dU": rel_err(Uk.grad, Up.grad)}
            check(errs["W"] <= BSR_TOL["highest"],
                  f"family member {i} K3 k={k} W: rel err {errs['W']:.3e}")
            check(errs["dU"] <= GRAD_TOL,
                  f"family member {i} K3 k={k} dU: rel err {errs['dU']:.3e}")
            worst = {key: max(worst[key], v) for key, v in errs.items()}
    print(f"[kernel] bsr_spmm on the family's padded operators "
          f"{[(op.n, op.n_chunks, op.n_slots) for op, _ in ops]} (rows, "
          f"chunks, real tiles) at k = {FAMILY_WIDTHS}: max rel_err_W="
          f"{worst['W']:.3e} rel_err_dU={worst['dU']:.3e}", flush=True)


def family_slice(bsr, device):
    """K3 vs plain on the family's padded operators, then
    spectral_basis_family on three 20k-point clouds (K3); returns K3's
    launches."""
    from eigenpinns_torch.geometry import point_cloud_laplacian
    from eigenpinns_torch.solvers import (
        eigsh_smallest,
        family_operators,
        spectral_basis_family,
    )
    from eigenpinns_torch.utils.fixtures import make_cloud

    X_list = [make_cloud(FAMILY_N, seed=s) for s in (1, 2, 3)]
    problems = [point_cloud_laplacian(X, n_neighbors=15) for X in X_list]
    ops = family_operators([L for L, _ in problems], device=device)
    check_family_kernel(bsr, ops, seed=5)
    del ops
    torch.cuda.empty_cache()
    for key in bsr.bsr_kernel_launches:
        bsr.bsr_kernel_launches[key] = 0
    t0 = time.time()
    results = spectral_basis_family(X_list, k=FAMILY_K, coarse_n=FAMILY_COARSE,
                                    log_fn=None, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(bsr.bsr_kernel_launches)
    errs = []
    for (L, M), res in zip(problems, results):
        vals, _ = eigsh_smallest(L, M, FAMILY_K)
        errs.append(float((np.abs(res.eigenvalues[1:] - vals[1:])
                           / np.abs(vals[1:])).max()))
        check(bool(np.isfinite(res.eigenvectors).all()),
              "non-finite family results")
    print(f"[family] spectral_basis_family 3 x {FAMILY_N} points, "
          f"k={FAMILY_K} in {wall:.3f} s (solves "
          f"{[round(r.timings['solve_s'], 3) for r in results]} s); kernel "
          f"launches {launches}; max rel err of modes 1+ vs each member's "
          f"eigsh {[f'{e:.3e}' for e in errs]}", flush=True)
    check(launches["burst"] > 0, "spectral_basis_family launched K3 0 times")
    check(max(errs) <= MAX_REL_ERR,
          f"family max rel err {max(errs):.3e} > {MAX_REL_ERR}")
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
    from eigenpinns_torch.sparse import (
        BSRTile,
        Diagonal,
        RollingBanded,
        SplitBanded,
    )
    from eigenpinns_torch.sparse import banded, bsr, rolling
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
    phases = Phases()

    # 1. Build the two kernel sources from the checkout, one nvcc each,
    # in parallel (K1 is the rolling instantiation of banded_spmm.cu).
    sources = {"bsr_spmm": bsr, "banded_spmm": banded}
    with ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(m.build_kernel) for m in sources.values()]:
            f.result()
    for name in sources:
        print(build_logs.get(name, "").strip(), flush=True)
    phases.done("build of " + ", ".join(f"{n}.cu" for n in sources))

    # 2. K1 vs plain at the multigrid path's shapes. The operators
    # come from a host-side (CPU) build of the same hierarchy, which
    # launches no kernel.
    mesh = perturbed_icosphere(4)
    h_cpu = build_hierarchy(mesh, LEVELS, n_modes=N_MODES,
                            operator_format="auto", device="cpu")
    K_blk_sp = sp.block_diag([K.tocsr() for K in h_cpu.K_scipy],
                             format="csr")
    K_blk = RollingBanded.from_scipy(K_blk_sp, device=device,
                                     reorder=False)[0]
    K_fine = RollingBanded.from_scipy(h_cpu.K_scipy[-1], device=device,
                                      reorder=False)[0]
    describe_band("K_blk", K_blk)
    describe_band("K_finest", K_fine)
    row = check_kernel(rolling, "K_blk", K_blk, K_blk_sp, N_MODES, seed=0)
    check_kernel(rolling, "K_finest", K_fine, h_cpu.K_scipy[-1],
                 3 * (N_MODES + 3), seed=1)
    del K_blk, K_fine
    phases.done("K1 checks")

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
    phases.done("multigrid path")

    # 4. The 300k host stage; the eigsh oracle runs in a worker process
    # while the card works.
    t0 = time.time()
    X = make_cloud(DIRECT_N)
    L, M_sp = point_cloud_laplacian(X, n_neighbors=15)
    m_diag = np.asarray(M_sp.diagonal())
    print(f"[host] {DIRECT_N} points: Laplacian in {time.time() - t0:.2f} s,"
          f" nnz {L.nnz}", flush=True)
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        t_oracle = time.time()
        oracle = pool.submit(eigsh_values, L, M_sp, SPEC_K)
        oracle.add_done_callback(lambda f: print(
            f"[host] eigsh oracle ({SPEC_K} modes) in "
            f"{time.time() - t_oracle:.2f} s", flush=True))
        t0 = time.time()
        K, perm = BSRTile.from_scipy(L, device=device)
        M = Diagonal(torch.as_tensor(m_diag[perm], dtype=torch.float32,
                                     device=device))
        torch.cuda.synchronize()
        print(f"[host] strip-BSR K in {time.time() - t0:.2f} s: "
              f"{tuple(K.data.shape)} ({K.data.nbytes / 1e9:.2f} GB), "
              f"{K.n_chunks} chunks, {K.n_slots} real tiles, max "
              f"{K.strip_w} per row tile, groups {tuple(K.gcid.shape)}",
              flush=True)
        phases.done("300k host stage")

        # 5. K2 and K3 vs plain at the slice's shapes.
        bsr_rows = check_bsr_kernels(bsr, K, L[perm][:, perm], seed=2)
        check_adversarial(bsr, banded, rolling, device, seed=6)
        torch.cuda.empty_cache()
        phases.done("K2/K3 checks")

        # 6. The split operators, and K4/K5 vs plain on their cores.
        t0 = time.time()
        K_c, _ = SplitBanded.from_scipy(L, X=X, window=SPEC_CFG["window"],
                                        device=device)
        torch.cuda.synchronize()
        print(f"[host] cluster SplitBanded (window {SPEC_CFG['window']}, "
              f"fp32) in {time.time() - t0:.2f} s: core "
              f"{tuple(K_c.core.band.shape)} "
              f"({K_c.core.band.nbytes / 1e9:.3f} GB), remainder nnz "
              f"fraction {K_c.remainder_nnz_fraction:.4f}", flush=True)
        t0 = time.time()
        K_h, perm_h = SplitBanded.from_scipy(
            L, X=X, window=HILBERT_WINDOW, order="hilbert",
            dtype=torch.bfloat16, device=device)
        torch.cuda.synchronize()
        t_h = time.time() - t0
        t0 = time.time()
        K_hf, _ = SplitBanded.from_scipy(L, window=HILBERT_WINDOW,
                                         order=perm_h, device=device)
        torch.cuda.synchronize()
        print(f"[host] Hilbert SplitBanded (window {HILBERT_WINDOW}): bf16 "
              f"in {t_h:.2f} s, its fp32 twin from the same perm in "
              f"{time.time() - t0:.2f} s: core {tuple(K_h.core.band.shape)},"
              f" remainder nnz fraction {K_h.remainder_nnz_fraction:.4f}",
              flush=True)
        banded_rows = check_banded_kernels(
            banded, bsr,
            [("cluster", K_c.core, DIRECT_K), ("cluster", K_c.core, SPEC_K + 10),
             ("hilbert", K_hf.core, DIRECT_K),
             ("hilbert", K_hf.core, DIRECT_K + POLISH_GUARD),
             ("hilbert", K_h.core, DIRECT_K)],
            K, seed=4)
        del K_c
        torch.cuda.empty_cache()
        phases.done("split builds and K4/K5 checks")

        # 7. The direct slice, counting launches from zero.
        Xp = X[perm]
        k2_launches, ref_loss = direct_slice(bsr, K, M, Xp, oracle)
        phases.done("direct slice")
    k3_launches = burst_slice(bsr, K, M, Xp, ref_loss)
    del K, M
    torch.cuda.empty_cache()
    phases.done("burst slice")

    # 7b. The rolling-band slice: K1 with the fused Gram at 300k.
    k1_train, k1_polish, row_300k = rolling_slice(rolling, L, m_diag, X,
                                                  oracle, device)
    torch.cuda.empty_cache()
    phases.done("rolling-band slice")

    # 8. The spectral-basis slice, counting K4's launches from zero.
    k4_launches = spectral_slice(banded, X, L, m_diag, oracle, device)
    phases.done("spectral-basis slice")

    # 9. The fused-Gram path on the Hilbert split K.
    M_h = Diagonal(torch.as_tensor(m_diag[perm_h], dtype=torch.float32,
                                   device=device))
    k5_launches = gram_slice(banded, K_h, K_hf, M_h, X[perm_h], oracle)
    del K_h, K_hf, M_h
    torch.cuda.empty_cache()
    phases.done("fused-Gram slice")

    # 10. The family driver (K3).
    k3_family = family_slice(bsr, device)
    phases.done("family slice")

    print(json.dumps({"kernels": [
        {"name": "rolling_spmm", "route": "cuda",
         "source": "eigenpinns_torch/csrc/banded_spmm.cu",
         "replaces": "eigenpinns_tpu/sparse/rolling.py:344",
         "launches": launches, **row,
         "launches_300k": k1_train + k1_polish,
         "launches_300k_training": k1_train,
         "launches_300k_polish": k1_polish, "row_300k": row_300k},
        {"name": "bsr_spmm_grouped", "route": "cuda",
         "source": "eigenpinns_torch/csrc/bsr_spmm.cu",
         "replaces": "eigenpinns_tpu/sparse/bsr.py:549",
         "launches": k2_launches, **bsr_rows["bsr_spmm_grouped"]},
        {"name": "bsr_spmm", "route": "cuda",
         "source": "eigenpinns_torch/csrc/bsr_spmm.cu",
         "replaces": "eigenpinns_tpu/sparse/bsr.py:672",
         "launches": k3_launches, "launches_family": k3_family,
         **bsr_rows["bsr_spmm"]},
        {"name": "banded_spmm", "route": "cuda",
         "source": "eigenpinns_torch/csrc/banded_spmm.cu",
         "replaces": "eigenpinns_tpu/sparse/banded.py:455",
         "launches": k4_launches, **banded_rows["banded_spmm"]},
        {"name": "banded_spmm_gram", "route": "cuda",
         "source": "eigenpinns_torch/csrc/banded_spmm.cu",
         "replaces": "eigenpinns_tpu/sparse/banded.py:382",
         "launches": k5_launches, **banded_rows["banded_spmm_gram"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
