#!/usr/bin/env python3
"""Where the time goes on the solver family's paths, on one NVIDIA GPU.

    python3 solver_family_profile.py

Runs a short steady window of each path of `chip_smoke.py`'s solver-family
phases, at their widths, under torch.profiler (CPU and CUDA activities)
and prints, per path, the card's kernel and copy time over the window,
its idle share and the kernels with the most device time
(`chip_smoke.device_report`):

  * `solve_deflation` (one mode, 300 steps) and `solve_deflation_adaptive`
    (150 epochs of 2 batch steps, no store) on the bunny stand-in;
  * `train_joint_family` (100 epochs, no finish) on the three stand-in
    clouds;
  * `hierarchical_eigensolve` (one pair, 200 epochs a level) at n = 4096;
  * `train_per_level` (100 epochs a level) on the multigrid hierarchy;
  * `solve_laplace_dirichlet_device` (500 CG iterations) on the 300k
    strip-BSR K.

Each window's wall time includes the profiler's own cost; the rates of
record are `chip_smoke.py`'s, taken without it. The script exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

import chip_smoke as cs


def window(name: str, steps: int, fn) -> None:
    """fn() under the profiler inside the span `profile.<name>`."""
    torch.cuda.synchronize()
    with cs.traced() as prof:
        with torch.profiler.record_function(f"profile.{name}"):
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
    print(f"[{name}] {steps} steps in {wall:.3f} s with the profiler on",
          flush=True)
    cs.device_report(name, prof, f"profile.{name}", steps=steps)


def main() -> int:
    if not torch.cuda.is_available():
        print("solver_family_profile: no CUDA device", file=sys.stderr)
        return 1
    from eigenpinns_torch.geometry import native, point_cloud_laplacian
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.solvers import (
        hierarchical_eigensolve,
        solve_deflation,
        solve_deflation_adaptive,
        solve_laplace_dirichlet_device,
        train_joint_family,
        train_per_level,
    )
    from eigenpinns_torch.sparse import BSRTile, bsr
    from eigenpinns_torch.utils.fixtures import (
        generate_test_matrices,
        make_cloud,
        perturbed_icosphere,
    )

    device = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} device "
          f"{torch.cuda.get_device_name(0)} ({smi})", flush=True)
    bsr.build_kernel()
    native.require()
    mesh = perturbed_icosphere(4)

    X, K, M, _, _ = cs.deflation_inputs(mesh, device)
    seq = dict(cs.DEFL_SEQ, epochs_per_mode=300, early_stop_patience=None,
               polish_iters=0)
    window("deflation", 300, lambda: solve_deflation(K, M, X, 1, **seq))
    ada = dict(cs.DEFL_ADAPTIVE, epochs=150, polish_iters=0)
    window("adaptive", 150, lambda: solve_deflation_adaptive(
        K, M, X, cs.DEFL_K, **ada))

    X_list, K_list, M_list = cs.family_inputs()
    fam = dict(cs.FAMILY_JOINT, epochs=100, polish_iters=0)
    window("joint family", 100, lambda: train_joint_family(
        K_list, M_list, X_list, device=device, rayleigh_ritz_finish=False,
        **fam))

    Ku, Mu = generate_test_matrices(cs.UPSCALE_N, "laplacian")
    ups = dict(cs.UPSCALE_CFG, n_pairs=1, epochs_per_level=200)
    window("upscaler", 2 * 200, lambda: hierarchical_eigensolve(
        Ku, Mu, device=device, **ups))

    h = build_hierarchy(mesh, cs.LEVELS, n_modes=cs.N_MODES,
                        operator_format="auto", device=device)
    tr = dict(cs.TRANSFER_CFG, epochs_per_level=100, scan_chunk=100)
    window("transfer", 3 * 100, lambda: train_per_level(h, cs.N_MODES,
                                                        **tr))

    Xd = make_cloud(cs.DIRECT_N)
    L, _ = point_cloud_laplacian(Xd, n_neighbors=15, use_native=True)
    Kd, perm = BSRTile.from_scipy(L, device=device)
    mask, vals = cs.dirichlet_problem(Xd)
    mask_t = torch.as_tensor(mask[perm], device=device)
    vals_t = torch.as_tensor(vals[perm], dtype=torch.float32, device=device)
    window("dirichlet", 500, lambda: solve_laplace_dirichlet_device(
        Kd, mask_t, vals_t, cg_iters=500))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
