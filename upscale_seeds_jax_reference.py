#!/usr/bin/env python3
"""Seed spread of the hierarchical upscaler on the JAX test's quick
harness, both packages, each with its own initialization, on the CPU.

    python3 upscale_seeds_jax_reference.py   (~6 min on 8 cores)

The harness is `tests/test_upscale_transfer.py::
test_hierarchical_eigensolve_quick`: the 1D Laplacian at n = 128,
levels [48], 3 pairs, hidden (64, 64), 1200 epochs a level, lr 3e-3,
bar 0.15 on the max relative eigenvalue error. For seeds 0..9 it prints
one line each with both packages' errors, then how many seeds each
package clears the bar on (`tests/test_torch_transfer.py` holds the
port's count to at least the JAX package's, ROADMAP F27).
"""

import sys

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

from eigenpinns_tpu.solvers import hierarchical_eigensolve as j_solve  # noqa: E402,E501
from eigenpinns_torch.solvers import hierarchical_eigensolve as t_solve  # noqa: E402,E501
from eigenpinns_torch.utils.fixtures import (  # noqa: E402
    generate_test_matrices,
    laplacian_1d_eigenvalues,
)

N, K_PAIRS, BAR = 128, 3, 0.15
KW = dict(levels=[48], hidden=(64, 64), epochs_per_level=1200, lr=3e-3)


def max_rel(vals, exact):
    return float((np.abs(np.sort(vals) - exact) / exact).max())


def main(seeds):
    torch.set_num_threads(4)
    K, M = generate_test_matrices(N, "laplacian")
    exact = laplacian_1d_eigenvalues(N, K_PAIRS)
    errs = {"jax": [], "torch": []}
    for s in seeds:
        ej = max_rel(j_solve(K, M, K_PAIRS, seed=s, **KW).eigenvalues,
                     exact)
        et = max_rel(t_solve(K, M, K_PAIRS, seed=s, device="cpu",
                             **KW).eigenvalues, exact)
        errs["jax"].append(ej)
        errs["torch"].append(et)
        print(f"seed {s}: jax {ej!r} torch {et!r}", flush=True)
    for name, e in errs.items():
        e = np.asarray(e)
        print(f"{name}: {int((e < BAR).sum())} of {len(e)} below {BAR}; "
              f"median {np.median(e)!r}, min {e.min()!r}, max {e.max()!r}",
              flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or list(range(10)))
