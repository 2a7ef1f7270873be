#!/usr/bin/env python3
"""The JAX package's own figures at the solver-family configurations of
`chip_smoke.py`, on the CPU, and the port beside it where the two differ.

    python3 solver_family_jax_reference.py   (~4 min on 8 cores)

Prints, one line each:

  * `hierarchical_eigensolve` on the notebook's medium harness (the 1D
    Laplacian at n = 4096, levels [512, 2048], 4 pairs, hidden (64, 64),
    1500 epochs a level, lr 3e-3), seeds 0..4: eigenvalues, max relative
    and absolute error against the exact spectrum (`UPSCALE_JAX_ERR` is
    seed 0's);
  * the same on the JAX test's quick harness (n = 128, levels [48],
    3 pairs, 1200 epochs), seed 0 (`UPSCALE_QUICK_JAX_ERR`);
  * `train_per_level` at `TRANSFER_CFG` (perturbed_icosphere(4), levels
    [128, 512, 1024] + full, k = 10, hidden (64, 64, 64), 1500 epochs a
    level, freeze schedule {2: 1, 3: 2}) on the JAX package's own build
    of the hierarchy: the finest level's max rel err of modes 1..9
    against eigsh (`TRANSFER_JAX_ERR`), then the port's on the same
    hierarchy from the same flax parameters;
  * 50 epochs a level of the same, port against JAX: the loss
    histories' max rel difference by level as the drivers run, and with
    both packages' anchoring Ritz vectors fixed by `align_ritz_vectors`
    (ROADMAP F18).

This is the only root script that runs the JAX package; the port and
`chip_smoke.py` never import it.
"""

import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

import eigenpinns_tpu.solvers.transfer as j_transfer  # noqa: E402
import eigenpinns_torch.solvers.transfer as t_transfer  # noqa: E402
from eigenpinns_tpu.geometry.mesh import TriMesh as JTriMesh  # noqa: E402
from eigenpinns_tpu.models import SimpleCorrector as JSimpleCorrector  # noqa: E402,E501
from eigenpinns_tpu.sampling import build_hierarchy  # noqa: E402
from eigenpinns_tpu.solvers import (  # noqa: E402
    hierarchical_eigensolve,
    train_per_level,
)
from eigenpinns_tpu.sparse import neighbor_mean_operator  # noqa: E402
from eigenpinns_tpu.utils.fixtures import (  # noqa: E402
    generate_test_matrices,
    laplacian_1d_eigenvalues,
)
from eigenpinns_torch.models import SimpleCorrector, from_flax_params  # noqa: E402,E501
from eigenpinns_torch.sampling import Hierarchy  # noqa: E402
from eigenpinns_torch.solvers import eigsh_smallest  # noqa: E402
from eigenpinns_torch.solvers import train_per_level as t_train_per_level  # noqa: E402,E501
from eigenpinns_torch.utils.fixtures import (  # noqa: E402
    align_ritz_vectors,
    perturbed_icosphere,
)

UPSCALE = dict(n=4096, n_pairs=4, levels=[512, 2048], hidden=(64, 64),
               epochs_per_level=1500, lr=3e-3)
UPSCALE_QUICK = dict(n=128, n_pairs=3, levels=[48], hidden=(64, 64),
                     epochs_per_level=1200, lr=3e-3)
TRANSFER_LEVELS, TRANSFER_K = [128, 512, 1024], 10
TRANSFER = dict(hidden=(64, 64, 64), freeze_schedule={2: 1, 3: 2}, seed=0)


def upscaler(cfg: dict, seeds) -> None:
    cfg = dict(cfg)
    n, k = cfg.pop("n"), cfg.pop("n_pairs")
    K, M = generate_test_matrices(n, "laplacian")
    exact = laplacian_1d_eigenvalues(n, k)
    for seed in seeds:
        t0 = time.time()
        res = hierarchical_eigensolve(K, M, k, seed=seed, **cfg)
        lam = np.sort(res.eigenvalues)
        print(f"[upscaler n={n}] seed {seed}: {time.time() - t0:.1f} s, "
              f"eigenvalues {lam}, max rel err "
              f"{float(np.max(np.abs(lam - exact) / exact))!r}, max abs err "
              f"{float(np.max(np.abs(lam - exact)))!r}", flush=True)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def transfer() -> None:
    mesh = perturbed_icosphere(4)
    jh = build_hierarchy(JTriMesh(mesh.verts, mesh.faces), TRANSFER_LEVELS,
                         n_modes=TRANSFER_K, operator_format="auto")
    with tempfile.TemporaryDirectory() as d:
        jh.save(d)
        h = Hierarchy.load(d, operator_format="auto", device="cpu")
    vals = eigsh_smallest(h.K_scipy[-1], h.M_scipy[-1], TRANSFER_K)[0]
    n1 = jh.actual_hierarchy[1]
    tree = JSimpleCorrector(TRANSFER["hidden"], TRANSFER_K).init(
        jax.random.PRNGKey(0), jnp.zeros((n1, 9 + TRANSFER_K)),
        neighbor_mean_operator(jh.edge_index_list[1], n1))
    init = from_flax_params(
        SimpleCorrector(9 + TRANSFER_K, TRANSFER["hidden"], TRANSFER_K),
        jax.tree_util.tree_map(np.asarray, tree)).state_dict()

    def finest_err(lam) -> float:
        lam = np.sort(lam)
        return float((np.abs(lam[1:] - vals[1:]) / vals[1:]).max())

    t0 = time.time()
    jr = train_per_level(jh, TRANSFER_K, epochs_per_level=1500,
                         scan_chunk=250, **TRANSFER)
    print(f"[transfer] JAX: {time.time() - t0:.1f} s, finest eigenvalues "
          f"{np.sort(jr.eigenvalues)}, eigsh {vals}, max rel err of modes "
          f"1..9 {finest_err(jr.eigenvalues)!r}", flush=True)
    tr = t_train_per_level(h, TRANSFER_K, epochs_per_level=1500,
                           scan_chunk=250, init_params=init, **TRANSFER)
    print(f"[transfer] the port from the same parameters: max rel err of "
          f"modes 1..9 {finest_err(tr.eigenvalues)!r}", flush=True)

    j_rr, t_rr = j_transfer.rayleigh_ritz, t_transfer.rayleigh_ritz

    def j_fixed(U, K, M, jitter=0.0):
        w, V = j_rr(U, K, M, jitter)
        return w, jnp.asarray(align_ritz_vectors(np.asarray(w),
                                                 np.asarray(V)))

    def t_fixed(U, K, M, jitter=0.0):
        w, V = t_rr(U, K, M, jitter)
        return w, torch.as_tensor(align_ritz_vectors(w.numpy(), V.numpy()))

    for name, jf, tf in (("as run", j_rr, t_rr),
                         ("Ritz vectors fixed", j_fixed, t_fixed)):
        j_transfer.rayleigh_ritz, t_transfer.rayleigh_ritz = jf, tf
        try:
            jr = train_per_level(jh, TRANSFER_K, epochs_per_level=50,
                                 scan_chunk=50, **TRANSFER)
            tr = t_train_per_level(h, TRANSFER_K, epochs_per_level=50,
                                   scan_chunk=50, init_params=init,
                                   **TRANSFER)
        finally:
            j_transfer.rayleigh_ritz, t_transfer.rayleigh_ritz = j_rr, t_rr
        print(f"[transfer] 50 epochs a level, port vs JAX, {name}: loss "
              f"max rel diff by level "
              f"{[f'{rel(a['loss'], b['loss']):.3e}' for a, b in zip(tr.histories, jr.histories)]}",  # noqa: E501
              flush=True)


def main() -> None:
    torch.set_num_threads(4)
    upscaler(UPSCALE, range(5))
    upscaler(UPSCALE_QUICK, [0])
    transfer()


if __name__ == "__main__":
    main()
