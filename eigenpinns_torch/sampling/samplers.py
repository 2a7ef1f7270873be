"""Farthest-point samplers for nested multigrid hierarchies.

Capability parity with `src/samplers.py:97-143`: nested FPS index sets
per hierarchy level, each sorted, with the full cloud appended as the
finest level. Host-side numpy, run once per mesh in preprocessing. A copy
of the numpy path of `eigenpinns_tpu/sampling/samplers.py`.
"""

from __future__ import annotations

import numpy as np


def farthest_point_indices(points: np.ndarray, n_samples: int,
                           seed: int | None = 0) -> np.ndarray:
    """One FPS run returning `n_samples` indices (in selection order).

    Matches `_farthest_point_sampling`'s inner loop (src/samplers.py:110-127):
    random start, iterative min-distance update, argmax selection. A fixed
    default seed replaces the reference's unseeded RNG for reproducibility
    (pass None for nondeterministic parity).
    """
    n = points.shape[0]
    if n_samples >= n:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, n))
    selected = np.empty(n_samples, dtype=np.int64)
    selected[0] = start
    dist = np.full(n, np.inf)
    for i in range(1, n_samples):
        d = np.linalg.norm(points - points[selected[i - 1]], axis=1)
        np.minimum(dist, d, out=dist)
        selected[i] = np.argmax(dist)
    return selected


def farthest_point_levels(points: np.ndarray, hierarchy: list[int],
                          seed: int | None = 0) -> list[np.ndarray]:
    """Nested FPS levels: prefixes of one FPS run, each sorted, plus the
    full cloud as the final level (src/samplers.py:97-143)."""
    order = farthest_point_indices(points, hierarchy[-1], seed=seed)
    levels = [np.sort(order[:n].copy()) for n in hierarchy]
    levels.append(np.arange(points.shape[0]))
    return levels
