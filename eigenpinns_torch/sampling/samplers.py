"""Farthest-point, voxel, random and leverage-score samplers for nested
hierarchies.

Capability parity with `src/samplers.py:9-143`: nested index sets per
hierarchy level, each sorted, with the full cloud appended as the finest
level. Host-side, run once per mesh in preprocessing. A copy of the host
paths of `eigenpinns_tpu/sampling/samplers.py`: farthest-point sampling
takes the compiled kernel of `geometry/native.py` when its library loads,
else the numpy loop.
"""

from __future__ import annotations

import numpy as np

from eigenpinns_torch.geometry import native as _native


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
    if _native.available():
        return _native.fps_native(points, n_samples, start=start)
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


def voxel_levels(points: np.ndarray, hierarchy: list[int]) -> list[np.ndarray]:
    """Voxel-grid downsampling with target-count size search.

    Parity with `_voxel_downsampling` (src/samplers.py:9-94): per level,
    scan voxel scales [0.7..1.5], pick one point per voxel (closest to the
    voxel center), keep the scale whose count is nearest the target;
    truncate overshoot; sorted indices; full cloud appended. Vectorized
    with a lexsort/group-reduce: O(N log N) total.
    """
    n = points.shape[0]
    min_b = points.min(axis=0)
    extent = points.max(axis=0) - min_b
    levels = []
    for target in hierarchy:
        if target >= n:
            levels.append(np.arange(n))
            continue
        volume = np.prod(extent)
        base = (volume / (target * 2)) ** (1 / 3)
        best, best_diff = None, np.inf
        for scale in (0.7, 0.85, 1.0, 1.15, 1.3, 1.5):
            vox = base * scale
            dims = np.ceil(extent / vox).astype(int) + 1
            vidx = np.clip((points - min_b) / vox, 0, dims - 1).astype(int)
            vid = (vidx[:, 0] * dims[1] * dims[2]
                   + vidx[:, 1] * dims[2] + vidx[:, 2])
            centers = min_b + (vidx + 0.5) * vox
            d2 = np.sum((points - centers) ** 2, axis=1)
            # One representative per voxel: the point closest to its center.
            order = np.lexsort((d2, vid))
            first = np.ones(n, dtype=bool)
            first[1:] = vid[order][1:] != vid[order][:-1]
            sel = order[first]
            diff = abs(sel.size - target)
            if diff < best_diff:
                best, best_diff = sel, diff
            if sel.size >= target * 0.95:
                break
        levels.append(np.sort(best[:target] if best.size > target else best))
    levels.append(np.arange(n))
    return levels


def random_levels(points: np.ndarray, hierarchy: list[int],
                  seed: int = 0) -> list[np.ndarray]:
    """Nested uniform-random levels (the notebook hierarchy-builder's
    'random' mode, downsampling_toy_example.ipynb cell 0:20-57)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(points.shape[0])
    levels = [np.sort(perm[:n].copy()) for n in hierarchy]
    levels.append(np.arange(points.shape[0]))
    return levels


def leverage_score_levels(K, hierarchy: list[int],
                          seed: int = 0) -> list[np.ndarray]:
    """Diagonal-magnitude ('leverage score') sampling of an operator —
    parity with `leverage_score_sampling`
    (downsampling_toy_example.ipynb cell 0:60-71): probability proportional
    to row norms of K."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    scores = np.asarray(abs(K).sum(axis=1)).ravel() if sp.issparse(K) \
        else np.abs(K).sum(axis=1)
    p = scores / scores.sum()
    n = K.shape[0]
    order = rng.choice(n, size=min(hierarchy[-1], n), replace=False, p=p)
    levels = [np.sort(order[:m].copy()) for m in hierarchy]
    levels.append(np.arange(n))
    return levels
