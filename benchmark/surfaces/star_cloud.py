"""The bench cloud of the JAX package's bench phases, triangulated: a
star-shaped surface r = 1 + 0.3 sin 3 theta sin 2 phi, uniform in the
directions (a frozen copy of `bench.py`'s `make_cloud`). Its
triangulation is the convex hull of the directions, which is the
surface's own triangulation because the surface is star-shaped. K is the
cotangent stiffness matrix and m the lumped mass.

A configuration names it with `"surface": "star_cloud"` and gives
`n_points` and `cloud_seed`.
"""

from __future__ import annotations

import numpy as np

import inputs

# The configuration's keys that the surface reads.
KEYS = ("n_points", "cloud_seed")


def make_cloud(n: int, seed: int) -> np.ndarray:
    """n points (float64, (n, 3)) of the bench's star-shaped surface."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = np.arccos(rng.uniform(-1, 1, n))
    r = 1.0 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi)
    return (r[:, None] * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
         np.cos(phi)], 1)).astype(np.float64)


def triangulate(X: np.ndarray) -> np.ndarray:
    """Triangles ((m, 3) int) of the convex hull of X's directions. Raises
    ValueError when a point is not a vertex of the hull (a direction
    repeated, or too close to its neighbours' plane)."""
    from scipy.spatial import ConvexHull

    dirs = X / np.linalg.norm(X, axis=1, keepdims=True)
    tris = ConvexHull(dirs).simplices.astype(np.int64)
    if np.unique(tris).size != X.shape[0]:
        raise ValueError(f"{X.shape[0] - np.unique(tris).size} points are "
                         "not vertices of the hull of the directions")
    return tris


def make(cfg: dict):
    """(X, K, m) of the configuration's surface."""
    X = make_cloud(cfg["n_points"], cfg["cloud_seed"])
    K, m = inputs.cotangent_operators(X, triangulate(X))
    return X, K, m
