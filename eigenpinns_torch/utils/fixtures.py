"""Synthetic surfaces, clouds and matrices that need no mesh download.

`perturbed_icosphere(4)` is the 2562-vertex bench surface: a subdivided
icosahedron projected onto the unit sphere, then scaled radially by
1 + amp sin(3 theta) sin(2 phi) (the perturbation of `bench.make_cloud`)
so that the sphere's degenerate eigenvalues split. `make_cloud(n, seed)`
is `bench.make_cloud` itself: n random points on that perturbed sphere,
the cloud of the bench's 300k and 1M direct-training phases.

The matrix fixtures (`laplacian_1d`, `generate_test_matrices`,
`verify_eigenpairs`, `subsample_hierarchy`, ...) are copies of
`eigenpinns_tpu/utils/fixtures.py`: the matrix-only hierarchical solver
and its tests use them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from eigenpinns_torch.geometry.mesh import TriMesh


def icosphere(n_sub: int = 3) -> TriMesh:
    """Unit icosphere by `n_sub` midpoint subdivisions of an icosahedron
    (10 * 4**n_sub + 2 vertices)."""
    t = (1 + 5**0.5) / 2
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(n_sub):
        mid: dict = {}
        new_faces = []
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                verts.append((np.asarray(verts[a]) + np.asarray(verts[b]))
                             / 2)
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.asarray(new_faces)
        verts = np.asarray(verts)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return TriMesh(verts, faces.astype(np.int32))


def perturbed_icosphere(n_sub: int = 4, amp: float = 0.3) -> TriMesh:
    """Icosphere scaled radially by 1 + amp sin(3 theta) sin(2 phi),
    theta the azimuth and phi the polar angle (`bench.make_cloud`)."""
    sphere = icosphere(n_sub)
    v = sphere.verts
    theta = np.arctan2(v[:, 1], v[:, 0])
    phi = np.arccos(np.clip(v[:, 2], -1.0, 1.0))
    r = 1.0 + amp * np.sin(3 * theta) * np.sin(2 * phi)
    return TriMesh(v * r[:, None], sphere.faces)


def make_cloud(n: int, seed: int = 0) -> np.ndarray:
    """n points uniform in (azimuth, cos polar angle) on the sphere scaled
    radially by 1 + 0.3 sin(3 theta) sin(2 phi); (n, 3) float64."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = np.arccos(rng.uniform(-1, 1, n))
    r = 1.0 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi)
    return (r[:, None] * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
         np.cos(phi)], 1)).astype(np.float64)


def adversarial_rolling_matrix():
    """A 1000 x 1000 nonsymmetric scipy matrix whose rolling band (built
    with `reorder=False`: pre = 256, B = 640, B' = 768) puts its nonzeros
    where a walk over the band's occupancy bits is easiest to get wrong:
    row tile 1 holds a single entry, in the last 16 x 16 sub-block of its
    piece (bit 63 of the word, the sign bit); there are entries in the
    first and last row and column; tile 0's window starts 256 rows before
    U's row 0 and the last tile's ends 280 rows past its last row; the
    sub-block of (999, 999) multiplies U rows 992..1007, of which only 8
    exist; and the last row tile is ragged (rows 1000..1023 do not
    exist). Nonsymmetric, so the operator stores its transpose."""
    ij = np.array([[0, 0], [0, 200], [100, 17], [255, 255], [300, 0],
                   [300, 300], [400, 390], [600, 513], [640, 999],
                   [650, 650], [800, 790], [999, 999], [999, 700]])
    vals = np.array([2.0, -0.5, 1.25, 1.5, 0.75, -3.0, 0.375, 2.5, 3.0,
                     -1.0, 0.625, -2.25, 4.0])
    return sp.csr_matrix((vals, (ij[:, 0], ij[:, 1])), shape=(1000, 1000))


# ---- matrix fixtures: copies of eigenpinns_tpu/utils/fixtures.py ----------

def laplacian_1d(n: int):
    """1D FD Laplacian; spectrum 2 - 2 cos(pi j / (n+1)), j = 1..n."""
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()


def laplacian_1d_eigenvalues(n: int, k: int) -> np.ndarray:
    j = np.arange(1, k + 1)
    return 2.0 - 2.0 * np.cos(np.pi * j / (n + 1))


def tridiagonal(n: int, seed: int = 0):
    """Random symmetric positive tridiagonal matrix."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(2.0, 4.0, size=n)
    o = rng.uniform(-1.0, -0.2, size=n - 1)
    return sp.diags([o, d, o], [-1, 0, 1]).tocsr()


def random_spd(n: int, density: float = 0.05, seed: int = 0):
    """Sparse random SPD pair (K, M) — K = A A^T + n I pattern, M SPD
    diagonal."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density,
                  random_state=np.random.RandomState(seed))
    K = (A @ A.T + sp.eye(n)).tocsr()
    M = sp.diags(rng.uniform(0.5, 2.0, size=n)).tocsr()
    return K, M


def generate_test_matrices(n: int, kind: str = "laplacian", seed: int = 0):
    """(K, M) fixture pair by kind: 'laplacian' | 'tridiagonal' |
    'random_spd' — matching the reference's generator."""
    if kind == "laplacian":
        return laplacian_1d(n), sp.eye(n).tocsr()
    if kind == "tridiagonal":
        return tridiagonal(n, seed), sp.eye(n).tocsr()
    if kind == "random_spd":
        return random_spd(n, seed=seed)
    raise ValueError(f"unknown kind '{kind}'")


def verify_eigenpairs(K, M, vals: np.ndarray, vecs: np.ndarray,
                      tol: float = 1e-6):
    """Residual norms ||K u - lam M u|| / ||K u|| and the orthonormality
    defect (downsampling_toy_example.ipynb cell 0:271-280).

    Returns (rel_residuals, max_gram_defect, ok).
    """
    Ku = K @ vecs
    Mu = M @ vecs
    res = Ku - Mu * vals[None, :]
    rel = np.linalg.norm(res, axis=0) / (np.linalg.norm(Ku, axis=0) + 1e-300)
    G = vecs.T @ Mu
    defect = np.abs(G - np.eye(vecs.shape[1])).max()
    return rel, float(defect), bool(rel.max() < tol and defect < tol)


def align_ritz_vectors(w: np.ndarray, V: np.ndarray,
                       rel_gap: float = 0.1) -> np.ndarray:
    """Ritz vectors V (ascending values w) with the freedom an eigensolver
    leaves them removed: each cluster of values less than `rel_gap`
    (relative) apart is rotated onto a fixed random reference by the
    polar factor of V_c^T R_c, a single vector's sign included. The
    result depends only on the clusters' subspaces, so two devices whose
    eigh flips signs or rotates near-degenerate pairs differently return
    the same columns. A check uses it to compare runs; no solver does."""
    w = np.asarray(w, np.float64)
    out = np.asarray(V, np.float64).copy()
    R = np.random.default_rng(out.shape[0]).standard_normal(out.shape)
    start = 0
    for i in range(1, len(w) + 1):
        if i < len(w) and w[i] - w[i - 1] <= rel_gap * max(abs(w[i]), 1e-3):
            continue
        c = slice(start, i)
        a, _, bt = np.linalg.svd(out[:, c].T @ R[:, c])
        out[:, c] = out[:, c] @ (a @ bt)
        start = i
    return out.astype(np.asarray(V).dtype)


def subsample_hierarchy(n: int, levels: list[int], method: str = "uniform",
                        K=None, seed: int = 0) -> list[np.ndarray]:
    """Nested index hierarchies for matrix-only multigrid
    (downsampling_toy_example.ipynb cell 0:20-57): 'uniform' (evenly
    spaced), 'random', 'leverage' (row-norm weighted), 'maxdist' (greedy
    farthest-point selection with |K| row entries as the distance proxy).
    Returns indices per level, coarsest first, full range appended.
    """
    out = []
    rng = np.random.default_rng(seed)
    for m in levels:
        m = min(m, n)
        if method == "uniform":
            idx = np.unique(np.linspace(0, n - 1, m).astype(int))
        elif method == "random":
            idx = np.sort(rng.choice(n, size=m, replace=False))
        elif method == "leverage":
            if K is None:
                raise ValueError("leverage sampling needs K")
            scores = np.asarray(abs(K).sum(axis=1)).ravel()
            p = scores / scores.sum()
            idx = np.sort(rng.choice(n, size=m, replace=False, p=p))
        elif method == "maxdist":
            if K is None:
                raise ValueError("maxdist sampling needs K")
            Ka = abs(K.tocsr()) if hasattr(K, "tocsr") else np.abs(K)
            picked = [0]
            dist = np.full(n, np.inf)
            for _ in range(m - 1):
                row = np.asarray(
                    Ka[picked[-1]].todense()
                    if hasattr(Ka, "todense") else Ka[picked[-1]]).ravel()
                dist = np.minimum(dist, row)
                dist[picked] = -np.inf
                picked.append(int(np.argmax(dist)))
            idx = np.sort(np.asarray(picked))
        else:
            raise ValueError(f"unknown method '{method}'")
        out.append(idx)
    out.append(np.arange(n))
    return out
