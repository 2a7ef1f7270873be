"""Point-cloud Laplacian: a from-scratch replacement for `robust_laplacian`.

The reference leans on the C++ `robust_laplacian` package
(`src/utils.py:172-176`, `src/mesh_helpers.py:62-63`) for
`point_cloud_laplacian(X) -> (L, M)` — a PSD weak Laplacian L and a lumped
diagonal mass M on an unstructured point cloud. That package is not
available here, so this module reimplements the algorithm of
Sharp & Crane, "A Laplacian for Nonmanifold Triangle Meshes" (SGP 2020),
point-cloud variant:

  1. k-nearest neighbors per point (default 30, like robust_laplacian);
  2. PCA tangent plane per point;
  3. 2D Delaunay triangulation of the projected neighborhood;
  4. union of all one-ring triangles -> global triangle soup (deduped);
  5. intrinsic mollification of edge lengths (relative factor 1e-5);
  6. intrinsic cotan stiffness + barycentric lumped mass from the soup.

Host-side by design: operator assembly is offline preprocessing (it runs
once per hierarchy level); the assembled sparse operators are then
converted to device formats by `eigenpinns_torch.sparse`. Step 6 is
vectorized over all triangles.

A copy of `eigenpinns_tpu/geometry/point_cloud.py`, so that the port
never imports the JAX package.
Steps 1-4 and the intrinsic-Delaunay flips run in the compiled kernels of
`geometry/native.py` when that library loads (the C++ triangulation and
flips of the JAX package's own source), else in numpy/scipy; either
way the result equals the JAX package's on the same path to round-off.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.spatial import Delaunay, cKDTree

from eigenpinns_torch.geometry import native as _native


def _tangent_frames(points: np.ndarray, neigh: np.ndarray):
    """PCA tangent plane per point from its kNN neighborhood.

    Returns (e1, e2): two (N, 3) orthonormal in-plane basis vectors.
    """
    nbr = points[neigh]  # (N, k, 3)
    centered = nbr - nbr.mean(axis=1, keepdims=True)
    # Covariance per point: (N, 3, 3)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    # eigh returns ascending eigenvalues; the two largest span the plane.
    _, vecs = np.linalg.eigh(cov)
    e1 = vecs[:, :, 2]
    e2 = vecs[:, :, 1]
    return e1, e2


def local_triangulations(points: np.ndarray, n_neighbors: int,
                         frame_neighbors: int):
    """One-ring triangles from per-point tangent-plane Delaunay triangulations.

    Returns a deduplicated (T, 3) int array of global vertex triples and
    per-triangle weights
    ``count/3`` where ``count`` is the number of one-rings that produced the
    triangle. A triangle all three of whose corners agree on it gets weight
    1; spurious triangles seen from a single corner get 1/3. This both
    suppresses outlier connections and normalizes the soup's total area to
    approximately one surface cover (the role played by the tufted-cover
    construction in Sharp & Crane 2020).

    ``frame_neighbors`` sizes the PCA tangent-frame neighborhood
    independently of the triangulation neighborhood.
    The two knobs act differently: the frame wants just enough points
    for a stable plane (too many smears it across curvature — measured
    blowing up bunny mode 2 by 8-15% at 60-80 neighbors), while the
    triangulation wants enough projected points that the center's
    Delaunay one-ring is interior to the patch.
    """
    n = points.shape[0]
    k = min(n_neighbors, n - 1)
    kf = min(frame_neighbors, n - 1)
    tree = cKDTree(points)
    _, neigh = tree.query(points, k=max(k, kf) + 1)  # self at column 0
    e1, e2 = _tangent_frames(points, neigh[:, :kf + 1])

    tris = []
    for i in range(n):
        idx = neigh[i, :k + 1]  # local->global map; idx[0] == i
        rel = points[idx] - points[i]
        uv = np.stack([rel @ e1[i], rel @ e2[i]], axis=1)
        try:
            dt = Delaunay(uv)
        except Exception:  # degenerate neighborhoods (collinear projections)
            continue
        simplices = dt.simplices
        # Keep triangles incident to the center point (local index 0).
        ring = simplices[(simplices == 0).any(axis=1)]
        if ring.size:
            tris.append(idx[ring])
    if not tris:
        raise ValueError("no valid local triangulations; degenerate cloud?")
    return dedup_soup(np.concatenate(tris, axis=0))


def dedup_soup(soup: np.ndarray):
    """(tris, weights) of a raw one-ring soup: each triangle once, in the
    order of its first appearance, weighted min(count / 3, 1) by the
    number of one-rings that produced it."""
    key = np.sort(soup, axis=1)
    _, uniq, counts = np.unique(key, axis=0, return_index=True,
                                return_counts=True)
    order = np.argsort(uniq)
    weights = np.minimum(counts[order].astype(np.float64) / 3.0, 1.0)
    return soup[uniq[order]], weights


def _intrinsic_mollify(l: np.ndarray, rel_factor: float = 1e-5) -> np.ndarray:
    """Sharp-Crane intrinsic mollification.

    Adds the smallest global epsilon so every triangle satisfies the
    triangle inequality with slack `rel_factor * mean(edge length)`.
    l: (T, 3) edge lengths ordered (l12, l20, l01) opposite corners (0,1,2).
    """
    delta = rel_factor * l.mean()
    # Violation per corner: l_a + l_b - l_c >= delta  =>  eps >= (delta - (la+lb-lc))/...
    viol = np.stack(
        [l[:, 1] + l[:, 2] - l[:, 0],
         l[:, 2] + l[:, 0] - l[:, 1],
         l[:, 0] + l[:, 1] - l[:, 2]],
        axis=1,
    )
    eps = max(0.0, (delta - viol.min()))
    return l + eps


def _cot_at(lengths: np.ndarray, c: int) -> float:
    """cot of the angle at corner c from a triangle's three edge lengths
    (lengths[k] = edge opposite corner k)."""
    a, b = lengths[(c + 1) % 3], lengths[(c + 2) % 3]
    lc = lengths[c]
    s = 0.5 * (a + b + lc)
    area2 = max(s * (s - a) * (s - b) * (s - lc), 1e-300)
    return (a * a + b * b - lc * lc) / (4.0 * np.sqrt(area2))


def _group_sides_by_edge(tris: np.ndarray):
    """Map each undirected vertex pair (u, v) to the list of triangle
    sides [(t, corner), ...] lying on it (corner = the opposite corner)."""
    from collections import defaultdict

    by_vpair: dict = defaultdict(list)
    for t in range(tris.shape[0]):
        a, b, c = (int(v) for v in tris[t])
        for (u, v), corner in (((b, c), 0), ((a, c), 1), ((a, b), 2)):
            key = (u, v) if u < v else (v, u)
            by_vpair[key].append((t, corner))
    return by_vpair


def _radial_side_order(lst, tris, points, u, v):
    """Sort the sides on edge (u, v) by the angle of their apex around
    the edge axis — the gluing order of Sharp & Crane's tufted cover."""
    if len(lst) < 2:
        return lst
    axis = points[v] - points[u]
    axis = axis / (np.linalg.norm(axis) + 1e-300)
    ref = None
    angs = []
    for t, corner in lst:
        apex = int(tris[t][corner])
        w = points[apex] - points[u]
        w = w - axis * (w @ axis)
        if ref is None:
            nw = np.linalg.norm(w)
            ref = (w / nw if nw > 1e-300
                   else np.array([1.0, 0.0, 0.0]))
            ref2 = np.cross(axis, ref)
        angs.append(np.arctan2(w @ ref2, w @ ref))
    order = np.argsort(angs)
    return [lst[i] for i in order]


def intrinsic_delaunay_flips(tris: np.ndarray, lengths: np.ndarray,
                             weights: np.ndarray, points: np.ndarray):
    """Flip the triangulation to intrinsic Delaunay, tufted-cover style.

    Sharp & Crane 2020 always build the Laplacian on the INTRINSIC
    DELAUNAY triangulation of the tufted cover (sec 3.4); skipping the
    flips leaves a triangulation with strictly higher Dirichlet energy
    (Rippa's theorem) — i.e. a uniformly stiffer operator. This pass is
    the flips-on-the-soup analog:

      * edge sides are paired RADIALLY around each edge axis (adjacent
        sides in angular order glue, the tufted-cover gluing rule), so
        nonmanifold soup edges — exactly the spurious chords a point
        cloud soup produces — participate in flips, not only the clean
        two-sided ones;
      * everything is intrinsic: `lengths[t, c]` (edge opposite corner
        c) drives the Delaunay test (cot_a + cot_b >= 0) and flipped
        diagonals are measured in the unfolded triangle pair, never in
        3D; `points` is used ONLY for the one-time radial pairing;
      * a flip's two triangles average their soup weights.

    The JAX package also offers the literal published construction
    (every face doubled, every edge exactly 2-sided), measured spectrally
    equivalent on the bunny GT (docs/PARITY.md § operator-fidelity
    ledger); this cheaper single-copy pairing is its default and the
    only one ported.

    Mutates and returns (tris, lengths, weights). Runs the C++ kernel
    (`native.delaunay_flips_native`, an exact port including the pairing
    order) when the native library loads; the Python loop below is the
    reference path.
    """
    T = tris.shape[0]
    if _native.available():
        tris64 = np.ascontiguousarray(tris, dtype=np.int64)
        l64 = np.ascontiguousarray(lengths, dtype=np.float64)
        w64 = np.ascontiguousarray(weights, dtype=np.float64)
        _native.delaunay_flips_native(points, tris64, l64, w64, 30 * T)
        tris[:] = tris64
        lengths[:] = l64
        weights[:] = w64
        return tris, lengths, weights

    # ---- initial gluing: radial pairing per vertex-pair edge ----------
    sides: dict = {}          # eid -> [(t, corner), (t, corner)]
    tri_eid = -np.ones((T, 3), dtype=np.int64)
    next_eid = 0
    for (u, v), lst in _group_sides_by_edge(tris).items():
        lst = _radial_side_order(lst, tris, points, u, v)
        for j in range(0, len(lst) - 1, 2):
            s = [lst[j], lst[j + 1]]
            sides[next_eid] = s
            for t, corner in s:
                tri_eid[t, corner] = next_eid
            next_eid += 1
        if len(lst) % 2:
            t, corner = lst[-1]
            sides[next_eid] = [(t, corner)]
            tri_eid[t, corner] = next_eid
            next_eid += 1

    _flip_core(tris, lengths, weights, sides, tri_eid, 30 * T)
    return tris, lengths, weights


def tufted_double_cover(tris: np.ndarray, lengths: np.ndarray,
                        weights: np.ndarray, points: np.ndarray,
                        max_flips: int | None = None):
    """Sharp & Crane's tufted double cover + intrinsic Delaunay flips.

    The literal published construction (sec 3.3): every triangle is
    doubled (front + back copy); around each vertex-pair edge the sides
    are sorted radially and the BACK copy of side i glues to the FRONT
    copy of side i+1 (cyclically), so EVERY edge — including nonmanifold
    soup edges and boundary edges — becomes exactly 2-sided and
    participates in flips. Weights are halved so stiffness/mass totals
    match one surface cover; the generalized spectrum is then directly
    comparable to the single cover's.

    Returns new (tris, lengths, weights) of length 2T; inputs are not
    mutated. Python-only (no csrc path): measured on the reference
    bunny GT this is spectrally equivalent to the default single-copy
    radial pairing (mean 0.91%/max 1.83% vs 0.93%/1.82% — docs/PARITY.md
    ledger), so it is exposed for completeness/verification rather than
    as the default.
    """
    T = tris.shape[0]
    if max_flips is None:
        max_flips = 60 * T
    tris2 = np.concatenate([tris, tris], axis=0).astype(np.int64)
    lengths2 = np.concatenate([lengths, lengths], axis=0)
    weights2 = 0.5 * np.concatenate([weights, weights], axis=0)

    sides: dict = {}
    tri_eid = -np.ones((2 * T, 3), dtype=np.int64)
    next_eid = 0
    for (u, v), lst in _group_sides_by_edge(tris).items():
        lst = _radial_side_order(lst, tris, points, u, v)
        m = len(lst)
        for i in range(m) if m >= 2 else [0]:
            if m >= 2:
                tb, cb = lst[i]            # back copy of side i ...
                ta, ca = lst[(i + 1) % m]  # ... to front copy of side i+1
                s = [(tb + T, cb), (ta, ca)]
            else:
                t, c = lst[0]              # lone side: glue its two copies
                s = [(t, c), (t + T, c)]
            sides[next_eid] = s
            for t, corner in s:
                tri_eid[t, corner] = next_eid
            next_eid += 1

    _flip_core(tris2, lengths2, weights2, sides, tri_eid, max_flips)
    return tris2, lengths2, weights2


def _flip_core(tris, lengths, weights, sides, tri_eid, max_flips):
    """Intrinsic-Delaunay flip queue over a pre-glued edge structure.

    `sides` maps edge id -> list of (triangle, corner) sides (length 1
    or 2; only 2-sided edges flip); `tri_eid` is the inverse (T, 3) map.
    Mutates tris/lengths/weights/sides/tri_eid in place and returns the
    number of flips performed.
    """
    from collections import deque

    queue = deque(e for e, s in sides.items() if len(s) == 2)
    in_queue = set(queue)
    n_flips = 0
    eps = 1e-12

    while queue and n_flips < max_flips:
        eid = queue.popleft()
        in_queue.discard(eid)
        s = sides.get(eid)
        if s is None or len(s) != 2:
            continue
        (t1, c1), (t2, c2) = s
        if _cot_at(lengths[t1], c1) + _cot_at(lengths[t2], c2) >= -eps:
            continue
        apex1 = int(tris[t1][c1])
        apex2 = int(tris[t2][c2])
        if apex1 == apex2:
            continue
        # Shared edge endpoints, with consistent (p, q) naming from t1.
        p = int(tris[t1][(c1 + 1) % 3])
        q = int(tris[t1][(c1 + 2) % 3])
        corners2 = [int(v) for v in tris[t2]]
        if p not in corners2 or q not in corners2:
            continue  # stale gluing (should not happen)
        # Unfold around (p, q); all lengths intrinsic.
        L = lengths[t1][c1]
        pc = lengths[t1][(c1 + 2) % 3]   # edge (p, apex1), opposite q
        qc = lengths[t1][(c1 + 1) % 3]   # edge (q, apex1), opposite p
        pd = lengths[t2][corners2.index(q)]
        qd = lengths[t2][corners2.index(p)]
        xc = (pc * pc - qc * qc + L * L) / (2 * L)
        yc = np.sqrt(max(pc * pc - xc * xc, 0.0))
        xd = (pd * pd - qd * qd + L * L) / (2 * L)
        yd = -np.sqrt(max(pd * pd - xd * xd, 0.0))
        diag = np.hypot(xc - xd, yc - yd)
        if (diag <= eps or diag + 1e-12 >= pc + pd
                or diag + 1e-12 >= qc + qd):
            continue

        # Old boundary-edge ids of the quad.
        e_pc = tri_eid[t1, (c1 + 2) % 3]
        e_qc = tri_eid[t1, (c1 + 1) % 3]
        e_pd = tri_eid[t2, corners2.index(q)]
        e_qd = tri_eid[t2, corners2.index(p)]

        # New triangles: t1 = (p, apex1, apex2), t2 = (q, apex1, apex2).
        tris[t1] = (p, apex1, apex2)
        lengths[t1] = (diag, pd, pc)
        tris[t2] = (q, apex1, apex2)
        lengths[t2] = (diag, qd, qc)
        w_new = 0.5 * (weights[t1] + weights[t2])
        weights[t1] = weights[t2] = w_new

        # The flipped diagonal reuses eid; rewire the four boundary ids.
        sides[eid] = [(t1, 0), (t2, 0)]
        tri_eid[t1, 0] = tri_eid[t2, 0] = eid

        def _rewire(e, side_old, new_side):
            lst = sides[e]
            for i, so in enumerate(lst):
                if so == side_old:
                    lst[i] = new_side
                    break
            tri_eid[new_side[0], new_side[1]] = e

        _rewire(e_pc, (t1, (c1 + 2) % 3), (t1, 2))   # (p, apex1)
        _rewire(e_pd, (t2, corners2.index(q)), (t1, 1))   # (p, apex2)
        _rewire(e_qc, (t1, (c1 + 1) % 3), (t2, 2))   # (q, apex1)
        _rewire(e_qd, (t2, corners2.index(p)), (t2, 1))   # (q, apex2)
        n_flips += 1
        for e in (eid, e_pc, e_pd, e_qc, e_qd):
            if e not in in_queue and len(sides.get(e, ())) == 2:
                queue.append(e)
                in_queue.add(e)
    return n_flips


def cotan_laplacian_from_soup(
    points: np.ndarray, tris: np.ndarray, mollify_factor: float = 1e-5,
    tri_weights: np.ndarray | None = None,
    delaunay_flips: bool | str = "auto",
):
    """Intrinsic cotan stiffness + barycentric lumped mass of a triangle soup.

    Operates purely on (mollified) edge lengths so it is robust to skinny or
    flipped triangles. Vectorized over all T triangles. ``tri_weights``
    scales each triangle's stiffness and mass contributions (multiplicity
    weighting of overlapping soups); None weighs every triangle 1.

    ``delaunay_flips``: run the intrinsic-Delaunay flip pass first
    (Sharp-Crane sec 3.4; measurably softens the spectrum toward the
    C++ robust_laplacian output). "auto" enables it whenever the native
    library loads (seconds at millions of triangles); without it the
    Python loop (~1.2 ms per 1k triangles) is only used below 100k
    triangles. "tufted" runs the flips on the literal tufted double
    cover (`tufted_double_cover`; Python-only, so ~2x the Python flip
    cost), spectrally equivalent to the default pairing on the bunny
    GT, exposed for verification.
    """
    if delaunay_flips == "auto":
        delaunay_flips = _native.available() or tris.shape[0] < 100_000
    n = points.shape[0]
    p = points[tris]  # (T, 3, 3)
    # Edge lengths opposite each corner: l[:, c] = |edge opposite corner c|
    l = np.stack(
        [np.linalg.norm(p[:, 1] - p[:, 2], axis=1),
         np.linalg.norm(p[:, 2] - p[:, 0], axis=1),
         np.linalg.norm(p[:, 0] - p[:, 1], axis=1)],
        axis=1,
    )
    l = _intrinsic_mollify(l, mollify_factor)
    if tri_weights is None:
        tri_weights = np.ones(len(tris))
    if delaunay_flips:
        tris = np.array(tris, dtype=np.int64, copy=True)
        w = np.array(tri_weights, dtype=np.float64, copy=True)
        if delaunay_flips == "tufted":
            # Halved per copy: the totals match one cover.
            tris, l, tri_weights = tufted_double_cover(tris, l, w, points)
        else:
            tris, l, tri_weights = intrinsic_delaunay_flips(tris, l, w,
                                                            points)
    l2 = l**2
    # Heron (numerically-stable enough after mollification).
    s = 0.5 * l.sum(axis=1)
    area2 = s * (s - l[:, 0]) * (s - l[:, 1]) * (s - l[:, 2])
    area = np.sqrt(np.clip(area2, 1e-300, None))
    # cot(angle at corner c) = (l_a^2 + l_b^2 - l_c^2) / (4 * area)
    cots = np.stack(
        [(l2[:, 1] + l2[:, 2] - l2[:, 0]),
         (l2[:, 2] + l2[:, 0] - l2[:, 1]),
         (l2[:, 0] + l2[:, 1] - l2[:, 2])],
        axis=1,
    ) / (4.0 * area)[:, None]

    cots = cots * tri_weights[:, None]
    area = area * tri_weights

    # Corner c contributes cot_c/2 to the edge opposite c.
    opp = [(1, 2), (2, 0), (0, 1)]
    rows, cols, vals = [], [], []
    for c, (a, b) in enumerate(opp):
        w = 0.5 * cots[:, c]
        ia, ib = tris[:, a], tris[:, b]
        rows += [ia, ib, ia, ib]
        cols += [ib, ia, ia, ib]
        vals += [-w, -w, w, w]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    L = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()

    mass = np.zeros(n)
    np.add.at(mass, tris.reshape(-1),
              np.repeat(area / 3.0, 3).reshape(-1, 3).reshape(-1))
    # Guard isolated points (no incident triangle).
    mass[mass <= 0] = mass[mass > 0].min() if (mass > 0).any() else 1.0
    M = sp.diags(mass).tocsr()
    return L, M


def point_cloud_laplacian(points: np.ndarray, n_neighbors: int = 38,
                          mollify_factor: float = 1e-5,
                          use_native: bool | None = None,
                          frame_neighbors: int | None = None,
                          cover: str = "paired"):
    """(L, M) for a raw point cloud — drop-in for
    `robust_laplacian.point_cloud_laplacian` (src/utils.py:174).

    L is symmetric PSD (weak cotan Laplacian), M diagonal lumped mass.
    `use_native`: the C++ triangulation (`geometry/native.py`); None
    takes it when the library loads, True raises when it cannot be built
    or loaded, False takes the numpy/scipy triangulation. The flips take
    the C++ kernel whenever the library loads (`cotan_laplacian_from_soup`).
    `cover` picks the flip gluing: "paired" (default; single-copy radial
    pairing, with the native path) or "tufted" (the literal Sharp & Crane
    doubled cover, spectrally equivalent on the bunny GT, Python-only).

    Defaults (n_neighbors=38, PCA frame over min(n_neighbors, 34); the
    C++ library's own single knob defaults to 30): tuned against the
    reference's recorded bunny ground truth — this construction at
    kn=30 carries a uniform +2.2% eigenvalue bias vs the C++ output;
    decoupling the two neighborhoods and scanning both shows a smooth
    optimum at (frames 34, triangulation 38) which, with the
    intrinsic-Delaunay flip pass, lands at mean 0.93% / max 1.82%
    (docs/PARITY.md has the full tuning ledger: weighting schemes, flip
    ablation, 2-D kn scan, PCA-centering variants).
    """
    if cover not in ("paired", "tufted"):
        # Validate before the triangulation, the dominant preprocessing
        # cost at large N (minutes at 300k+).
        raise ValueError(f"unknown cover {cover!r}")
    points = np.asarray(points, dtype=np.float64)
    if frame_neighbors is None:
        frame_neighbors = min(n_neighbors, 34)
    if use_native is None:
        use_native = _native.available()
    if use_native:
        tris, weights = dedup_soup(_native.local_triangulations_native(
            points, n_neighbors=n_neighbors,
            frame_neighbors=frame_neighbors))
    else:
        tris, weights = local_triangulations(
            points, n_neighbors=n_neighbors, frame_neighbors=frame_neighbors)
    return cotan_laplacian_from_soup(
        points, tris, mollify_factor, tri_weights=weights,
        delaunay_flips="tufted" if cover == "tufted" else "auto")


def mesh_laplacian(verts: np.ndarray, faces: np.ndarray,
                   mollify_factor: float = 1e-5,
                   delaunay_flips: bool = False):
    """(L, M) intrinsic cotan Laplacian of an (indexed) triangle mesh —
    the mesh-path analog of `robust_laplacian.mesh_laplacian`.

    `delaunay_flips=False` by default: the given connectivity is kept so
    the classical FEM == cotan identity holds; pass True for the flipped
    (intrinsic-Delaunay) operator."""
    return cotan_laplacian_from_soup(
        np.asarray(verts, dtype=np.float64),
        np.asarray(faces, dtype=np.int64),
        mollify_factor,
        delaunay_flips=delaunay_flips,
    )
