"""Point-to-surface projection on triangle meshes.

Parity with `Mesh.project_new_point` / `project_point_check`
(src/Mesh.py:81-160): project arbitrary 3D points onto the mesh surface —
nearest-node seeding, barycentric projection onto candidate incident
triangles, edge/vertex clamping. Vectorized numpy (host-side utility);
`project_points_device` projects batches onto every face on the card.
`project_points` is a copy of `eigenpinns_tpu/geometry/projection.py`'s.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from eigenpinns_torch.geometry.mesh import TriMesh

# Query-face pairs projected at once by `project_points_device` (a chunk
# holds a few (q, F, 3) float32 tensors: ~50 MB each at this count).
_PAIRS_PER_CHUNK = 1 << 22


def _project_to_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p + barycentric coords.

    Ericson's 'Real-Time Collision Detection' region test — exact clamped
    projection (the reference approximates with in-triangle checks and
    nearest-node fallback, src/Mesh.py:102-160).
    """
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = ab @ ap, ac @ ap
    if d1 <= 0 and d2 <= 0:
        return a, (1.0, 0.0, 0.0)
    bp = p - b
    d3, d4 = ab @ bp, ac @ bp
    if d3 >= 0 and d4 <= d3:
        return b, (0.0, 1.0, 0.0)
    vc = d1 * d4 - d3 * d2
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        v = d1 / (d1 - d3)
        return a + v * ab, (1 - v, v, 0.0)
    cp = p - c
    d5, d6 = ab @ cp, ac @ cp
    if d6 >= 0 and d5 <= d6:
        return c, (0.0, 0.0, 1.0)
    vb = d5 * d2 - d1 * d6
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        w = d2 / (d2 - d6)
        return a + w * ac, (1 - w, 0.0, w)
    va = d3 * d6 - d5 * d4
    if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
        w = (d4 - d3) / ((d4 - d3) + (d5 - d6))
        return b + w * (c - b), (0.0, 1 - w, w)
    denom = 1.0 / (va + vb + vc)
    v = vb * denom
    w = vc * denom
    return a + ab * v + ac * w, (1 - v - w, v, w)


def project_points(mesh: TriMesh, points: np.ndarray,
                   n_candidates: int = 8):
    """Project each query point onto the mesh surface.

    Returns (projected (Q,3), face_index (Q,), barycentric (Q,3)).
    Candidate triangles: all faces incident to the n_candidates nearest
    vertices (the reference's nearest-node seeding, src/Mesh.py:91).
    """
    verts, faces = mesh.verts, mesh.faces
    tree = cKDTree(verts)
    # vertex -> incident faces
    vert_faces: list[list[int]] = [[] for _ in range(mesh.n_verts)]
    for fi, f in enumerate(faces):
        for v in f:
            vert_faces[v].append(fi)

    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    _, nearest = tree.query(points, k=min(n_candidates, mesh.n_verts))
    if nearest.ndim == 1:
        nearest = nearest[:, None]

    out_p = np.empty_like(points)
    out_f = np.empty(len(points), dtype=np.int64)
    out_b = np.empty((len(points), 3))
    for qi, p in enumerate(points):
        cand = set()
        for v in nearest[qi]:
            cand.update(vert_faces[v])
        best_d, best = np.inf, None
        for fi in cand:
            a, b, c = verts[faces[fi]]
            proj, bary = _project_to_triangle(p, a, b, c)
            d = np.sum((proj - p) ** 2)
            if d < best_d:
                best_d, best = d, (proj, fi, bary)
        out_p[qi], out_f[qi], out_b[qi] = best[0], best[1], best[2]
    return out_p, out_f, out_b


def _closest_on_faces(p: torch.Tensor, a: torch.Tensor, ab: torch.Tensor,
                      ac: torch.Tensor):
    """Exact closest points of queries p (q, 3) on every face (a, ab, ac):
    the projection onto the face's plane where it falls inside the face,
    else the nearest of the three edges' closest points. Returns the
    (q, F) squared distances and the (q, F, 3) points."""
    g11, g12, g22 = ((ab * ab).sum(1), (ab * ac).sum(1), (ac * ac).sum(1))
    det = torch.clamp(g11 * g22 - g12 * g12, min=1e-30)
    ap = p[:, None, :] - a[None]                      # (q, F, 3)
    r1, r2 = (ap * ab).sum(-1), (ap * ac).sum(-1)
    v = (g22 * r1 - g12 * r2) / det
    w = (g11 * r2 - g12 * r1) / det
    inside = (v >= 0) & (w >= 0) & (v + w <= 1)
    best = a + v[..., None] * ab + w[..., None] * ac
    best_d = torch.where(inside, ((best - p[:, None]) ** 2).sum(-1),
                         torch.inf)
    for start, edge in ((a, ab), (a, ac), (a + ab, ac - ab)):
        t = ((p[:, None, :] - start) * edge).sum(-1) / torch.clamp(
            (edge * edge).sum(1), min=1e-30)
        c = start + torch.clamp(t, 0.0, 1.0)[..., None] * edge
        d = ((c - p[:, None]) ** 2).sum(-1)
        closer = d < best_d
        best_d = torch.where(closer, d, best_d)
        best = torch.where(closer[..., None], c, best)
    return best_d, best


def project_points_device(verts, faces, points, device="cuda"):
    """Brute-force projection of every query onto ALL faces on the device.

    The port of the JAX package's vmapped `project_points_device`: O(Q *
    F) work and the minimum over every face (no candidate set), in
    float32. Per face it takes the exact closest point (`_closest_on_faces`),
    where the JAX function clamps the unclamped barycentric coordinates
    (v to [0, 1], then w to [0, 1 - v]): that closed form is exact only
    when the closest point is inside the face or at a vertex, and near an
    edge it can return a farther point than the host's `project_points`
    (ROADMAP F22). Queries go through in chunks of at most
    `_PAIRS_PER_CHUNK` query-face pairs to bound the device memory.
    Returns (projected (Q, 3), face index (Q,)) as tensors on `device`;
    ties go to the first face, as `jnp.argmin`.
    """
    verts = torch.as_tensor(np.asarray(verts), dtype=torch.float32,
                            device=device)
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    points = torch.atleast_2d(torch.as_tensor(
        np.asarray(points), dtype=torch.float32, device=device))
    tri = verts[faces]                               # (F, 3, 3)
    a = tri[:, 0]
    ab, ac = tri[:, 1] - a, tri[:, 2] - a
    step = max(1, _PAIRS_PER_CHUNK // faces.shape[0])
    projs, idxs = [], []
    for p in points.split(step):
        d, proj = _closest_on_faces(p, a, ab, ac)
        i = torch.argmin(d, dim=1)
        projs.append(proj[torch.arange(p.shape[0], device=device), i])
        idxs.append(i)
    return torch.cat(projs), torch.cat(idxs)
