"""Quadric error-metric mesh decimation (Garland-Heckbert edge collapse).

From-scratch replacement for the reference's pyvista/VTK dependency
(`_simplify_mesh_decimation`, src/samplers.py:146-185): simplify a
triangle mesh towards a target vertex count for the `graph_coarsening`
sampler. Host-side preprocessing by design — decimation never sits in a
training loop (SURVEY.md section 2.3).

A copy of `eigenpinns_tpu/sampling/decimation.py`, arithmetic and heap
order included, so that both packages decimate a mesh to the same
vertices and faces bit for bit.
"""

from __future__ import annotations

import heapq

import numpy as np

from eigenpinns_torch.geometry.mesh import TriMesh


def _face_quadrics(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(F, 4, 4) plane quadrics p p^T with p = [n, -n.v0], |n| = 1."""
    v0 = verts[faces[:, 0]]
    n = np.cross(verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.clip(norm, 1e-300, None)
    d = -np.sum(n * v0, axis=1)
    p = np.concatenate([n, d[:, None]], axis=1)  # (F, 4)
    return p[:, :, None] * p[:, None, :]


def _optimal_position(Q: np.ndarray, va: np.ndarray, vb: np.ndarray):
    """Collapse target minimizing v^T Q v, clamped near the edge.

    The unconstrained quadric minimum can land far outside the surface for
    near-singular quadrics (flat neighborhoods); fall back to the best of
    {endpoint a, endpoint b, midpoint} whenever the solution strays more
    than one edge length from the midpoint."""
    mid = 0.5 * (va + vb)
    A = Q[:3, :3]
    b = -Q[:3, 3]
    det = np.linalg.det(A)
    scale = np.abs(A).max() + 1e-300
    candidates = [va, vb, mid]
    if abs(det) > 1e-10 * scale**3:
        v = np.linalg.solve(A, b)
        if np.linalg.norm(v - mid) <= np.linalg.norm(va - vb) + 1e-300:
            candidates.append(v)

    def cost(v):
        h = np.append(v, 1.0)
        return float(h @ Q @ h)

    costs = [cost(v) for v in candidates]
    i = int(np.argmin(costs))
    return candidates[i], costs[i]


def _boundary_quadrics(verts: np.ndarray, faces: np.ndarray,
                       weight: float = 1e3) -> np.ndarray:
    """Penalty quadrics pinning boundary edges (edges with one incident
    face): planes through the edge, perpendicular to the face — the
    Garland-Heckbert boundary-preservation trick. Returns (V, 4, 4)."""
    from collections import Counter

    edge_faces = Counter()
    for f in faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            edge_faces[(min(a, b), max(a, b))] += 1
    # Map edge -> containing face normal (recompute per face for simplicity).
    v0 = verts[faces[:, 0]]
    fn = np.cross(verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0)
    fn /= np.clip(np.linalg.norm(fn, axis=1, keepdims=True), 1e-300, None)

    Q = np.zeros((len(verts), 4, 4))
    for fi, f in enumerate(faces):
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            if edge_faces[(min(a, b), max(a, b))] != 1:
                continue
            e = verts[b] - verts[a]
            n = np.cross(e, fn[fi])
            nn = np.linalg.norm(n)
            if nn < 1e-300:
                continue
            n /= nn
            d = -n @ verts[a]
            p = np.append(n, d)
            q = weight * np.outer(p, p)
            Q[a] += q
            Q[b] += q
    return Q


def decimate(mesh: TriMesh, target_vertices: int) -> TriMesh:
    """Collapse lowest-cost edges until ~target_vertices remain."""
    verts = mesh.verts.copy()
    faces = mesh.faces.astype(np.int64).copy()
    n = len(verts)
    if target_vertices >= n:
        return mesh

    Q = _boundary_quadrics(verts, faces)
    fq = _face_quadrics(verts, faces)
    for c in range(3):
        np.add.at(Q, faces[:, c], fq)

    # Adjacency: vertex -> set of faces; edges from faces.
    vert_faces = [set() for _ in range(n)]
    for fi, f in enumerate(faces):
        for c in f:
            vert_faces[c].add(fi)
    face_alive = np.ones(len(faces), dtype=bool)
    vert_alive = np.ones(n, dtype=bool)
    # Union-find style remap.
    remap = np.arange(n)

    def find(v):
        while remap[v] != v:
            remap[v] = remap[remap[v]]
            v = remap[v]
        return v

    version = np.zeros(n, dtype=np.int64)

    def edge_entry(a, b):
        a, b = find(a), find(b)
        if a == b:
            return None
        pos, cost = _optimal_position(Q[a] + Q[b], verts[a], verts[b])
        return (cost, a, b, version[a], version[b], pos)

    heap = []
    seen = set()
    for f in faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            key = (min(a, b), max(a, b))
            if key not in seen:
                seen.add(key)
                e = edge_entry(a, b)
                if e:
                    heapq.heappush(heap, (e[0], e[1], e[2], e[3], e[4],
                                          tuple(e[5])))

    n_alive = n
    while n_alive > target_vertices and heap:
        cost, a, b, va, vb, pos = heapq.heappop(heap)
        a, b = find(a), find(b)
        if a == b or not (vert_alive[a] and vert_alive[b]):
            continue
        if version[a] != va or version[b] != vb:
            continue  # stale entry
        # Collapse b into a.
        verts[a] = np.asarray(pos)
        Q[a] = Q[a] + Q[b]
        vert_alive[b] = False
        remap[b] = a
        version[a] += 1
        n_alive -= 1

        # Update incident faces; drop degenerate ones.
        moved = vert_faces[b] | vert_faces[a]
        neighbors = set()
        for fi in list(moved):
            if not face_alive[fi]:
                continue
            f = [find(v) for v in faces[fi]]
            if len(set(f)) < 3:
                face_alive[fi] = False
                continue
            faces[fi] = f
            for v in f:
                vert_faces[v].add(fi)
                if v != a:
                    neighbors.add(v)
        vert_faces[a] |= vert_faces[b]
        vert_faces[b] = set()

        for v in neighbors:
            e = edge_entry(a, v)
            if e:
                heapq.heappush(heap, (e[0], e[1], e[2], e[3], e[4],
                                      tuple(e[5])))

    # Compact — keep only vertices actually referenced by surviving faces
    # (a vertex can outlive all its faces; a zero row in K AND M would make
    # downstream generalized eigensolves singular).
    out_faces = []
    for fi in np.where(face_alive)[0]:
        f = [find(v) for v in faces[fi]]
        if len(set(f)) == 3:
            out_faces.append(f)
    out_faces = np.asarray(out_faces, dtype=np.int64)
    used = np.unique(out_faces)
    new_id = -np.ones(n, dtype=np.int64)
    new_id[used] = np.arange(used.size)
    return TriMesh(verts[used], new_id[out_faces].astype(np.int32))


def decimation_levels(mesh: TriMesh, hierarchy: list[int]) -> list[TriMesh]:
    """Simplified meshes per hierarchy target + the input mesh appended,
    mirroring the graph_coarsening sampler flow (src/samplers.py:218-229)."""
    out = [decimate(mesh, t) for t in hierarchy]
    out.append(mesh)
    return out
