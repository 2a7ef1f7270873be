"""Triangle-mesh container, OBJ IO and normalization.

Capability parity with the reference loader/normalizer
(`src/Mesh.py:29-79`, `src/mesh_helpers.py:9-20`): Wavefront OBJ parsing
(``v``/``f`` records, 1-based indices, polygon fan-triangulation),
centroid/max-axis-std normalization, per-face normals and areas.

Host-side numpy by design: mesh IO is offline preprocessing; everything
downstream receives plain arrays that are moved to the device once. A
copy of `eigenpinns_tpu/geometry/mesh.py`, whose package imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TriMesh:
    """An indexed triangle mesh (float64 host arrays)."""

    verts: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (F, 3) int32, counter-clockwise

    def __post_init__(self):
        object.__setattr__(self, "verts", np.asarray(self.verts, dtype=np.float64))
        object.__setattr__(self, "faces", np.asarray(self.faces, dtype=np.int32))
        if self.verts.ndim != 2 or self.verts.shape[1] != 3:
            raise ValueError(f"verts must be (V, 3), got {self.verts.shape}")
        if self.faces.ndim != 2 or self.faces.shape[1] != 3:
            raise ValueError(f"faces must be (F, 3), got {self.faces.shape}")

    @property
    def n_verts(self) -> int:
        return self.verts.shape[0]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    def face_corners(self) -> np.ndarray:
        """(F, 3, 3) coordinates of each face's three corners."""
        return self.verts[self.faces]

    def face_normals(self, normalized: bool = True) -> np.ndarray:
        """Per-face normals; `normalized=False` returns area-weighted normals."""
        c = self.face_corners()
        n = np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
        if normalized:
            n = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-300)
        return n

    def face_areas(self) -> np.ndarray:
        c = self.face_corners()
        return 0.5 * np.linalg.norm(
            np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]), axis=1
        )

    def face_centroids(self) -> np.ndarray:
        return self.face_corners().mean(axis=1)

    def edges(self, directed: bool = True) -> np.ndarray:
        """Unique mesh edges as (2, E) int array.

        With ``directed=True`` both (i, j) and (j, i) are emitted — the
        edge_index convention of the reference (`src/mesh_helpers.py:66-90`).
        """
        f = self.faces
        e = np.concatenate(
            [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]],
             f[:, [1, 0]], f[:, [2, 1]], f[:, [0, 2]]],
            axis=0,
        )
        e = np.unique(e, axis=0)
        if not directed:
            e = np.unique(np.sort(e, axis=1), axis=0)
        return e.T.astype(np.int64)


def load_obj(path: str) -> TriMesh:
    """Parse a Wavefront OBJ file into a TriMesh.

    Handles ``v x y z`` and ``f a b c [d ...]`` records (with optional
    ``a/t/n`` attribute syntax); polygons are fan-triangulated. Matches the
    reference loader's behavior (`src/Mesh.py:47-79`) without its Python
    per-line bookkeeping of normals (recomputed on demand here).
    """
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.asarray(verts, dtype=np.float64),
                   np.asarray(faces, dtype=np.int32))


def save_obj(path: str, mesh: TriMesh) -> None:
    with open(path, "w") as fh:
        for v in mesh.verts:
            fh.write(f"v {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        for f in mesh.faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def normalize_mesh(mesh: TriMesh, eps: float = 1e-12) -> TriMesh:
    """Center at the centroid and divide by the max per-axis std.

    Exactly the reference normalization (`src/mesh_helpers.py:9-13`):
    ``(verts - verts.mean(0)) / (verts.std(0).max() + 1e-12)``.
    """
    centroid = mesh.verts.mean(axis=0)
    std_max = mesh.verts.std(axis=0).max() + eps
    return TriMesh((mesh.verts - centroid) / std_max, mesh.faces)


def load_mesh(path: str, normalize: bool = True) -> TriMesh:
    """Reference-parity convenience loader (`src/mesh_helpers.py:16-20`)."""
    mesh = load_obj(path)
    return normalize_mesh(mesh) if normalize else mesh
