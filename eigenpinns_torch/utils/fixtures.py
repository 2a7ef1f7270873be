"""Synthetic surfaces and clouds that need no mesh download.

`perturbed_icosphere(4)` is the 2562-vertex bench surface: a subdivided
icosahedron projected onto the unit sphere, then scaled radially by
1 + amp sin(3 theta) sin(2 phi) (the perturbation of `bench.make_cloud`)
so that the sphere's degenerate eigenvalues split. `make_cloud(n, seed)`
is `bench.make_cloud` itself: n random points on that perturbed sphere,
the cloud of the bench's 300k and 1M direct-training phases.
"""

from __future__ import annotations

import numpy as np

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
    import scipy.sparse as sp

    ij = np.array([[0, 0], [0, 200], [100, 17], [255, 255], [300, 0],
                   [300, 300], [400, 390], [600, 513], [640, 999],
                   [650, 650], [800, 790], [999, 999], [999, 700]])
    vals = np.array([2.0, -0.5, 1.25, 1.5, 0.75, -3.0, 0.375, 2.5, 3.0,
                     -1.0, 0.625, -2.25, 4.0])
    return sp.csr_matrix((vals, (ij[:, 0], ij[:, 1])), shape=(1000, 1000))
