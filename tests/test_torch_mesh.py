"""The port's mesh path against the JAX package (CPU, small).

On perturbed_icosphere(3) (642 vertices): `TriMesh`'s face and edge
methods equal the JAX package's exactly and `save_obj`/`load_obj` round
trip through both packages; the host FEM assembly equals the JAX
package's to 1e-12 (lumped and consistent mass); the device FEM
functions, in float32 on the CPU, agree with the JAX functions to rel
1e-5; `mesh_laplacian`, the random and leverage-score samplers and the
three oracle functions agree to round-off; and `decimation_levels` gives
the JAX package's vertices and faces bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenpinns_tpu.geometry import fem as j_fem
from eigenpinns_tpu.geometry.mesh import TriMesh as JTriMesh
from eigenpinns_tpu.geometry.mesh import load_obj as j_load_obj
from eigenpinns_tpu.geometry.mesh import save_obj as j_save_obj
from eigenpinns_tpu.geometry.point_cloud import (
    mesh_laplacian as j_mesh_laplacian,
)
from eigenpinns_tpu.sampling.decimation import decimate as j_decimate
from eigenpinns_tpu.sampling.decimation import (
    decimation_levels as j_decimation_levels,
)
from eigenpinns_tpu.sampling.samplers import (
    leverage_score_levels as j_leverage_levels,
)
from eigenpinns_tpu.sampling.samplers import random_levels as j_random_levels
from eigenpinns_tpu.solvers import oracle as j_oracle
from eigenpinns_torch.geometry import (
    TriMesh,
    assemble_coo,
    assemble_force,
    assemble_stiffness_mass,
    element_force,
    element_mass,
    element_stiffness,
    gradient_operator,
    load_obj,
    mesh_laplacian,
    save_obj,
    triangle_geometry,
)
from eigenpinns_torch.sampling import (
    decimate,
    decimation_levels,
    leverage_score_levels,
    random_levels,
)
from eigenpinns_torch.solvers import oracle
from eigenpinns_torch.utils.fixtures import perturbed_icosphere

torch.set_num_threads(2)

RTOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return perturbed_icosphere(3)


@pytest.fixture(scope="module")
def jmesh(mesh):
    return JTriMesh(mesh.verts, mesh.faces)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("method", ["face_corners", "face_normals",
                                    "face_normals_raw", "face_areas",
                                    "face_centroids", "edges",
                                    "edges_undirected"])
def test_trimesh_methods_equal_jax(mesh, jmesh, method):
    if method == "face_normals_raw":
        ours, ref = (mesh.face_normals(normalized=False),
                     jmesh.face_normals(normalized=False))
    elif method == "edges_undirected":
        ours, ref = mesh.edges(directed=False), jmesh.edges(directed=False)
    else:
        ours, ref = getattr(mesh, method)(), getattr(jmesh, method)()
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_obj_round_trip_through_both_packages(mesh, tmp_path):
    save_obj(str(tmp_path / "t.obj"), mesh)
    j_save_obj(str(tmp_path / "j.obj"), JTriMesh(mesh.verts, mesh.faces))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj"
                                                 ).read_bytes()
    for back in (load_obj(str(tmp_path / "j.obj")),
                 j_load_obj(str(tmp_path / "t.obj"))):
        np.testing.assert_array_equal(back.verts, mesh.verts)
        np.testing.assert_array_equal(back.faces, mesh.faces)


@pytest.mark.parametrize("lumped", [False, True])
def test_host_fem_assembly_equals_jax(mesh, jmesh, lumped):
    K, M = assemble_stiffness_mass(mesh, lumped=lumped)
    jK, jM = j_fem.assemble_stiffness_mass(jmesh, lumped=lumped)
    assert abs(K - jK).max() <= 1e-12 * abs(jK).max()
    assert abs(M - jM).max() <= 1e-12 * abs(jM).max()
    assert (M.nnz == mesh.n_verts) == lumped


def _device_inputs(mesh):
    v, f = mesh.verts.astype(np.float32), mesh.faces.astype(np.int32)
    return (torch.from_numpy(v), torch.from_numpy(f)), (jnp.asarray(v),
                                                        jnp.asarray(f))


def test_triangle_geometry_and_element_matrices(mesh):
    (tv, tf), (jv, jf) = _device_inputs(mesh)
    B, J = triangle_geometry(tv, tf)
    jB, jJ = j_fem.triangle_geometry(jv, jf)
    assert B.dtype == torch.float32 and B.shape == (mesh.n_faces, 2, 3)
    assert _rel(B, jB) < RTOL and _rel(J, jJ) < RTOL
    assert _rel(element_stiffness(B, J),
                j_fem.element_stiffness(jB, jJ)) < RTOL
    assert _rel(element_mass(J), j_fem.element_mass(jJ)) < RTOL


@pytest.mark.parametrize("lumped", [False, True])
def test_assemble_coo_equals_jax(mesh, lumped):
    (tv, tf), (jv, jf) = _device_inputs(mesh)
    rows, cols, k_vals, m_vals = assemble_coo(tv, tf, lumped=lumped)
    jr, jc, jk, jm = j_fem.assemble_coo(jv, jf, lumped=lumped)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jc))
    assert _rel(k_vals, jk) < RTOL and _rel(m_vals, jm) < RTOL
    assert m_vals.shape == ((mesh.n_verts,) if lumped
                            else (9 * mesh.n_faces,))


def test_force_and_gradient_operator_equal_jax(mesh):
    (tv, tf), (jv, jf) = _device_inputs(mesh)
    X = np.random.default_rng(0).standard_normal(
        (mesh.n_faces, 2)).astype(np.float32)
    B, J = triangle_geometry(tv, tf)
    jB, jJ = j_fem.triangle_geometry(jv, jf)
    assert _rel(element_force(B, J, torch.from_numpy(X)),
                j_fem.element_force(jB, jJ, jnp.asarray(X))) < RTOL
    assert _rel(assemble_force(tv, tf, torch.from_numpy(X)),
                j_fem.assemble_force(jv, jf, jnp.asarray(X))) < RTOL
    G, GJ = gradient_operator(tv, tf)
    jG, jGJ = j_fem.gradient_operator(jv, jf)
    assert _rel(G, jG) < RTOL and _rel(GJ, jGJ) < RTOL


def test_assemble_force_is_stiffness_times_nodal_field(mesh):
    """Integration by parts: the load of a field's local-frame gradient
    is K u (float64 on the CPU)."""
    tv, tf = torch.from_numpy(mesh.verts), torch.from_numpy(mesh.faces)
    u = np.random.default_rng(1).standard_normal(mesh.n_verts)
    B, J = triangle_geometry(tv, tf)
    X = torch.einsum("fde,fe->fd", B,
                     torch.from_numpy(u)[tf.long()]) / J[:, None]
    K, _ = assemble_stiffness_mass(mesh)
    np.testing.assert_allclose(assemble_force(tv, tf, X).numpy(), K @ u,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("flips", [False, True])
def test_mesh_laplacian_equals_jax(mesh, flips):
    L, M = mesh_laplacian(mesh.verts, mesh.faces, delaunay_flips=flips)
    jL, jM = j_mesh_laplacian(mesh.verts, mesh.faces, delaunay_flips=flips)
    assert abs(L - jL).max() <= 1e-12 * abs(jL).max()
    assert abs(M - jM).max() <= 1e-12 * abs(jM).max()


def test_random_and_leverage_levels_equal_jax(mesh):
    for seed in (0, 3):
        for a, b in zip(random_levels(mesh.verts, [32, 100], seed=seed),
                        j_random_levels(mesh.verts, [32, 100], seed=seed)):
            np.testing.assert_array_equal(a, b)
    K, _ = assemble_stiffness_mass(mesh)
    ours = leverage_score_levels(K, [40, 120], seed=1)
    ref = j_leverage_levels(K, [40, 120], seed=1)
    assert [len(x) for x in ours] == [40, 120, mesh.n_verts]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    dense = leverage_score_levels(K.toarray(), [40], seed=1)
    np.testing.assert_array_equal(dense[0], ours[0])


def test_decimation_levels_identical_to_jax(mesh, jmesh):
    ours = decimation_levels(mesh, [64, 160])
    ref = j_decimation_levels(jmesh, [64, 160])
    assert [m.n_verts for m in ours] == [64, 160, mesh.n_verts]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.verts, b.verts)
        np.testing.assert_array_equal(a.faces, b.faces)
    assert ours[-1] is mesh


def test_decimate_keeps_a_closed_manifold(mesh):
    """The decimated mesh's faces reference every vertex, each edge has
    two faces, and a target at or above the size returns the mesh."""
    m = decimate(mesh, 100)
    assert m.n_verts == 100
    assert np.array_equal(np.unique(m.faces), np.arange(100))
    und = np.sort(np.concatenate([m.faces[:, [0, 1]], m.faces[:, [1, 2]],
                                  m.faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(und, axis=0, return_counts=True)
    assert (counts == 2).all()
    assert decimate(mesh, mesh.n_verts) is mesh
    ref = j_decimate(JTriMesh(mesh.verts, mesh.faces), 100)
    np.testing.assert_array_equal(m.faces, ref.faces)


def test_oracle_functions_equal_jax(mesh, jmesh):
    vals, vecs, K, M = oracle.solve_eigenvalue_mesh(mesh, 6)
    jvals, jvecs, jK, jM = j_oracle.solve_eigenvalue_mesh(jmesh, 6)
    np.testing.assert_allclose(vals, jvals, rtol=0, atol=1e-10)
    assert abs(K - jK).max() == 0 and abs(M - jM).max() == 0
    X = mesh.verts[::3]
    vals, _, L, Mp = oracle.solve_eigenvalue_point_cloud(X, 5, n_neighbors=15)
    jvals, _, jL, _ = j_oracle.solve_eigenvalue_point_cloud(X, 5,
                                                            n_neighbors=15)
    np.testing.assert_allclose(vals, jvals, rtol=0, atol=1e-10)
    U = np.random.default_rng(2).standard_normal((mesh.n_verts, 4))
    Q = oracle.orthonormalize_gs(U, M)
    np.testing.assert_allclose(Q, j_oracle.orthonormalize_gs(U, M),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(Q.T @ (M @ Q), np.eye(4), atol=1e-10)
