"""The port's host-stage copies agree with the JAX package's host code.

The port copies (rather than imports) the numpy/scipy host stage, since
every `eigenpinns_tpu` subpackage imports JAX. These tests hold each
copy to the original on the same points: the point-cloud Laplacian of
the numpy triangulation to 1e-12 (both sides flip in their compiled
kernel when it is built, an exact port of the Python loop; the native
triangulation is held in test_torch_native.py), identical FPS levels and
kNN edges, prolongation weights and eigsh eigenvalues to 1e-10.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from eigenpinns_tpu.configs import Config as JConfig
from eigenpinns_tpu.geometry.mesh import TriMesh as JTriMesh
from eigenpinns_tpu.geometry.mesh import save_obj as j_save_obj
from eigenpinns_tpu.geometry.point_cloud import point_cloud_laplacian as j_pcl
from eigenpinns_tpu.sampling.knn import knn_graph as j_knn
from eigenpinns_tpu.sampling.knn import prolongation_matrix as j_prolong
from eigenpinns_tpu.sampling.samplers import farthest_point_levels as j_fps
from eigenpinns_tpu.solvers.oracle import eigsh_smallest as j_eigsh
from eigenpinns_torch.configs import Config
from eigenpinns_torch.geometry import load_obj, point_cloud_laplacian
from eigenpinns_torch.sampling import (
    farthest_point_levels,
    knn_graph,
    prolongation_matrix,
)
from eigenpinns_torch.solvers.oracle import eigsh_smallest
from eigenpinns_torch.utils.fixtures import icosphere, perturbed_icosphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cloud():
    return perturbed_icosphere(3).verts


def test_perturbed_icosphere_sizes_and_shape():
    """n_sub=4 is the 2562-vertex bench surface; the radial factor is
    1 + 0.3 sin(3 theta) sin(2 phi) (bench.make_cloud)."""
    assert icosphere(3).n_verts == 642
    m = perturbed_icosphere(4)
    assert (m.n_verts, m.n_faces) == (2562, 5120)
    v = m.verts
    r = np.linalg.norm(v, axis=1)
    theta = np.arctan2(v[:, 1], v[:, 0])
    phi = np.arccos(v[:, 2] / r)
    np.testing.assert_allclose(
        r, 1 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi), atol=1e-12)


@pytest.mark.parametrize("n_neighbors", [15, 30])
def test_point_cloud_laplacian_matches_jax_numpy_path(cloud, n_neighbors):
    L, M = point_cloud_laplacian(cloud, n_neighbors=n_neighbors,
                                 use_native=False)
    Lj, Mj = j_pcl(cloud, n_neighbors=n_neighbors, use_native=False)
    assert L.nnz == Lj.nnz
    assert abs(L - Lj).max() <= 1e-12 * abs(Lj).max()
    np.testing.assert_allclose(M.diagonal(), Mj.diagonal(), rtol=1e-12)


def test_fps_knn_prolongation_eigsh_match_jax(cloud):
    levels = farthest_point_levels(cloud, [64, 160], seed=0)
    for a, b in zip(levels, j_fps(cloud, [64, 160], seed=0)):
        np.testing.assert_array_equal(a, b)
    X0, X1 = cloud[levels[0]], cloud[levels[1]]
    # Same neighbor set per row; the icosphere's exact distance ties may
    # be listed in another order by the JAX side's compiled kNN.
    e, ej = knn_graph(X1, 21), j_knn(X1, 21)
    np.testing.assert_array_equal(e[0], ej[0])
    np.testing.assert_array_equal(np.sort(e[1].reshape(-1, 21), axis=1),
                                  np.sort(ej[1].reshape(-1, 21), axis=1))
    P, Pj = prolongation_matrix(X0, X1, 21), j_prolong(X0, X1, 21)
    assert abs(P.tocsr() - Pj.tocsr()).max() < 1e-10
    L, M = point_cloud_laplacian(X1, n_neighbors=15)
    vals, _ = eigsh_smallest(L, M, 6)
    vals_j, _ = j_eigsh(L, M, 6)
    np.testing.assert_allclose(vals, vals_j, rtol=0, atol=1e-10)


def test_config_matches_jax_field_for_field(tmp_path):
    fields = [(f.name, f.type) for f in dataclasses.fields(Config)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(JConfig)]
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JConfig())
    path = tmp_path / "p.yml"
    path.write_text("runner:\n  n_modes: 7\n  hierarchy: [32, 64]\n"
                    "multigridGNN:\n  epochs: 12\n")
    cfg = Config.from_yaml(str(path))
    assert (cfg.n_modes, cfg.hierarchy, cfg.epochs) == (7, [32, 64], 12)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JConfig.from_yaml(str(path)))
    path.write_text("runner:\n  bogus: 1\n")
    with pytest.raises(ValueError):
        Config.from_yaml(str(path))


def test_load_obj_reads_jax_written_mesh(tmp_path):
    m = icosphere(1)
    j_save_obj(str(tmp_path / "s.obj"), JTriMesh(m.verts, m.faces))
    back = load_obj(str(tmp_path / "s.obj"))
    np.testing.assert_array_equal(back.faces, m.faces)
    np.testing.assert_allclose(back.verts, m.verts, rtol=0, atol=0)


def test_port_imports_no_jax():
    """Importing every eigenpinns_torch module leaves jax (and flax,
    optax, eigenpinns_tpu, yaml) out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import eigenpinns_torch\n"
        "for m in pkgutil.walk_packages(eigenpinns_torch.__path__,\n"
        "                               'eigenpinns_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'eigenpinns_tpu',\n"
        "                   'yaml') if m in sys.modules]\n"
        "print(len(list(pkgutil.walk_packages(eigenpinns_torch.__path__))),"
        " bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_native_source_is_the_jax_packages_source():
    """The port compiles its own copy of the C++ geometry kernels; it is
    the root csrc/ source byte for byte, so both packages build the same
    kNN, FPS, triangulations and flips."""
    with open(os.path.join(ROOT, "csrc", "geometry_kernels.cpp"), "rb") as f:
        jax_source = f.read()
    with open(os.path.join(ROOT, "eigenpinns_torch", "csrc",
                           "geometry_kernels.cpp"), "rb") as f:
        assert f.read() == jax_source
