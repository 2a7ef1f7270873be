"""Parity of the port's device geometry with JAX, and the port's `ops`
namespace and debug utilities.

Inputs are made with numpy from a seed; both packages run on the CPU.
Tolerances:

  * `project_points` (host float64): exactly equal to JAX's;
  * `project_points_device` (float32): squared distances abs 1e-6 of the
    exact minimum over all faces (float64, the host's region test), never
    farther than JAX's or the host's projection (+1e-6); projected points
    abs 1e-5 of JAX's and equal face indices wherever JAX's clamped form
    is exact and the closest face is unique (ROADMAP F22: elsewhere the
    JAX function returns a farther point);
  * `knn_graph_device`: the same neighbor set per row as JAX's on a cloud
    whose k-th and (k+1)-th distances are apart;
  * `fps_device`: equal to `fps_jax` on 200 normal points;
  * the `ops` namespace imports, and the drivers, operators and geodesics
    import and run in a process where importing jax raises.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenpinns_tpu.geometry import TriMesh as JTriMesh
from eigenpinns_tpu.geometry import project_points as j_project
from eigenpinns_tpu.geometry import project_points_device as j_project_dev
from eigenpinns_tpu.sampling import fps_jax, knn_graph_device as j_knn_dev
from eigenpinns_torch.geometry import project_points, project_points_device
from eigenpinns_torch.geometry import projection
from eigenpinns_torch.sampling import fps_device, knn_graph, knn_graph_device
from eigenpinns_torch.utils import assert_finite, debug_nans, deterministic_mode
from eigenpinns_torch.utils.fixtures import perturbed_icosphere

torch.set_num_threads(2)


def _queries(mesh, n, seed=0):
    """Points off the surface: vertices pushed out or in along a random
    direction by up to 0.15."""
    rng = np.random.default_rng(seed)
    v = mesh.verts[rng.integers(0, mesh.n_verts, n)]
    return v + 0.15 * rng.uniform(-1, 1, size=(n, 3))


@pytest.fixture(scope="module")
def mesh():
    return perturbed_icosphere(2)


def test_project_points_equals_jax(mesh):
    q = _queries(mesh, 40)
    got = project_points(mesh, q)
    ref = j_project(JTriMesh(mesh.verts, mesh.faces), q)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _exact_brute_force(mesh, q):
    """Float64 squared distance of each query to its closest face over all
    faces, by the host's exact region test."""
    from eigenpinns_torch.geometry.projection import _project_to_triangle

    tri = mesh.verts[mesh.faces]
    return np.array([min(np.sum((_project_to_triangle(p, *t)[0] - p) ** 2)
                         for t in tri) for p in q])


def _clamped_form(mesh, q):
    """Float64 squared distances (Q, F) of the JAX function's per-face
    clamped closed form."""
    tri = mesh.verts[mesh.faces]
    a, ab, ac = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    g11, g12, g22 = (ab * ab).sum(1), (ab * ac).sum(1), (ac * ac).sum(1)
    det = np.maximum(g11 * g22 - g12 * g12, 1e-30)
    ap = q[:, None] - a[None]
    r1, r2 = (ap * ab).sum(-1), (ap * ac).sum(-1)
    v = np.clip((g22 * r1 - g12 * r2) / det, 0, 1)
    w = np.minimum(np.maximum((g11 * r2 - g12 * r1) / det, 0), 1 - v)
    p = a + v[..., None] * ab + w[..., None] * ac
    return ((p - q[:, None]) ** 2).sum(-1)


def test_project_points_device_matches_jax(mesh, monkeypatch):
    """The exact minimum over all faces; JAX's where its clamped form is
    exact, never farther elsewhere (ROADMAP F22). The chunk is cut so
    that the queries go through in several."""
    monkeypatch.setattr(projection, "_PAIRS_PER_CHUNK", 20000)
    q = _queries(mesh, 300, seed=1)
    proj, idx = project_points_device(mesh.verts, mesh.faces, q,
                                      device="cpu")
    proj_j, idx_j = map(np.asarray, j_project_dev(mesh.verts, mesh.faces, q))
    assert proj.shape == (300, 3) and idx.shape == (300,)
    d_dev = ((proj.numpy() - q) ** 2).sum(1)
    d_exact = _exact_brute_force(mesh, q)
    assert np.abs(d_dev - d_exact).max() < 1e-6
    d_jax = ((proj_j - q) ** 2).sum(1)
    assert np.all(d_dev <= d_jax + 1e-6)
    # Where JAX's clamped form finds the exact minimum and the closest
    # face beats the second by 1e-6, points and faces are JAX's.
    clamped = np.sort(_clamped_form(mesh, q), axis=1)
    same = (np.abs(clamped[:, 0] - d_exact) < 1e-9) & (
        clamped[:, 1] - clamped[:, 0] > 1e-6)
    assert 100 < same.sum() < 300
    assert np.abs(proj.numpy()[same] - proj_j[same]).max() < 1e-5
    np.testing.assert_array_equal(idx.numpy()[same], idx_j[same])
    # The host's candidate-set projection is never closer.
    host_p = project_points(mesh, q)[0]
    assert np.all(d_dev <= ((host_p - q) ** 2).sum(1) + 1e-6)


def test_knn_graph_device_matches_jax():
    X = np.random.default_rng(2).normal(size=(300, 3)).astype(np.float32)
    k = 8
    got = knn_graph_device(X, k, device="cpu").numpy()
    ref = np.asarray(j_knn_dev(X, k))
    host = knn_graph(X.astype(np.float64), k)
    assert got.shape == ref.shape == (2, 300 * k)
    np.testing.assert_array_equal(got[0], ref[0])
    d = np.sort(((X[:, None] - X[None]) ** 2).sum(-1), axis=1)
    assert np.all(d[:, k + 1] - d[:, k] > 1e-5)   # d[:, 0] is the point
    for i in range(300):
        row = got[1][got[0] == i]
        assert set(row) == set(ref[1][ref[0] == i]) == set(
            host[1][host[0] == i])
        assert i not in row


def test_fps_device_equals_fps_jax():
    pts = np.random.default_rng(0).normal(size=(200, 3))
    for start in (0, 17):
        got = fps_device(pts, 40, start=start, device="cpu")
        assert got.dtype == torch.int64 and got[0] == start
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(fps_jax(jnp.asarray(pts), 40,
                                            start=start)))


def test_ops_namespace():
    from eigenpinns_torch import ops

    for name in ("spmm", "spmv", "banded_spmm", "bsr_spmm", "rolling_spmm",
                 "schrodinger_residual", "eikonal_residual",
                 "hutchinson_laplacian", "gradient_norm_operator",
                 "as_operator", "SplitBanded"):
        assert callable(getattr(ops, name)), name


def test_debug_utilities():
    gen = deterministic_mode(3, device="cpu")
    a = torch.rand(4, generator=gen)
    assert torch.equal(a, torch.rand(4, generator=torch.Generator()
                                     .manual_seed(3)))
    assert np.random.rand() == np.random.RandomState(3).rand()
    assert_finite({"x": torch.ones(3), "y": [np.ones(2), torch.zeros(1)]})
    with pytest.raises(FloatingPointError, match=r"\['y'\]\[1\]"):
        assert_finite({"x": torch.ones(3),
                       "y": [np.ones(2), torch.tensor([1.0, float("nan")])]})
    x = torch.tensor(-1.0, requires_grad=True)
    with debug_nans():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(torch.log(x) * 0 + x).backward()
    assert not torch.is_anomaly_enabled()


def test_pde_slice_imports_and_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'eigenpinns_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import eigenpinns_torch.operators, eigenpinns_torch.solvers\n"
        "import eigenpinns_torch.ops, eigenpinns_torch.geometry.geodesics\n"
        "from eigenpinns_torch.geometry import heat_geodesics\n"
        "from eigenpinns_torch.models import dirichlet_window\n"
        "from eigenpinns_torch.operators import infinite_well\n"
        "from eigenpinns_torch.solvers import solve_eikonal, "
        "solve_schrodinger, solve_eigenvalue_mesh\n"
        "from eigenpinns_torch.utils.fixtures import icosphere\n"
        "m = icosphere(1)\n"
        "y = heat_geodesics(m, [0])\n"
        "enc = solve_eigenvalue_mesh(m, 6)[1].astype('float32')\n"
        "r = solve_eikonal(m, enc, y, n_data=10, hidden=(8,), epochs=4,"
        " scan_chunk=2, element_batch=16, ntk_weights=True, ntk_every=2,"
        " ntk_batch=8, device='cpu')\n"
        "s = solve_schrodinger(infinite_well(), dirichlet_window(0, 1),"
        " (0.0, 1.0), 2, hidden=(8,), epochs_per_mode=3, scan_chunk=3,"
        " batch_size=8, quad_points=16, device='cpu')\n"
        "assert r.u.shape == (42,) and s.eigenvalues.shape == (2,)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax',"
        " 'flax', 'optax', 'eigenpinns_tpu')]\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
