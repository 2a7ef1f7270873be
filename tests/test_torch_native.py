"""The port's native host stage against its numpy paths and the JAX
package's native library.

`eigenpinns_torch/geometry/native.py` builds the port's own copy of the
C++ geometry kernels (`eigenpinns_torch/csrc/geometry_kernels.cpp`) with
the host compiler. Held here, on the same points:

  * kNN against the port's cKDTree path, and farthest-point sampling
    against the port's numpy loop: equal indices;
  * the raw one-ring soup against the JAX package's native library, and
    against the port's own build run on one OpenMP thread: equal;
  * the C++ intrinsic-Delaunay flips against the port's Python loop on a
    soup below 100k triangles: equal triangles, lengths and weights to
    1e-12;
  * `point_cloud_laplacian` on a 60k-point cloud (more than 100k
    triangles, where the numpy path used to skip the flips) against the
    JAX package's, on the native path and on the numpy triangulation:
    equal nnz, |L - L_jax| <= 1e-12 max |L_jax|, M to rtol 1e-12;
  * the build: a hash of source and flags in the library's name, the
    compiler writing a process-unique temp name that is os.replace'd into
    place, no rebuild of an unchanged source, a failed build raising with
    the compiler's stderr, and `use_native=True` raising (never falling
    back) when the library cannot be loaded.

Every case needs a C++ compiler and skips without one.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from eigenpinns_tpu.geometry import native as j_native
from eigenpinns_tpu.geometry.point_cloud import point_cloud_laplacian as j_pcl
from eigenpinns_torch.geometry import native, point_cloud
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sampling import farthest_point_indices, knn_graph
from eigenpinns_torch.utils import cuda_build
from eigenpinns_torch.utils.fixtures import make_cloud

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True)
def _need_compiler():
    if (shutil.which(os.environ.get("CXX", "g++")) is None
            and shutil.which("c++") is None):
        pytest.skip("no C++ compiler on PATH")


@pytest.fixture(scope="module")
def cloud5k():
    return make_cloud(5000)


@pytest.fixture(scope="module")
def cloud60k():
    return make_cloud(60_000)


def _numpy_host(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def test_knn_native_matches_ckdtree(cloud5k, monkeypatch):
    assert native.available()
    e_native = knn_graph(cloud5k, 15)
    np.testing.assert_array_equal(
        native.knn_native(cloud5k, 15).reshape(-1), e_native[1])
    _numpy_host(monkeypatch)
    np.testing.assert_array_equal(knn_graph(cloud5k, 15), e_native)


@pytest.mark.parametrize("n_samples", [1, 64, 700])
def test_fps_native_matches_numpy_loop(cloud5k, monkeypatch, n_samples):
    idx = farthest_point_indices(cloud5k, n_samples, seed=3)
    assert idx.shape == (n_samples,) and idx.dtype == np.int64
    _numpy_host(monkeypatch)
    np.testing.assert_array_equal(
        farthest_point_indices(cloud5k, n_samples, seed=3), idx)


@pytest.mark.parametrize("n_neighbors, frame_neighbors",
                         [(15, 15), (38, 34), (30, None)])
def test_local_triangulations_native_match_jax(cloud5k, n_neighbors,
                                               frame_neighbors):
    if not j_native.available():
        pytest.skip("the JAX package's native library did not build")
    soup = native.local_triangulations_native(
        cloud5k, n_neighbors=n_neighbors, frame_neighbors=frame_neighbors)
    assert soup.shape[0] > 5 * cloud5k.shape[0]
    np.testing.assert_array_equal(soup, j_native.local_triangulations_native(
        cloud5k, n_neighbors=n_neighbors, frame_neighbors=frame_neighbors))


def test_native_results_do_not_depend_on_the_thread_count(cloud5k,
                                                          tmp_path):
    """The same soup, kNN and FPS from a process on one OpenMP thread."""
    code = (
        "import sys, numpy as np\n"
        "from eigenpinns_torch.geometry import native\n"
        "from eigenpinns_torch.utils.fixtures import make_cloud\n"
        "X = make_cloud(5000)\n"
        "np.save(sys.argv[1], np.concatenate([\n"
        "    native.local_triangulations_native(X, 15, 15).ravel(),\n"
        "    native.knn_native(X, 15).ravel(), native.fps_native(X, 300)]))\n")
    out = str(tmp_path / "one_thread.npy")
    proc = subprocess.run(
        [sys.executable, "-c", code, out], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    one = np.load(out)
    many = np.concatenate([
        native.local_triangulations_native(cloud5k, 15, 15).ravel(),
        native.knn_native(cloud5k, 15).ravel(),
        native.fps_native(cloud5k, 300)])
    np.testing.assert_array_equal(one, many)


def test_delaunay_flips_native_match_python(monkeypatch):
    X = make_cloud(3000, seed=4)
    tris, weights = point_cloud.local_triangulations(X, 15, 15)
    assert tris.shape[0] < 100_000
    p = X[tris]
    lengths = point_cloud._intrinsic_mollify(np.stack(
        [np.linalg.norm(p[:, 1] - p[:, 2], axis=1),
         np.linalg.norm(p[:, 2] - p[:, 0], axis=1),
         np.linalg.norm(p[:, 0] - p[:, 1], axis=1)], axis=1))
    ours = [np.array(a, copy=True) for a in (tris, lengths, weights)]
    n_flips = native.delaunay_flips_native(X, *ours, 30 * tris.shape[0])
    assert n_flips > 0
    _numpy_host(monkeypatch)
    ref = point_cloud.intrinsic_delaunay_flips(
        np.array(tris, dtype=np.int64, copy=True), lengths.copy(),
        weights.copy(), X)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-12, atol=0)
    np.testing.assert_allclose(ours[2], ref[2], rtol=1e-12, atol=0)


def _assert_same_operator(L, M, Lj, Mj):
    assert L.nnz == Lj.nnz
    assert abs(L - Lj).max() <= 1e-12 * abs(Lj).max()
    np.testing.assert_allclose(M.diagonal(), Mj.diagonal(), rtol=1e-12)


def test_point_cloud_laplacian_native_matches_jax(cloud60k):
    if not j_native.available():
        pytest.skip("the JAX package's native library did not build")
    L, M = point_cloud_laplacian(cloud60k, n_neighbors=15, use_native=True)
    _assert_same_operator(L, M, *j_pcl(cloud60k, n_neighbors=15,
                                       use_native=True))


def test_point_cloud_laplacian_numpy_triangulation_matches_jax(cloud60k):
    """The numpy triangulation gives more than 100k triangles here, where
    the port used to skip the flip pass and the JAX package flips in C++
    (the fault: nnz 435762 against 434558)."""
    if not j_native.available():
        pytest.skip("the JAX package's native library did not build")
    L, M = point_cloud_laplacian(cloud60k, n_neighbors=15, use_native=False)
    _assert_same_operator(L, M, *j_pcl(cloud60k, n_neighbors=15,
                                       use_native=False))


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A scratch csrc/ and build/ for the host build, with a small C++
    source, and a log of the compiler commands."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "tiny.cpp").write_text(
        'extern "C" int tiny_answer() { return 42; }\n')
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    commands = []
    run = subprocess.run

    def recording_run(cmd, *args, **kw):
        commands.append(list(cmd))
        return run(cmd, *args, **kw)

    monkeypatch.setattr(cuda_build.subprocess, "run", recording_run)
    return csrc, build, commands


def test_host_build_hashes_and_replaces_atomically(build_dir):
    csrc, build, commands = build_dir
    lib = cuda_build.load_host_library("tiny")
    assert lib.tiny_answer() == 42
    built = os.listdir(build)
    assert len(built) == 1
    name = built[0]
    assert name.startswith("tiny-") and name.endswith(".so")
    assert len(name) == len("tiny-") + 16 + len(".so")
    compiles = [c for c in commands if str(csrc / "tiny.cpp") in c]
    assert len(compiles) == 1
    out = compiles[0][compiles[0].index("-o") + 1]
    assert out == os.path.join(str(build), name) + f".build{os.getpid()}"
    _, flags, _ = cuda_build.host_cxx_flags()
    assert flags[:5] == ["-O3", "-march=native", "-fPIC", "-shared",
                         "-std=c++17"]
    assert all(f in compiles[0] for f in flags)
    # Unchanged source: loaded, not rebuilt.
    cuda_build.load_host_library("tiny")
    assert len([c for c in commands if str(csrc / "tiny.cpp") in c]) == 1
    # An edited source gets another hash.
    (csrc / "tiny.cpp").write_text(
        'extern "C" int tiny_answer() { return 7; }\n')
    assert cuda_build.load_host_library("tiny").tiny_answer() == 7
    assert len(os.listdir(build)) == 2


def test_host_build_failure_raises_with_stderr(build_dir):
    csrc, build, _ = build_dir
    (csrc / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        cuda_build.load_host_library("broken")
    assert not os.listdir(build)   # the temp file is gone too


def test_use_native_true_raises_when_the_library_is_missing(
        cloud5k, monkeypatch):
    """A failed load warns once and leaves the numpy paths in use; an
    explicit use_native=True raises the load's error."""
    def failing_build(name):
        raise RuntimeError("compiler said no")

    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(cuda_build, "load_host_library", failing_build)
    with pytest.warns(UserWarning, match="compiler said no"):
        assert not native.available()
    assert not native.available()   # cached: no second warning or build
    with pytest.raises(RuntimeError, match="compiler said no"):
        point_cloud_laplacian(cloud5k[:500], n_neighbors=12,
                              use_native=True)
    with pytest.raises(RuntimeError, match="compiler said no"):
        native.knn_native(cloud5k, 4)
    L, _ = point_cloud_laplacian(cloud5k[:500], n_neighbors=12)
    assert L.shape == (500, 500)
    monkeypatch.undo()
    assert native.available()
