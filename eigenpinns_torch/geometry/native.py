"""ctypes bindings for the native host geometry kernels.

Port of `eigenpinns_tpu/geometry/native.py`. The library is the port's
own copy of the JAX package's C++ source, `csrc/geometry_kernels.cpp`
(kNN, farthest-point sampling, tangent-plane Delaunay one-rings and the
intrinsic-Delaunay flips behind a plain C interface), built for the host
CPU by `utils/cuda_build.py::load_host_library` on first use, never at
import. The OpenMP loops write per point and concatenate in point order,
so the results do not depend on the thread count.

`point_cloud_laplacian`, `knn_graph` and `farthest_point_indices` take
these kernels whenever the library loads (minutes become seconds at
300k-1M points). A failed build warns once with the compiler's stderr
and leaves the numpy paths in use; a caller that asks for the native
path explicitly (`point_cloud_laplacian(use_native=True)`, or any
function below) gets the build's error instead.
"""

from __future__ import annotations

import ctypes
import subprocess
import warnings

import numpy as np

_LIB = None
_ERROR: Exception | None = None
_TRIED = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_d = ctypes.POINTER(ctypes.c_double)
    c_i = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.epk_knn.restype = ctypes.c_int
    lib.epk_knn.argtypes = [c_d, i64, i64, c_i]
    lib.epk_fps.restype = ctypes.c_int
    lib.epk_fps.argtypes = [c_d, i64, i64, i64, c_i]
    lib.epk_local_triangulations_v2.restype = i64
    lib.epk_local_triangulations_v2.argtypes = [c_d, i64, i64, i64, i64, c_i]
    lib.epk_delaunay_flips.restype = i64
    lib.epk_delaunay_flips.argtypes = [c_d, i64, c_i, c_d, c_d, i64, i64]
    return lib


def load_native() -> ctypes.CDLL | None:
    """The loaded library, or None when it cannot be built or loaded (the
    first failure warns with the compiler's stderr). Cached."""
    global _LIB, _ERROR, _TRIED
    if not _TRIED:
        _TRIED = True
        from eigenpinns_torch.utils.cuda_build import load_host_library

        try:
            _LIB = _bind(load_host_library("geometry_kernels"))
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as e:
            _ERROR = e
            warnings.warn("the native geometry kernels are not available "
                          "(the numpy paths are used): "
                          f"{type(e).__name__}: {e}", stacklevel=2)
    return _LIB


def available() -> bool:
    return load_native() is not None


def require() -> ctypes.CDLL:
    """The library, or the reason it is missing as a RuntimeError."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native geometry kernels could not be built "
                           f"or loaded: {_ERROR}") from _ERROR
    return lib


def _points(points) -> np.ndarray:
    """`points` as the C-contiguous (n, 3) float64 array the kernels
    read."""
    pts = np.ascontiguousarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (n, 3), got {pts.shape}")
    return pts


def _ptr_d(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ptr_i(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def knn_native(points: np.ndarray, k: int) -> np.ndarray:
    """(n, k) nearest-neighbor indices (self excluded)."""
    lib = require()
    pts = _points(points)
    n = pts.shape[0]
    out = np.empty((n, k), dtype=np.int64)
    rc = lib.epk_knn(_ptr_d(pts), n, k, _ptr_i(out))
    if rc != 0:
        raise ValueError(f"epk_knn failed (rc={rc}); k >= n?")
    return out


def fps_native(points: np.ndarray, n_samples: int,
               start: int = 0) -> np.ndarray:
    """(n_samples,) farthest-point indices in selection order, from
    `start`."""
    lib = require()
    pts = _points(points)
    out = np.empty(n_samples, dtype=np.int64)
    rc = lib.epk_fps(_ptr_d(pts), pts.shape[0], n_samples, start,
                     _ptr_i(out))
    if rc != 0:
        raise ValueError(f"epk_fps failed (rc={rc})")
    return out


def local_triangulations_native(points: np.ndarray,
                                n_neighbors: int = 30,
                                frame_neighbors: int | None = None,
                                ) -> np.ndarray:
    """Raw one-ring triangle soup (T, 3), not deduplicated (callers dedup
    and count exactly as the numpy path does). `frame_neighbors` sizes the
    PCA tangent-frame neighborhood (None: the triangulation's)."""
    lib = require()
    pts = _points(points)
    n = pts.shape[0]
    kf = 0 if frame_neighbors is None else int(frame_neighbors)
    max_tris = 12 * n   # one-rings emit ~6 triangles a point
    out = np.empty((max_tris, 3), dtype=np.int64)
    cnt = lib.epk_local_triangulations_v2(
        _ptr_d(pts), n, n_neighbors, kf, max_tris, _ptr_i(out))
    if cnt == -2:       # the buffer was too small: once more at 4x
        max_tris *= 4
        out = np.empty((max_tris, 3), dtype=np.int64)
        cnt = lib.epk_local_triangulations_v2(
            _ptr_d(pts), n, n_neighbors, kf, max_tris, _ptr_i(out))
    if cnt < 0:
        raise ValueError(f"epk_local_triangulations failed ({cnt})")
    return out[:cnt]


def delaunay_flips_native(points: np.ndarray, tris: np.ndarray,
                          lengths: np.ndarray, weights: np.ndarray,
                          max_flips: int = -1) -> int:
    """In-place intrinsic-Delaunay flips of (tris, lengths, weights), the
    C++ port of `point_cloud.intrinsic_delaunay_flips` (the same pairing
    order). Returns the flip count."""
    lib = require()
    pts = _points(points)
    if not (tris.dtype == np.int64 and tris.flags.c_contiguous
            and lengths.dtype == np.float64 and lengths.flags.c_contiguous
            and weights.dtype == np.float64 and weights.flags.c_contiguous):
        raise ValueError("delaunay_flips_native needs C-contiguous int64 "
                         "tris and float64 lengths and weights")
    T = tris.shape[0]
    if (tris.shape != (T, 3) or lengths.shape != (T, 3)
            or weights.shape != (T,)
            or (T and (tris.min() < 0 or tris.max() >= pts.shape[0]))):
        raise ValueError("delaunay_flips_native needs (T, 3) tris indexing "
                         "the (n, 3) points, (T, 3) lengths and (T,) "
                         "weights")
    rc = lib.epk_delaunay_flips(_ptr_d(pts), pts.shape[0], _ptr_i(tris),
                                _ptr_d(lengths), _ptr_d(weights),
                                T, max_flips)
    if rc < 0:
        raise ValueError(f"epk_delaunay_flips failed (rc={rc})")
    return int(rc)
