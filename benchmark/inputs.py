"""The cells' inputs, made with numpy and scipy alone, and their cache.

A configuration names its surface, `surfaces/<surface>.py`, whose
`make(cfg)` returns the points X, the stiffness K (float64 scipy CSR)
and the lumped mass m, from the configuration's keys that its `KEYS`
lists. The port and the plain reference receive the same X, K and m.

`load` keeps them in `build/bench_inputs/` of the checkout, keyed by
those keys and the bytes of this file and of the surface's, so that only
a checkout's first run of a configuration makes them; `Inputs.cached`
keeps what the reference derives from them once (the lowest
eigenvalues) beside them.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os

import numpy as np
import scipy.sparse as sp

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def cotangent_operators(X: np.ndarray, tris: np.ndarray):
    """(K, m): the cotangent stiffness matrix (CSR, symmetric, rows summing
    to 0) and the lumped mass (a third of each incident triangle's area a
    vertex) of the triangle mesh (X, tris)."""
    n = X.shape[0]
    P = [X[tris[:, c]] for c in range(3)]
    twice_area = np.linalg.norm(np.cross(P[1] - P[0], P[2] - P[0]), axis=1)
    rows, cols, vals = [], [], []
    for c in range(3):
        a, b = (c + 1) % 3, (c + 2) % 3
        u, v = P[a] - P[c], P[b] - P[c]
        cot = (u * v).sum(1) / twice_area      # the angle at corner c
        rows += [tris[:, a], tris[:, b]]
        cols += [tris[:, b], tris[:, a]]
        vals += [0.5 * cot, 0.5 * cot]
    W = sp.coo_matrix((-np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    W.sum_duplicates()
    K = (W - sp.diags(np.asarray(W.sum(axis=1)).ravel())).tocsr()
    K.sort_indices()
    m = np.bincount(tris.ravel(), weights=np.repeat(twice_area / 6.0, 3),
                    minlength=n)
    return K, m


def surface_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "surfaces", f"{name}.py")


def load_surface(name: str, bench_dir: str = BENCH_DIR):
    """The module `surfaces/<name>.py`."""
    spec = importlib.util.spec_from_file_location(
        "surface_" + name.replace(".", "_").replace("-", "_"),
        surface_path(name, bench_dir))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def file_hash(*paths: str) -> str:
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


class Inputs:
    """A configuration's X, K and m, and the cache they came from
    (`cache_dir` None: nothing is cached)."""

    def __init__(self, X, K, m, cache_dir: str | None = None,
                 key: str = ""):
        self.X, self.K, self.m = X, K, m
        self.cache_dir, self.key = cache_dir, key

    def cached(self, name: str, make, *files: str) -> dict:
        """`make()` (a dict of arrays), read from the cache when an earlier
        run wrote it there for these inputs and these `files`' bytes,
        else made and written."""
        if self.cache_dir is None:
            return make()
        path = os.path.join(self.cache_dir,
                            f"{self.key}-{name}-{file_hash(*files)}.npz")
        return cached_arrays(path, make)


def cached_arrays(path: str, make) -> dict:
    """The arrays of `path`, or `make()`'s, written there (to a temporary
    name first, so that no run reads a half-written file)."""
    if os.path.exists(path):
        with np.load(path) as f:
            return {key: f[key] for key in f.files}
    out = make()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out


def load(cfg: dict, cache_dir: str | None,
         bench_dir: str = BENCH_DIR) -> Inputs:
    """The inputs of the configuration `cfg` (its surface's `make(cfg)`),
    from `cache_dir` when an earlier run made them there."""
    name = cfg["surface"]
    surface = load_surface(name, bench_dir)
    key = "-".join([name, *(str(cfg[k]) for k in surface.KEYS),
                    file_hash(__file__, surface_path(name, bench_dir))])

    def make() -> dict:
        X, K, m = surface.make(cfg)
        return {"X": X, "m": m, "data": K.data, "indices": K.indices,
                "indptr": K.indptr}

    f = make() if cache_dir is None else cached_arrays(
        os.path.join(cache_dir, f"{key}.npz"), make)
    n = f["X"].shape[0]
    K = sp.csr_matrix((f["data"], f["indices"], f["indptr"]), shape=(n, n))
    return Inputs(f["X"], K, f["m"], cache_dir, key)
