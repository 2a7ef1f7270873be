"""Host-side classical eigensolver oracle (scipy/ARPACK).

The coarsest-level exact solve of the hierarchy build and the accuracy
oracle of the tests and `chip_smoke.py`. A copy of `eigsh_smallest` from
`eigenpinns_tpu/solvers/oracle.py`.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse.linalg import eigsh


def eigsh_smallest(K, M, k: int, sigma: float = -0.01, seed: int = 0):
    """Smallest-k generalized eigenpairs via shift-invert ARPACK.

    Functionally `eigsh(K, k, M, which='SM')` (src/utils.py:175) but in
    shift-invert mode. The Lanczos start vector ``v0`` is seeded so runs
    are reproducible.
    """
    v0 = np.random.default_rng(seed).standard_normal(K.shape[0])
    vals, vecs = eigsh(K, k=k, M=M, sigma=sigma, which="LM", v0=v0)
    order = np.argsort(vals)
    return vals[order], vecs[:, order]
