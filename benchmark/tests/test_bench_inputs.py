"""The cells' input generator: the bench cloud, its hull triangulation,
the cotangent stiffness and the lumped mass; the cache; the reference's
lowest eigenvalues."""

import os

import numpy as np
import pytest
import scipy.linalg

import inputs
import reference

star = inputs.load_surface("star_cloud")


def make_inputs(n, seed):
    return star.make({"n_points": n, "cloud_seed": seed})


@pytest.mark.parametrize("n", [500, 4000])
def test_operator_shape_and_invariants(n):
    X, K, m = make_inputs(n, 2**31 + 5)
    assert X.shape == (n, 3) and K.shape == (n, n)
    assert abs(K - K.T).max() == 0.0                       # symmetric
    assert np.abs(np.asarray(K.sum(axis=1))).max() < 1e-10  # rows sum to 0
    # A closed triangulated sphere: E = 3n - 6 edges, so 7n - 12 nonzeros.
    assert K.nnz == 7 * n - 12
    assert (m > 0).all() and (K.diagonal() > 0).all()
    # The lumped masses add up to the surface's area, close to its
    # points' hull's (the surface is star-shaped about the origin).
    assert 14.0 < m.sum() < 18.0


def test_seeded():
    a = make_inputs(800, 7)
    b = make_inputs(800, 7)
    c = make_inputs(800, 8)
    assert np.array_equal(a[0], b[0]) and (a[1] != b[1]).nnz == 0
    assert not np.array_equal(a[0], c[0])


def test_cloud_is_the_bench_cloud():
    X = star.make_cloud(1000, 0)
    r = np.linalg.norm(X, axis=1)
    theta = np.arctan2(X[:, 1], X[:, 0])
    phi = np.arccos(X[:, 2] / r)
    assert np.allclose(r, 1 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi))


def test_cotangent_weights_by_hand():
    # One right isosceles triangle's corner angles are 90, 45, 45 degrees:
    # the legs' edges get cot(45) / 2 = 1/2, the hypotenuse cot(90) / 2 = 0.
    X = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    K, m = inputs.cotangent_operators(X, np.array([[0, 1, 2]]))
    assert np.allclose(K.toarray(), [[1, -0.5, -0.5], [-0.5, 0.5, 0],
                                     [-0.5, 0, 0.5]])
    assert np.allclose(m, 1 / 6)


def test_hull_rejects_a_repeated_direction():
    X = star.make_cloud(200, 1)
    X[1] = 2 * X[0]
    with pytest.raises(ValueError):
        star.triangulate(X)


def test_load_caches_by_name_and_keys(tmp_path):
    cfg = {"surface": "star_cloud", "n_points": 600, "cloud_seed": 4}
    a = inputs.load(cfg, str(tmp_path))
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("star_cloud-600-4-")
    b = inputs.load({**cfg, "train": {"epochs": 1}}, str(tmp_path))
    assert os.listdir(tmp_path) == files      # read back, not made again
    X, K, m = make_inputs(600, 4)
    for got in (a, b):
        assert np.array_equal(got.X, X) and np.array_equal(got.m, m)
        assert (got.K != K).nnz == 0
    calls = []

    def make():
        calls.append(1)
        return {"lam": np.arange(3.0)}

    for _ in range(2):
        assert np.array_equal(a.cached("lowest3", make, reference.__file__)
                              ["lam"], np.arange(3.0))
    assert calls == [1] and len(os.listdir(tmp_path)) == 2


def test_lowest_eigenvalues_match_a_dense_solve():
    X, K, m = make_inputs(400, 9)
    want = scipy.linalg.eigh(K.toarray(), np.diag(m), eigvals_only=True)[:6]
    got = reference.lowest_eigenvalues(K, m, 6)
    assert np.allclose(got, want, rtol=1e-9, atol=1e-9)
    assert reference.eigenvalue_gap(got[::-1], want) < 1e-9
    assert reference.eigenvalue_gap(got[1:], want) == float("inf")
    shifted = np.concatenate([got[1:], [got[-1] + 1]])
    assert reference.eigenvalue_gap(shifted, want) > 0.1
