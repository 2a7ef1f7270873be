"""Multiresolution hierarchy builder (port of
`eigenpinns_tpu/sampling/hierarchy.py`).

Given a mesh and target level sizes, build per-level point sets X, the
point-cloud operators (K, M), kNN edge lists, prolongations P and
Jacobi-smoothed initial eigenvector guesses U. The host stage (FPS, the
point-cloud Laplacian, kNN, RCM, eigsh) is numpy/scipy; the device tail
(operator layouts, Jacobi smoothing) runs on `device`.

Ported: the `farthest_point` sampler with kNN edges, the host eigsh
coarse solve, and operator formats 'ell' and 'auto'/'banded' with the
JAX package's format choice: the rolling band at k <= 32, strip-BSR at
k > 32 or where the RCM band is wider than `max_bandwidth` (with the
same warnings).

`Hierarchy.save` writes the JAX package's on-disk layout byte for byte
(scipy CSR per sparse operator plus one dense npz), and `Hierarchy.load`
reads either package's files, so both can train on identical inputs.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from eigenpinns_torch.geometry.mesh import TriMesh
from eigenpinns_torch.geometry.point_cloud import point_cloud_laplacian
from eigenpinns_torch.sampling.knn import knn_graph, prolongation_matrix
from eigenpinns_torch.sampling.samplers import farthest_point_levels
from eigenpinns_torch.solvers.oracle import eigsh_smallest
from eigenpinns_torch.solvers.smoothers import jacobi_smooth
from eigenpinns_torch.sparse.bsr import BSRTile
from eigenpinns_torch.sparse.formats import Diagonal, as_operator
from eigenpinns_torch.sparse.rolling import RollingBanded

OPERATOR_FORMATS = ("ell", "banded", "auto")


def _banded_op(A, dtype, device, max_bandwidth, prefer_rolling, warning):
    """Device operator of an already RCM-ordered matrix: the rolling band
    when `prefer_rolling` and it fits `max_bandwidth`, strip-BSR (no cap)
    otherwise. `warning` (None: silent) is issued when the band does not
    fit."""
    if prefer_rolling:
        try:
            return RollingBanded.from_scipy(A, dtype=dtype, device=device,
                                            reorder=False,
                                            max_bandwidth=max_bandwidth)[0]
        except ValueError:
            if warning is not None:
                warnings.warn(warning, stacklevel=3)
    return BSRTile.from_scipy(A, dtype=dtype, device=device,
                              reorder=False)[0]


@dataclasses.dataclass
class Hierarchy:
    """Preprocessed multiresolution problem, on one device."""

    X_list: list[np.ndarray]          # per-level coordinates (host f64)
    K_ops: list[Any]                  # per-level stiffness (device)
    M_ops: list[Any]                  # per-level mass (device)
    K_scipy: list[Any]                # host-side canonical operators
    M_scipy: list[Any]
    P_ops: list[Any]                  # prolongations level l-1 -> l
    Pt_ops: list[Any]                 # their transposes
    U_list: list[torch.Tensor]        # initial eigvec guesses (f32)
    edge_index_list: list[np.ndarray]
    actual_hierarchy: list[int]
    meshes: list[TriMesh]
    indices_per_level: list[np.ndarray]
    coarse_eigenvalues: np.ndarray
    perms: list[np.ndarray] | None = None   # per-level RCM permutations
    build_max_bandwidth: int = 4096
    device: torch.device = torch.device("cpu")

    def fused_level_ops(self, dtype=torch.float32,
                        max_bandwidth: int | None = None):
        """Block-diagonal (K, M) operators over the concatenated level
        node axis: one SpMM for all levels in the multigrid loss, forward
        and backward. Cached per (dtype, max_bandwidth)."""
        if max_bandwidth is None:
            max_bandwidth = self.build_max_bandwidth
        key = (str(dtype), int(max_bandwidth))
        cache = self.__dict__.setdefault("_fused_ops", {})
        if key in cache:
            return cache[key]
        K_blk = sp.block_diag([K.tocsr() for K in self.K_scipy],
                              format="csr")
        banded = isinstance(self.K_ops[-1], (RollingBanded, BSRTile))

        def _op(A):
            # The finest level's format; block boundaries only widen the
            # rolling window by < one tile, and a band past max_bandwidth
            # falls back to strip-BSR, as in the JAX package.
            if banded:
                return _banded_op(
                    A, dtype, self.device, max_bandwidth,
                    isinstance(self.K_ops[-1], RollingBanded), None)
            return as_operator(A, dtype=dtype, device=self.device)

        K_op = _op(K_blk)
        if all(isinstance(op, Diagonal) for op in self.M_ops):
            M_op = Diagonal(torch.cat([op.diag for op in self.M_ops])
                            .to(dtype))
        else:
            M_op = _op(sp.block_diag([M.tocsr() for M in self.M_scipy],
                                     format="csr"))
        cache[key] = (K_op, M_op)
        return cache[key]

    @property
    def n_levels(self) -> int:
        return len(self.X_list)

    @property
    def node_offsets(self) -> list[int]:
        """Offsets of the levels in the concatenated node axis."""
        sizes = [x.shape[0] for x in self.X_list]
        return [0] + [int(v) for v in np.cumsum(sizes[:-1])]

    def save(self, directory: str) -> None:
        """Persist in the JAX package's layout (`Hierarchy.save`)."""
        os.makedirs(directory, exist_ok=True)
        dense = {
            "actual_hierarchy": np.asarray(self.actual_hierarchy),
            "coarse_eigenvalues": self.coarse_eigenvalues,
            "n_levels": np.asarray(self.n_levels),
            "has_perms": np.asarray(self.perms is not None),
        }
        for i in range(self.n_levels):
            dense[f"X_{i}"] = np.asarray(self.X_list[i])
            dense[f"U_{i}"] = self.U_list[i].detach().cpu().numpy()
            dense[f"edges_{i}"] = np.asarray(self.edge_index_list[i])
            if self.perms is not None:
                dense[f"perm_{i}"] = np.asarray(self.perms[i])
            if i < len(self.indices_per_level):
                dense[f"indices_{i}"] = np.asarray(
                    self.indices_per_level[i])
            sp.save_npz(os.path.join(directory, f"K_{i}.npz"),
                        self.K_scipy[i].tocsr())
            sp.save_npz(os.path.join(directory, f"M_{i}.npz"),
                        self.M_scipy[i].tocsr())
        for i, P in enumerate(self.P_ops):
            sp.save_npz(os.path.join(directory, f"P_{i}.npz"),
                        P.to_scipy().tocsr())
        mesh = self.meshes[-1]
        dense["mesh_verts"] = mesh.verts
        dense["mesh_faces"] = mesh.faces
        np.savez_compressed(os.path.join(directory, "hierarchy.npz"),
                            **dense)

    @classmethod
    def load(cls, directory: str, dtype=torch.float32, device="cuda",
             operator_format: str = "ell",
             max_bandwidth: int = 4096) -> "Hierarchy":
        """Rebuild a Hierarchy from `save` output (either package's),
        re-canonicalizing the operators to the requested format."""
        if operator_format not in OPERATOR_FORMATS:
            raise ValueError(f"operator_format must be one of "
                             f"{OPERATOR_FORMATS}")
        device = torch.device(device)
        dense = np.load(os.path.join(directory, "hierarchy.npz"))
        n_levels = int(dense["n_levels"])
        has_perms = bool(dense["has_perms"])
        K_sp = [sp.load_npz(os.path.join(directory, f"K_{i}.npz"))
                for i in range(n_levels)]
        M_sp = [sp.load_npz(os.path.join(directory, f"M_{i}.npz"))
                for i in range(n_levels)]
        U_list = [torch.as_tensor(dense[f"U_{i}"], dtype=dtype,
                                  device=device) for i in range(n_levels)]
        if operator_format in ("banded", "auto") and has_perms:
            # Saved operators are already RCM-permuted; the same per-k
            # format choice as build_hierarchy (k = saved guess width).
            prefer_rolling = U_list[0].shape[1] <= 32
            K_ops = [_banded_op(
                K, dtype, device, max_bandwidth, prefer_rolling,
                f"load: level {i} RCM bandwidth exceeds max_bandwidth="
                f"{max_bandwidth}; using the strip-BSR format instead of "
                "the rolling band (different HBM/perf profile)")
                for i, K in enumerate(K_sp)]
        else:
            K_ops = [as_operator(K, dtype=dtype, device=device)
                     for K in K_sp]
        M_ops = [as_operator(M, dtype=dtype, device=device) for M in M_sp]
        P_ops, Pt_ops = [], []
        for i in range(n_levels - 1):
            P = sp.load_npz(os.path.join(directory, f"P_{i}.npz")).tocsr()
            P_ops.append(as_operator(P, dtype=dtype, device=device))
            Pt_ops.append(as_operator(P.T.tocsr(), dtype=dtype,
                                      device=device))
        return cls(
            X_list=[dense[f"X_{i}"] for i in range(n_levels)],
            K_ops=K_ops, M_ops=M_ops, K_scipy=K_sp, M_scipy=M_sp,
            P_ops=P_ops, Pt_ops=Pt_ops, U_list=U_list,
            edge_index_list=[dense[f"edges_{i}"] for i in range(n_levels)],
            actual_hierarchy=[int(v) for v in dense["actual_hierarchy"]],
            meshes=[TriMesh(dense["mesh_verts"], dense["mesh_faces"])],
            indices_per_level=[dense[f"indices_{i}"]
                               for i in range(n_levels)
                               if f"indices_{i}" in dense],
            coarse_eigenvalues=dense["coarse_eigenvalues"],
            perms=([dense[f"perm_{i}"] for i in range(n_levels)]
                   if has_perms else None),
            build_max_bandwidth=max_bandwidth,
            device=device,
        )


@torch.no_grad()
def build_hierarchy(
    mesh: TriMesh,
    hierarchy: list[int],
    n_modes: int,
    sampler_type: str = "farthest_point",
    k_neighbors: int = 21,
    prolongation_neighbors: int = 21,
    pc_neighbors: int = 30,
    jacobi_alpha: float = 0.1,
    jacobi_iters: int = 10,
    seed: int = 0,
    dtype=torch.float32,
    operator_format: str = "ell",   # 'ell' | 'banded' | 'auto'
    max_bandwidth: int = 4096,
    device="cuda",
) -> Hierarchy:
    """Build the full multiresolution problem on `device`
    (Sampler.preprocess_mesh parity, src/samplers.py:283-286)."""
    if sampler_type != "farthest_point":
        raise NotImplementedError(
            f"sampler_type '{sampler_type}': only 'farthest_point' is "
            "ported")
    if operator_format not in OPERATOR_FORMATS:
        raise ValueError(f"operator_format must be one of "
                         f"{OPERATOR_FORMATS}")
    device = torch.device(device)

    indices = farthest_point_levels(mesh.verts, hierarchy, seed=seed)
    X_list, K_sp, M_sp = [], [], []
    for idx in indices:
        X = mesh.verts[idx]
        L, M = point_cloud_laplacian(X, n_neighbors=pc_neighbors)
        X_list.append(X)
        K_sp.append(L)
        M_sp.append(M)
    actual = [x.shape[0] for x in X_list]

    # Per-level RCM order and the JAX package's format choice: the
    # rolling band for narrow mode counts (k <= 32), strip-BSR for wide k
    # or where the band blows past max_bandwidth. Every per-level array
    # is permuted consistently and `perms` maps back.
    perms = None
    K_ops: list = []
    if operator_format in ("banded", "auto"):
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        prefer_rolling = n_modes <= 32
        if operator_format == "banded" and not prefer_rolling:
            warnings.warn(
                f"operator_format='banded' with n_modes={n_modes} > 32: "
                "building strip-BSR operators (the rolling band is only "
                "used for k <= 32); pass operator_format='auto' to "
                "acknowledge the per-k format choice", stacklevel=2)
        perms = []
        for i in range(len(K_sp)):
            perm = np.asarray(reverse_cuthill_mckee(K_sp[i].tocsr(),
                                                    symmetric_mode=True))
            K_sp[i] = K_sp[i].tocsr()[perm][:, perm].tocsr()
            M_sp[i] = M_sp[i].tocsr()[perm][:, perm].tocsr()
            X_list[i] = X_list[i][perm]
            indices[i] = np.asarray(indices[i])[perm]
            K_ops.append(_banded_op(
                K_sp[i], dtype, device, max_bandwidth, prefer_rolling,
                f"level {i}: RCM bandwidth exceeds max_bandwidth="
                f"{max_bandwidth}; using the strip-BSR format instead of "
                "the rolling band"))
            perms.append(perm)

    edge_index_list = [knn_graph(X, k=k_neighbors) for X in X_list]

    if K_ops:
        M_ops = []
        for i, M in enumerate(M_sp):
            op = as_operator(M, dtype=dtype, device=device)
            if not isinstance(op, Diagonal):
                # Consistent (non-lumped) mass: same format and the same
                # (already applied) permutation as that level's K.
                op = _banded_op(M.tocsr(), dtype, device, max_bandwidth,
                                isinstance(K_ops[i], RollingBanded), None)
            M_ops.append(op)
    else:
        K_ops = [as_operator(K, dtype=dtype, device=device) for K in K_sp]
        M_ops = [as_operator(M, dtype=dtype, device=device) for M in M_sp]

    vals0, U0 = eigsh_smallest(K_sp[0], M_sp[0], n_modes)  # coarsest level

    # Prolongations + smoothed initial guesses (src/samplers.py:264-281).
    P_ops, Pt_ops = [], []
    U_list = [torch.as_tensor(U0, dtype=dtype, device=device)]
    U_prev = U0
    for level in range(1, len(X_list)):
        P = prolongation_matrix(X_list[level - 1], X_list[level],
                                k=prolongation_neighbors).tocsr()
        P_ops.append(as_operator(P, dtype=dtype, device=device))
        Pt_ops.append(as_operator(P.T.tocsr(), dtype=dtype, device=device))
        U_init = torch.as_tensor(P @ U_prev, dtype=dtype, device=device)
        U_init = jacobi_smooth(M_ops[level], K_ops[level], U_init,
                               alpha=jacobi_alpha, n_iters=jacobi_iters)
        U_list.append(U_init)
        U_prev = U_init.double().cpu().numpy()

    return Hierarchy(
        X_list=X_list, K_ops=K_ops, M_ops=M_ops, K_scipy=K_sp, M_scipy=M_sp,
        P_ops=P_ops, Pt_ops=Pt_ops, U_list=U_list,
        edge_index_list=edge_index_list, actual_hierarchy=actual,
        meshes=[mesh], indices_per_level=list(indices),
        coarse_eigenvalues=np.asarray(vals0), perms=perms,
        build_max_bandwidth=max_bandwidth, device=device,
    )
