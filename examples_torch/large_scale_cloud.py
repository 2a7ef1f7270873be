"""300k-point cloud, 20 modes, multigrid training on the card.

    python examples_torch/large_scale_cloud.py [--platform cpu]

The port of examples/large_scale_cloud.py. Set EIGENPINNS_SMOKE=1 to run
a seconds-scale miniature (CI smoke mode).

    EIGENPINNS_1M=1 python examples_torch/large_scale_cloud.py

also runs the 1M-vertex, 50-mode spectral basis (`spectral_basis`: the
native point-cloud Laplacian, a 65k voxel-coarse eigsh warm start with
kNN prolongation, the cluster-ordered split operator, blocked deflated
LOBPCG).
"""
import os

import common

import numpy as np

from eigenpinns_torch.configs import Config
from eigenpinns_torch.geometry import TriMesh
from eigenpinns_torch.sampling import build_hierarchy
from eigenpinns_torch.solvers.multigrid import MultigridTrainer
from eigenpinns_torch.solvers.oracle import eigsh_smallest

SMOKE = common.SMOKE
args = common.parse(__doc__)
rng = np.random.default_rng(0)
n = 3_000 if SMOKE else 300_000
theta = rng.uniform(0, 2 * np.pi, n)
phi = np.arccos(rng.uniform(-1, 1, n))
r = 1.0 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi)
X = r[:, None] * np.stack([np.sin(phi) * np.cos(theta),
                           np.sin(phi) * np.sin(theta), np.cos(phi)], 1)
mesh = TriMesh(X, np.zeros((1, 3), np.int32))

levels = [256, 1024] if SMOKE else [1024, 16384, 65536]
h = build_hierarchy(mesh, levels, n_modes=20,
                    pc_neighbors=15, prolongation_neighbors=8,
                    k_neighbors=8, operator_format="auto",
                    device=args.device)
cfg = Config(n_modes=20, hierarchy=levels,
             loss_mxu_precision="bf16",
             hidden_layers=[64] * 2 if SMOKE else [256] * 4,
             epochs=20 if SMOKE else 400,
             scan_chunk=10 if SMOKE else 100,
             # the miniature cuts the ramp by its epochs' share (F25)
             corrector_scale=1.0, scale_ramp_epochs=10 if SMOKE else 200,
             plateau_patience=10**9,
             polish_iters=10 if SMOKE else 100)
res = MultigridTrainer(cfg).train(h)
vals, _ = eigsh_smallest(h.K_scipy[-1], h.M_scipy[-1], 20)
rel = np.abs(res.eigenvalues[1:] - vals[1:]) / np.abs(vals[1:])
print("max rel err vs eigsh:", float(rel.max()))

if bool(int(os.environ.get("EIGENPINNS_1M", "0"))):
    from eigenpinns_torch.solvers import spectral_basis

    n1 = 30_000 if SMOKE else 1_000_000
    theta = rng.uniform(0, 2 * np.pi, n1)
    phi = np.arccos(rng.uniform(-1, 1, n1))
    r1 = 1.0 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi)
    X1 = r1[:, None] * np.stack([np.sin(phi) * np.cos(theta),
                                 np.sin(phi) * np.sin(theta),
                                 np.cos(phi)], 1)
    res1 = spectral_basis(X1, k=10 if SMOKE else 50,
                          coarse_n=2048 if SMOKE else 65536,
                          operator_format="split", device=args.device)
    print("1M timings:", res1.timings)
    print("lam[:8]:", np.round(res1.eigenvalues[:8], 5))
