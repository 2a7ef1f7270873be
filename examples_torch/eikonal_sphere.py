"""Delta-PINN: geodesic distance from Laplace-Beltrami eigen-encodings.

    python examples_torch/eikonal_sphere.py [--platform cpu]

The port of examples/eikonal_sphere.py: the eikonal PINN runs twice,
once on exact eigenfunction encodings, once on encodings learned by the
joint eigen-PINN, and the two are compared (Laplace-PINN-coil.ipynb cells
20-30).

Set EIGENPINNS_SMOKE=1 to run a seconds-scale miniature (CI smoke mode).
"""
import common

import numpy as np

from eigenpinns_torch.geometry import heat_geodesics
from eigenpinns_torch.operators import eigen_positional_encoding
from eigenpinns_torch.solvers import solve_eikonal, train_joint
from eigenpinns_torch.solvers.oracle import solve_eigenvalue_mesh
from eigenpinns_torch.sparse import as_operator
from eigenpinns_torch.utils.fixtures import icosphere

SMOKE = common.SMOKE
args = common.parse(__doc__)
n_eigs = 6 if SMOKE else 10
mesh = icosphere(2 if SMOKE else 3)
src = int(np.argmax(mesh.verts[:, 2]))
y = heat_geodesics(mesh, [src])
_, vecs, K, M = solve_eigenvalue_mesh(mesh, n_eigs)

# Learn the basis with the joint eigen-PINN (subspace-polished, not
# solver-polished: the encodings stay a PINN product).
learned = train_joint(as_operator(K, device=args.device),
                      as_operator(M, device=args.device), mesh.verts,
                      n_modes=n_eigs, hidden=(64, 64, 64),
                      epochs=300 if SMOKE else 6000,
                      w_res=1.0, w_orth=10.0, seed=0)

for name, basis in [("exact  ", np.asarray(vecs)),
                    ("learned", learned.eigenvectors)]:
    res = solve_eikonal(mesh, eigen_positional_encoding(basis, n_eigs), y,
                        epochs=200 if SMOKE else 8000, device=args.device)
    print(f"{name} encodings: corr with heat-method ground truth:",
          np.corrcoef(res.u, y)[0, 1].round(4),
          "| eikonal residual rms:", round(res.residual_rms, 3))
