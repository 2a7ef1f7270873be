"""Delta-PINN eikonal on the reference's coil geometry.

    python examples_torch/eikonal_coil.py
        [--mesh delta_pinns_validation/data/coil_1.2_MM.obj] [--platform cpu]

The port of examples/eikonal_coil.py, the hard case of
Laplace-PINN-coil.ipynb: a long wound coil whose geodesic distances
cannot be read off ambient positions; only the Laplace-Beltrami
eigen-encodings separate adjacent windings. End to end:

  * FEM eigenfunctions of the mesh (the notebook's cell 3);
  * geodesic ground truth from vertex 0 (the heat method, cell 9);
  * the eikonal PINN run twice: on the exact encodings, then on the
    encodings learned by the whitened joint eigen-PINN.

Set EIGENPINNS_SMOKE=1 for a seconds-scale miniature.
"""
import common

import numpy as np

from eigenpinns_torch.geometry import heat_geodesics
from eigenpinns_torch.operators import eigen_positional_encoding
from eigenpinns_torch.solvers import solve_eikonal, train_joint
from eigenpinns_torch.solvers.oracle import solve_eigenvalue_mesh
from eigenpinns_torch.sparse import as_operator

SMOKE = common.SMOKE
args = common.parse(__doc__,
                    mesh="delta_pinns_validation/data/coil_1.2_MM.obj")
n_eigs = 8 if SMOKE else 20
mesh = common.load_or_standin(args.mesh, normalize=False)
y = heat_geodesics(mesh, [0])
print(f"mesh: {mesh.n_verts} verts, geodesic range {y.max():.1f}")
_, vecs, K, M = solve_eigenvalue_mesh(mesh, n_eigs)

learned = train_joint(as_operator(K, device=args.device),
                      as_operator(M, device=args.device), mesh.verts,
                      n_modes=n_eigs, hidden=(64, 64, 64),
                      mode="whiten", w_trace=1.0,
                      epochs=500 if SMOKE else 20000, seed=0)

for name, basis in [("exact  ", np.asarray(vecs)),
                    ("learned", learned.eigenvectors)]:
    res = solve_eikonal(mesh, eigen_positional_encoding(basis, n_eigs),
                        y, n_data=50, hidden=(100,),
                        epochs=200 if SMOKE else 8000,
                        element_batch=512, seed=0, device=args.device)
    print(f"{name} encodings: corr", np.corrcoef(res.u, y)[0, 1].round(4),
          "| eikonal residual rms:", round(res.residual_rms, 3))
