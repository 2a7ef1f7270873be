"""Batched spectral bases for a family of shapes.

    python examples_torch/mesh_family.py
        [--mesh delta_pinns_validation/face.obj] [--platform cpu]

The port of examples/mesh_family.py. The full run takes face.obj plus
two quadric-decimated members (16k and 10k vertices), k = 20, one
stacked training program for all three, then a per-mesh LOBPCG polish.

Set EIGENPINNS_SMOKE=1 for a seconds-scale miniature (CI smoke mode:
four random sphere clouds).
"""
import common

import numpy as np

from eigenpinns_torch.solvers import eigsh_smallest, train_joint_family

args = common.parse(__doc__, mesh="delta_pinns_validation/face.obj")
if common.SMOKE:
    from eigenpinns_torch.geometry import point_cloud_laplacian

    K_list, M_list, X_list = [], [], []
    for f in range(4):
        r = np.random.default_rng(f)
        X = r.normal(size=(150, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        X *= 1.0 + 0.15 * f
        L, M = point_cloud_laplacian(X, n_neighbors=12)
        K_list.append(L)
        M_list.append(M)
        X_list.append(X)
    res = train_joint_family(K_list, M_list, X_list, n_modes=4,
                             epochs=100, polish_iters=50,
                             device=args.device)
    k_report = 2
else:
    from eigenpinns_torch.geometry import assemble_stiffness_mass
    from eigenpinns_torch.sampling.decimation import decimate

    face = common.load_or_standin(args.mesh)
    sizes = ([16000, 10000] if face.n_verts > 16000
             else [face.n_verts * 2 // 3, face.n_verts // 2])
    family = [face] + [decimate(face, s) for s in sizes]
    print("family:", [m.n_verts for m in family], "verts")
    K_list, M_list, X_list = [], [], []
    for m in family:
        K, M = assemble_stiffness_mass(m, lumped=True)
        K_list.append(K.tocsr())
        M_list.append(M.tocsr())
        X_list.append(np.asarray(m.verts, np.float32))
    res = train_joint_family(K_list, M_list, X_list, n_modes=20,
                             hidden=(256, 256, 256, 256), epochs=4000,
                             w_res=1.0, w_orth=10.0, w_trace=0.5,
                             polish_iters=400, device=args.device)
    k_report = 19

for f in range(len(K_list)):
    vals = eigsh_smallest(K_list[f], M_list[f], k_report + 1)[0]
    lam = np.sort(res.eigenvalues[f])[: k_report + 1]
    rel = np.abs(lam[1:] - vals[1:]) / np.abs(vals[1:])
    print(f"mesh {f} ({K_list[f].shape[0]}v): "
          f"max rel err modes 1..{k_report} = {rel.max():.2e}")
