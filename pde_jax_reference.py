#!/usr/bin/env python3
"""The JAX package's own figures at step 15 of `chip_smoke.py` (the PDE
apps), on the CPU.

    python3 pde_jax_reference.py [E1 E2 E3 S1 S2]   (all by default)

Runs the JAX package's heat geodesics, FEM eigensolve, `train_joint`,
`solve_eikonal` and `solve_schrodinger` with the smoke's settings
(`chip_smoke.E1_*` ... `S2_BOX`: E1 the coil example's widths on its
stand-in perturbed_icosphere(4), E2 and E3 the sphere tests' on
icosphere(3), S1 examples/schrodinger_well.py, S2 test_solve_well_2d),
prints each run's figures and wall time, and last the dict that is
`PDE_JAX` in `chip_smoke.py`.

With `solver_family_jax_reference.py` and `cli_jax_reference.py`, one of
the root scripts that run the JAX package; the port and `chip_smoke.py`
never import it.
"""

import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from eigenpinns_tpu.geometry import TriMesh, heat_geodesics  # noqa: E402
from eigenpinns_tpu.models import (  # noqa: E402
    dirichlet_window,
    gaussian_window,
)
from eigenpinns_tpu.operators import (  # noqa: E402
    eigen_positional_encoding,
    harmonic_oscillator,
    infinite_well,
    well_eigenvalues,
)
from eigenpinns_tpu.solvers import (  # noqa: E402
    solve_eikonal,
    solve_schrodinger,
    train_joint,
)
from eigenpinns_tpu.solvers.oracle import solve_eigenvalue_mesh  # noqa: E402
from eigenpinns_tpu.sparse import as_operator  # noqa: E402
from eigenpinns_torch.utils.fixtures import (  # noqa: E402
    icosphere,
    perturbed_icosphere,
)


def timed(label, fn, *args, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    print(f"[jax] {label}: {time.time() - t0:.1f} s", flush=True)
    return out


def eikonal_figures(out, tag, mesh, src, n_eigs, joint, eik, learned=True):
    """Exact (and learned) encodings -> solve_eikonal; corr and rms into
    `out`; returns the learned eigenvalues' rel errs at 1..4."""
    y = heat_geodesics(mesh, [src])
    lam, vecs, K, M = solve_eigenvalue_mesh(mesh, n_eigs)
    bases = {"exact": np.asarray(vecs)}
    rel = None
    if learned:
        r = timed(f"{tag} train_joint", train_joint, as_operator(K),
                  as_operator(M), mesh.verts, **joint)
        bases["learned"] = r.eigenvectors
        rel = np.abs(r.eigenvalues[1:5] - lam[1:5]) / np.abs(lam[1:5])
    for name, basis in bases.items():
        res = timed(f"{tag} eikonal, {name}", solve_eikonal, mesh,
                    eigen_positional_encoding(basis, n_eigs), y, **eik)
        out[f"{tag}_{name}_corr"] = float(np.corrcoef(res.u, y)[0, 1])
        out[f"{tag}_{name}_rms"] = float(res.residual_rms)
    return rel


def main() -> int:
    runs = sys.argv[1:] or ["E1", "E2", "E3", "S1", "S2"]
    sphere = icosphere(cs.PDE_SPHERE_SUB)
    sphere = TriMesh(sphere.verts, sphere.faces)
    coil = perturbed_icosphere(4)
    coil = TriMesh(coil.verts, coil.faces)
    src = int(np.argmax(sphere.verts[:, 2]))
    out = {}
    if "E1" in runs:
        rel = eikonal_figures(out, "E1", coil, 0, cs.E1_EIGS, cs.E1_JOINT,
                              cs.E1_EIK)
        out["E1_eig_rel"] = float(rel.max())
        out["E1_eig_rel_1_3"] = float(rel[:3].max())
    if "E2" in runs:
        eikonal_figures(out, "E2", sphere, src, cs.E2_EIGS, cs.E2_JOINT,
                        cs.E2_EIK)
    if "E3" in runs:
        eikonal_figures(out, "E3", sphere, src, cs.E3_EIGS, None, cs.E3_EIK,
                        learned=False)
        out["E3_corr"] = out.pop("E3_exact_corr")
        out.pop("E3_exact_rms")
    if "S1" in runs:
        res = timed("S1 well", solve_schrodinger, infinite_well(),
                    dirichlet_window(0.0, 1.0), (0.0, 1.0), **cs.S1_WELL)
        exact = np.asarray(well_eigenvalues(2), np.float64)
        for i, r in enumerate(np.abs(res.eigenvalues - exact) / exact):
            out[f"S1_well_rel{i}"] = float(r)
        res = timed("S1 oscillator", solve_schrodinger,
                    harmonic_oscillator(), gaussian_window(1.0), (-4.0, 4.0),
                    **cs.S1_OSC)
        out["S1_osc_err"] = abs(float(res.eigenvalues[0]) - 0.5)
    if "S2" in runs:
        res = timed("S2 2D well", solve_schrodinger, infinite_well(),
                    cs.box_window, [(0.0, 1.0), (0.0, 1.0)], **cs.S2_BOX)
        out["S2_rel"] = abs(float(res.eigenvalues[0]) - np.pi**2) / np.pi**2
    for key, value in out.items():
        print(f"[jax] {key} {value!r}", flush=True)
    print(f"PDE_JAX = {out!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
