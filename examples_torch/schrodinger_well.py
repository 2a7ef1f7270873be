"""Infinite well + harmonic oscillator with the parametric ansatz.

    python examples_torch/schrodinger_well.py [--platform cpu]

The port of examples/schrodinger_well.py. Set EIGENPINNS_SMOKE=1 to run
a seconds-scale miniature (CI smoke mode).
"""
import common

import numpy as np

from eigenpinns_torch.models import dirichlet_window, gaussian_window
from eigenpinns_torch.operators import (
    harmonic_oscillator,
    infinite_well,
    well_eigenvalues,
)
from eigenpinns_torch.solvers import solve_schrodinger

SMOKE = common.SMOKE
args = common.parse(__doc__)
res = solve_schrodinger(infinite_well(), dirichlet_window(0.0, 1.0),
                        (0.0, 1.0), n_modes=1 if SMOKE else 2,
                        epochs_per_mode=150 if SMOKE else 6000,
                        lambda_init=3.0, lambda_growth=2.5, seed=1,
                        device=args.device)
print("well:      ", np.round(res.eigenvalues, 4), " exact:",
      np.round(np.asarray(well_eigenvalues(len(res.eigenvalues))), 4))

res = solve_schrodinger(harmonic_oscillator(), gaussian_window(1.0),
                        (-4.0, 4.0), n_modes=1,
                        epochs_per_mode=150 if SMOKE else 3000,
                        lambda_init=0.4, device=args.device)
print("oscillator:", np.round(res.eigenvalues, 4), " exact: [0.5]")
